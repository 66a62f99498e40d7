"""`JegalEngine.gestsync_features_from_raw_many([(planar, None), ...],
batch_size)`: the batched GestSync tower on planar frames, what
`extract-feats` runs (eager: the tower makes no graph)."""

from __future__ import annotations


def call(engine, mix: dict, clips: list) -> list:
    out = engine.gestsync_features_from_raw_many(
        [(c["frames"], None) for c in clips], batch_size=mix["batch_size"])
    return [None if f is None else {"features": f} for f in out]


def chunks(mix: dict, metas: list) -> list:
    """The tower's chunks: clips grouped by T bucket, each group in slices
    of batch_size padded to the power-of-two ladder."""
    from jegal_torch.data.bucketing import T_BUCKETS, batch_ladder, next_bucket

    groups: dict = {}
    for m in metas:
        t = next_bucket(m["t"], T_BUCKETS)
        groups[t] = groups.get(t, 0) + 1
    bs = mix["batch_size"]
    return [{"b": batch_ladder(min(bs, n - lo), bs), "t": t}
            for t, n in groups.items() for lo in range(0, n, bs)]
