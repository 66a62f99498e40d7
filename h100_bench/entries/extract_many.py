"""`JegalEngine.extract_many(samples, modalities, batch_size)`: the
fused batched path (planar frames -> tower -> JEGAL, per chunk one CUDA
graph replay), what `extract-embs --batch_size` runs."""

from __future__ import annotations

import time

KEYS = ("frames", "text", "wav", "word_boundaries", "fname")


def call(engine, mix: dict, clips: list) -> list:
    out = engine.extract_many([{k: c[k] for k in KEYS} for c in clips],
                              modalities=mix["modalities"],
                              batch_size=mix["batch_size"])
    return [None if r is None else {"gesture_emb": r["gesture_emb"],
                                    "content_emb": r["content_emb"]}
            for r in out]


def chunks(mix: dict, metas: list) -> list:
    """extract_many's chunks: clips grouped by their (T, S, W, mel)
    buckets in order of first appearance, each group in slices of
    batch_size padded to the power-of-two ladder."""
    from jegal_torch.data.bucketing import (
        MEL_BUCKETS,
        S_BUCKETS,
        T_BUCKETS,
        W_BUCKETS,
        batch_ladder,
        next_bucket,
    )

    groups: dict = {}
    for m in metas:
        key = (next_bucket(m["t"], T_BUCKETS),
               next_bucket(m["tokens"], S_BUCKETS),
               next_bucket(max(m["words"], 1), W_BUCKETS),
               next_bucket(m["mel"], MEL_BUCKETS))
        groups[key] = groups.get(key, 0) + 1
    bs = mix["batch_size"]
    return [{"b": batch_ladder(min(bs, n - lo), bs), "t": t, "s": s, "w": w,
             "mel": mel}
            for (t, s, w, mel), n in groups.items()
            for lo in range(0, n, bs)]


def warm(engine, mix: dict, metas: list) -> list:
    """Capture the graph of each distinct chunk of a call ahead of the
    traffic (`JegalEngine.warmup` at the chunk's buckets and padded batch,
    planar frames) -> [(chunk, seconds its capture took)]."""
    out = []
    for c in {tuple(sorted(c.items())): c
              for c in chunks(mix, metas) if c["b"] > 1}.values():
        t0 = time.perf_counter()
        engine.warmup(mix["modalities"], t=c["t"], s=c["s"], w=c["w"],
                      mel=c["mel"], batch=c["b"], frames_kind="planar")
        out.append((c, time.perf_counter() - t0))
    return out
