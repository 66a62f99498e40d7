"""The engine's spans (jegal_torch/api.py through utils/profiling.annotate)
on the CPU. Under torch.profiler a tiny engine's `extract_many` (the fused
path on planar frames and the two-stage path on visual features) and
`gestsync_features_from_raw_many` open exactly the documented spans on the
calling thread: one call span holding the leaves `jt.prep`, `jt.stage`,
`jt.launch` and `jt.settle`, which never nest or overlap, a stage, a
launch and a settle a chunk; `jt.capture` inside a stage for a graph's
first call and never for a warm one. `trace` (`--profile_dir`) records the
prep workers' `jt.prep.text` / `jt.prep.audio`. With no profiler running,
`annotate` hands out one shared null context.

GestSync at its real widths on 6-frame planar clips (T bucket 32), with a
tiny XLM-R (1 layer, d 768, 8 heads) and the tiny BPE of tests/tok_util.py."""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jegal_torch import api as TAPI
from jegal_torch.convert import (
    gestsync_params_from_jax,
    init_gestsync_params,
    init_jegal_params,
    init_roberta_params,
    jegal_params_from_jax,
    roberta_params_from_jax,
)
from jegal_torch.models.roberta import RobertaConfig
from jegal_torch.ops.video import s2d_repack
from jegal_torch.text.tokenizer import WordTokenizer
from jegal_torch.utils import profiling as P
from tok_util import make_tiny_tokenizer
from torch_threads import few_torch_threads  # noqa: F401

TINY_XLMR = dict(vocab_size=64, hidden_size=768, num_layers=1, num_heads=8,
                 intermediate_size=256, max_position_embeddings=64)
CALLS = ("jt.extract_many", "jt.tower_many")
LEAVES = ("jt.prep", "jt.stage", "jt.launch", "jt.settle")
T = 6


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def engine():
    gen = torch.Generator()
    eng = TAPI.JegalEngine(
        jegal_params_from_jax(_numpy(init_jegal_params(gen.manual_seed(71)))),
        gestsync_params_from_jax(
            _numpy(init_gestsync_params(gen.manual_seed(72)))),
        device="cpu", roberta_params=roberta_params_from_jax(_numpy(
            init_roberta_params(gen.manual_seed(73),
                                RobertaConfig(**TINY_XLMR)))),
        roberta_cfg=RobertaConfig(**TINY_XLMR),
        tokenizer=WordTokenizer(make_tiny_tokenizer()))
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def samples():
    """Three planar clips and one sample's text, audio and words."""
    rng = np.random.default_rng(74)
    content = dict(wav=(rng.standard_normal(T * 640) * 1000)
                   .astype(np.float32),
                   word_boundaries=[["a", 0, 1], ["b", 2, 4], ["c", 5, 5]],
                   text="hello world abc")
    clips = []
    for _ in range(3):
        frames = rng.integers(0, 256, (T, 270, 480, 3), dtype=np.uint8)
        chin = rng.integers(90, 200, T).astype(np.int32)
        clips.append(s2d_repack(frames, chin))
    return clips, content


def _spans(fn):
    """Run fn under torch.profiler (CPU activity) -> (its result, the `jt.`
    spans recorded as (name, start us, end us, thread) in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end, e.thread)
                    for e in prof.events() if e.name.startswith("jt.")),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _check_layout(spans, call: str, chunks: int) -> None:
    """One call span on one thread; the leaves disjoint in it, a stage, a
    launch and a settle a chunk; every other span inside a leaf."""
    calls = [s for s in spans if s[0] in CALLS]
    assert [s[0] for s in calls] == [call]
    assert {s[3] for s in spans} == {calls[0][3]}
    leaves = [s for s in spans if s[0] in LEAVES]
    assert all(_inside(s, calls[0]) for s in leaves)
    assert all(a[2] <= b[1] for a, b in zip(leaves, leaves[1:]))
    names = [s[0] for s in leaves]
    assert [names.count(n) for n in LEAVES[1:]] == [chunks] * 3
    parents = {"jt.capture": "jt.stage", "jt.stage.wait": "jt.stage",
               "jt.prep.text": "jt.prep", "jt.prep.audio": "jt.prep"}
    for s in spans:
        if s[0] in parents:
            assert any(p[0] == parents[s[0]] and _inside(s, p)
                       for p in leaves), s


def test_fused_extract_many_spans(engine, samples):
    """Fused vta on three planar clips at batch 2 (chunks 2 and 1, prep
    inline): the first call captures its two graphs, a warm call none."""
    clips, content = samples
    batch = [dict(frames=c, fname=f"c{i}", **content)
             for i, c in enumerate(clips)]
    call = lambda: engine.extract_many(batch, "vta", batch_size=2)  # noqa
    first, spans = _spans(call)
    assert all(r is not None for r in first)
    _check_layout(spans, "jt.extract_many", chunks=2)
    assert {s[0] for s in spans} == {
        "jt.extract_many", "jt.prep", "jt.prep.text", "jt.prep.audio",
        "jt.stage", "jt.capture", "jt.launch", "jt.settle"}
    assert [s[0] for s in spans].count("jt.capture") == 2
    warm, spans = _spans(call)
    _check_layout(spans, "jt.extract_many", chunks=2)
    assert "jt.capture" not in {s[0] for s in spans}
    # a warm call: the call, its prep with each sample's text and audio,
    # and three leaves a chunk
    assert len(spans) == 2 + 2 * len(batch) + 3 * 2
    for a, b in zip(first, warm):
        np.testing.assert_array_equal(a["gesture_emb"], b["gesture_emb"])


def test_two_stage_extract_many_spans(engine, samples):
    """Two-stage vta on five feature samples at batch 4 (chunks 4 and 1):
    the prep runs on the pool, whose spans the calling thread's profiler
    does not hold."""
    _, content = samples
    rng = np.random.default_rng(75)
    batch = [dict(visual_feats=rng.standard_normal((20, 1024))
                  .astype(np.float32), fname=f"f{i}", **content)
             for i in range(5)]
    call = lambda: engine.extract_many(batch, "vta", batch_size=4)  # noqa
    _, spans = _spans(call)
    _check_layout(spans, "jt.extract_many", chunks=2)
    assert {s[0] for s in spans} == {"jt.extract_many", "jt.prep", "jt.stage",
                                     "jt.capture", "jt.launch", "jt.settle"}
    # warm, in the depth-1 pipeline's order: chunk 2 is staged and
    # launched before chunk 1 settles
    _, spans = _spans(call)
    assert [s[0] for s in spans] == [
        "jt.extract_many", "jt.prep", "jt.stage", "jt.launch", "jt.stage",
        "jt.launch", "jt.settle", "jt.settle"]


def test_tower_many_spans(engine, samples):
    """The eager tower on three planar clips at batch 2: no prep, no
    capture, a stage, a launch and a settle a chunk."""
    clips, _ = samples
    _, spans = _spans(lambda: engine.gestsync_features_from_raw_many(
        [(c, None) for c in clips], batch_size=2))
    _check_layout(spans, "jt.tower_many", chunks=2)
    assert {s[0] for s in spans} == {"jt.tower_many", "jt.stage",
                                     "jt.launch", "jt.settle"}
    assert len(spans) == 1 + 3 * 2


def test_trace_records_the_prep_workers(engine, samples, tmp_path):
    """`trace` records every thread where torch can: the prep pool's
    text and audio spans land on its worker threads."""
    if P._all_threads() is None:
        pytest.skip("this torch cannot record every thread")
    _, content = samples
    rng = np.random.default_rng(76)
    batch = [dict(visual_feats=rng.standard_normal((20, 1024))
                  .astype(np.float32), **content) for _ in range(5)]
    with P.trace(str(tmp_path)):
        engine.extract_many(batch, "vta", batch_size=4)
    trace, = tmp_path.iterdir()
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if str(e.get("name", "")).startswith("jt.")]
    call, = [e for e in events if e["name"] == "jt.extract_many"]
    for name in ("jt.prep.text", "jt.prep.audio"):
        tids = [e["tid"] for e in events if e["name"] == name]
        assert len(tids) == len(batch)
        assert call["tid"] not in tids


def test_annotate_off_is_one_shared_null_context():
    """No profiler: the same null context for every name; a profiler: a
    span that it records."""
    assert P.annotate("jt.stage") is P.annotate("jt.settle")
    assert isinstance(P.annotate("jt.stage"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.annotate("jt.stage"):
            pass
    assert [e.name for e in prof.events()] == ["jt.stage"]
