"""The engine's spans (jegal_torch/api.py through utils/profiling.annotate)
on the CPU. Under torch.profiler a tiny engine's `extract_many` (the fused
path on planar frames and the two-stage path on visual features) and
`gestsync_features_from_raw_many` open exactly the documented spans on the
calling thread: one call span holding the leaves `jt.prep`, `jt.stage`,
`jt.launch` and `jt.settle`, which never nest or overlap, a stage, a
launch and a settle a chunk; `jt.capture` inside a stage for a graph's
first call and never for a warm one. `extract_many`'s `jt.prep` is its
plan of every sample, then before each chunk's stage the wait for that
chunk's log-mels, which the prep pool makes meanwhile: slowed, the waits
hold the time the log-mels keep the chunks back, and a log-mel that
fails raises with its chunk named and leaves nothing running. `trace`
(`--profile_dir`) records the prep workers' `jt.prep.text` /
`jt.prep.audio`. With no profiler running, `annotate` hands out one
shared null context.

GestSync at its real widths on 6-frame planar clips (T bucket 32), with a
tiny XLM-R (1 layer, d 768, 8 heads) and the tiny BPE of tests/tok_util.py."""

import contextlib
import json
import threading
import time

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
    if call == "jt.extract_many":
        # the plan's prep, then a wait for its log-mels before each stage
        assert names[0] == "jt.prep" and names.count("jt.prep") == chunks + 1
        assert all(names[k - 1] == "jt.prep"
                   for k, n in enumerate(names) if n == "jt.stage")
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
    # a warm call: the call, its plan's prep with each sample's text, and
    # four leaves a chunk: the wait for its log-mels (inline here, each
    # sample's audio inside it), stage, launch, settle
    assert len(spans) == 2 + 2 * len(batch) + 4 * 2
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
    # launched before chunk 1 settles, each stage after its chunk's wait
    _, spans = _spans(call)
    assert [s[0] for s in spans] == [
        "jt.extract_many", "jt.prep", "jt.prep", "jt.stage", "jt.launch",
        "jt.prep", "jt.stage", "jt.launch", "jt.settle", "jt.settle"]


def _feature_batch(content, n: int):
    """n two-stage `vta` samples of one shape, f0..f{n-1}; sample i's wav
    starts with i, so a log-mel can tell whose it is."""
    rng = np.random.default_rng(77)
    batch = []
    for i in range(n):
        wav = content["wav"].copy()
        wav[0] = i
        batch.append(dict(content, wav=wav, fname=f"f{i}",
                          visual_feats=rng.standard_normal((20, 1024))
                          .astype(np.float32)))
    return batch


def _slowed_log_mel(monkeypatch, delay, fail=None):
    """Sample i's log-mel sleeps delay(i) s first; sample `fail`'s raises a
    RuntimeError. -> counts of log-mels started and running, the threads
    they ran on, and every future the prep pool was handed."""
    log_mel = TAPI.wav2filterbanks_np
    lock = threading.Lock()
    seen = {"started": 0, "running": 0, "threads": set(), "futures": []}

    def slow(wav, *a, **kw):
        with lock:
            seen["started"] += 1
            seen["running"] += 1
            seen["threads"].add(threading.current_thread().name)
        try:
            time.sleep(delay(int(wav[0])))
            if int(wav[0]) == fail:
                raise RuntimeError("log-mel failed")
            return log_mel(wav, *a, **kw)
        finally:
            with lock:
                seen["running"] -= 1

    monkeypatch.setattr(TAPI, "wav2filterbanks_np", slow)
    pool_for = TAPI.JegalEngine._prep_pool_for

    def spied_pool(self, n):
        pool = pool_for(self, n)
        if pool is None:
            return None
        submit = pool.submit

        class Spy:
            def submit(self, *a, **kw):
                seen["futures"].append(submit(*a, **kw))
                return seen["futures"][-1]

            def __getattr__(self, name):
                return getattr(pool, name)

        return Spy()

    monkeypatch.setattr(TAPI.JegalEngine, "_prep_pool_for", spied_pool)
    return seen


def test_log_mel_waits_are_prep_spans(engine, samples, monkeypatch):
    """Six feature samples at batch 2 (three chunks), each log-mel slowed
    to 0.4 s on the 4-thread pool: chunks 1 and 2 wait about one log-mel
    each (chunk 3's start when the first four end), and every wait is a
    `jt.prep` right before its chunk's `jt.stage`, so the calling thread's
    leaves cover the call with no gap of that size."""
    delay = 0.4
    batch = _feature_batch(samples[1], 6)
    call = lambda: engine.extract_many(batch, "vta", batch_size=2)  # noqa
    want = call()
    seen = _slowed_log_mel(monkeypatch, lambda i: delay)
    got, spans = _spans(call)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["content_emb"], b["content_emb"])
    assert seen["started"] == 6 and seen["running"] == 0
    assert all(n.startswith("jegal-prep") for n in seen["threads"])
    _check_layout(spans, "jt.extract_many", chunks=3)
    leaves = [s for s in spans if s[0] in LEAVES]
    waits = [s for s in leaves if s[0] == "jt.prep"][1:]
    us = 1e6 * delay
    assert waits[0][2] - waits[0][1] >= 0.8 * us
    # from the plan's end to the last stage: the last log-mels end at
    # about 2 * delay, and only leaves fill the time before
    start, end = leaves[0][2], [s for s in leaves if s[0] == "jt.stage"][-1][1]
    assert end - start >= 1.6 * us
    covered = sum(s[2] - s[1] for s in leaves if start <= s[1] < end)
    assert end - start - covered < 0.25 * us


def test_failed_log_mel_names_its_chunk_and_leaves_nothing_running(
        engine, samples, monkeypatch):
    """A log-mel that raises (sample f2, in the second chunk) surfaces from
    extract_many with that chunk's samples named; when the call returns
    every log-mel handed to the pool is done and none runs, and none
    starts later. The first chunk's log-mels and f2's end at once, the
    others take 2 s, so the error is seen while the pool's 4 threads are
    still on f3-f6: f7-f11 are cancelled, never started."""
    seen = _slowed_log_mel(monkeypatch, lambda i: 0.0 if i < 3 else 2.0,
                           fail=2)
    batch = _feature_batch(samples[1], 12)
    with pytest.raises(RuntimeError, match="log-mel failed") as info:
        engine.extract_many(batch, "vta", batch_size=2)
    assert any("['f2', 'f3']" in n for n in info.value.__notes__)
    assert seen["running"] == 0
    assert len(seen["futures"]) == len(batch)
    assert all(f.done() for f in seen["futures"])
    assert [f.cancelled() for f in seen["futures"]] == [False] * 7 + [True] * 5
    started = seen["started"]
    time.sleep(0.5)
    assert seen["started"] == started == 7 and seen["running"] == 0


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
