"""The engine's host frame fill (`JegalEngine._fill_frames`) on the CPU.

The staging pool writes a batch of frames in equal runs of frame slots,
one a worker. Every element of the batch (and of the chin rows `cut`) is
written exactly as the one-thread loop the fill replaced, which is copied
below as the reference: each clip's frames, its last frame and chin row
repeated to the bucket, zeros and the fallback row past the clips. Also
checked: the worker count against the cores and the ranks, a single 5 s
clip at its real size, the pool's lifetime and its spans."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from jegal_torch import api as TAPI
from jegal_torch.ops.video import FALLBACK_ROWS
from jegal_torch.utils import profiling as P
from jegal_torch.utils.profiling import annotate

T_BUCKET = 8
# (kind, rows b, clip lengths): clips shorter than and at the bucket, rows
# past the clips, and no clip at all (warmup's fill)
CASES = [
    ("planar", 1, [5]),
    ("planar", 1, [8]),
    ("planar", 4, [8, 3, 1]),
    ("planar", 16, [2, 8, 5, 7, 1, 8, 3, 6, 4, 8, 2]),
    ("planar", 4, []),
    ("raw", 1, [6]),
    ("raw", 4, [8, 2, 5, 8]),
    ("raw", 16, [3, 8, 1, 7, 8, 2, 5]),
]


def reference_fill(fr, cut, clips) -> None:
    """The one-thread fill: `_fill_frames` and `_fill_cut` as they were
    before the fill was split."""
    for bi, (frames, _) in enumerate(clips):
        if isinstance(frames, torch.Tensor):
            frames = frames.cpu()
        frames = np.asarray(frames)
        t = frames.shape[0]
        fr[bi, :t] = frames
        fr[bi, t:] = frames[-1]
    fr[len(clips):] = 0
    if cut is not None:
        for bi, (frames, chin) in enumerate(clips):
            t = frames.shape[0]
            cr = (np.full((t,), FALLBACK_ROWS, np.int64) if chin is None
                  else np.asarray(chin).astype(np.int64))
            cut[bi, :t] = cr
            cut[bi, t:] = cr[-1]
        cut[len(clips):] = FALLBACK_ROWS


@pytest.fixture
def engine():
    eng = TAPI.JegalEngine(None, device="cpu")
    yield eng
    eng.close()


def _clips(kind, lengths, seed):
    """Clips of random frames; raw ones with chin rows, but every third
    without (the fallback row), and the second a CPU tensor."""
    rng = np.random.default_rng(seed)
    clips = []
    for i, t in enumerate(lengths):
        frames = rng.integers(0, 256, (t,) + TAPI.FRAME_SHAPES[kind],
                              dtype=np.uint8)
        if i == 1:
            frames = torch.from_numpy(frames)
        chin = None
        if kind == "raw" and i % 3:
            chin = rng.integers(90, 200, t).astype(np.int32)
        clips.append((frames, chin))
    return clips


def _buffers(kind, b, seed):
    """The batch and chin rows to fill, holding garbage (a graph's buffers
    are reused), and a copy of each for the reference."""
    rng = np.random.default_rng(seed)
    fr = rng.integers(0, 256, (b, T_BUCKET) + TAPI.FRAME_SHAPES[kind],
                      dtype=np.uint8)
    cut = (None if kind == "planar"
           else rng.integers(-5, 500, (b, T_BUCKET)).astype(np.int64))
    return fr, cut, fr.copy(), None if cut is None else cut.copy()


@pytest.mark.parametrize("workers", [1, 3, 4])
@pytest.mark.parametrize("kind,b,lengths", CASES,
                         ids=[f"{k}-b{b}-n{len(n)}" for k, b, n in CASES])
def test_fill_equals_the_one_thread_fill(engine, monkeypatch, kind, b,
                                         lengths, workers):
    """The fill over `workers` threads writes the reference's bytes into
    buffers that held garbage."""
    monkeypatch.setattr(TAPI, "STAGE_WORKERS", workers)
    clips = _clips(kind, lengths, seed=b * 100 + len(lengths))
    fr, cut, ref_fr, ref_cut = _buffers(kind, b, seed=b + len(lengths))
    reference_fill(ref_fr, ref_cut, clips)
    engine._fill_frames(fr, cut, clips)
    np.testing.assert_array_equal(fr, ref_fr)
    if cut is not None:
        np.testing.assert_array_equal(cut, ref_cut)


@pytest.mark.parametrize("cores,ranks,want", [
    (8, 1, 4), (32, 4, 4), (8, 2, 4), (8, 4, 2), (3, 1, 3), (2, 4, 1)])
def test_workers_share_the_cores_among_ranks(monkeypatch, cores, ranks,
                                              want):
    """STAGE_WORKERS threads a fill, fewer where the process's cores
    divided among the process group's ranks are fewer, and at least 1."""
    monkeypatch.setattr(TAPI.os, "sched_getaffinity",
                        lambda pid: set(range(cores)))
    monkeypatch.setattr(TAPI.M, "world_size", lambda: ranks)
    assert TAPI._stage_workers() == want


def test_a_single_5s_clip_at_its_real_size(engine, monkeypatch):
    """`extract`'s single-clip graph: a 5 s clip in bucket 128 (49.8 MB)
    is written in STAGE_WORKERS runs on `jegal-stage` threads, its last
    frame repeated to the bucket."""
    seen = []
    fill = TAPI._fill_slots

    def spy(fr, clips, lo, hi):
        seen.append((threading.current_thread().name, lo, hi))
        fill(fr, clips, lo, hi)

    monkeypatch.setattr(TAPI, "_fill_slots", spy)
    monkeypatch.setattr(TAPI, "_stage_workers", lambda: 4)
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (125,) + TAPI.PLANAR_FRAME, np.uint8)
    fr = np.full((1, 128) + TAPI.PLANAR_FRAME, 7, np.uint8)
    engine._fill_frames(fr, None, [(frames, None)])
    assert fr.nbytes == 49_766_400
    assert sorted(lo for _, lo, _ in seen) == [0, 32, 64, 96]
    assert all(name.startswith("jegal-stage") for name, _, _ in seen)
    np.testing.assert_array_equal(fr[0, :125], frames)
    np.testing.assert_array_equal(fr[0, 125:], frames[[-1, -1, -1]])


def test_close_shuts_the_staging_pool(engine):
    """The pool is made once, at the first fill, with STAGE_WORKERS
    `jegal-stage` threads at most; close() shuts it, and a later fill
    makes a new one."""
    clips = _clips("planar", [4], seed=2)
    fr = np.empty((1, T_BUCKET) + TAPI.PLANAR_FRAME, np.uint8)
    assert engine._stage_pool is None
    engine._fill_frames(fr, None, clips)
    pool = engine._stage_pool
    engine._fill_frames(fr, None, clips)
    assert engine._stage_pool is pool
    assert pool._thread_name_prefix == "jegal-stage"
    assert pool._max_workers == TAPI.STAGE_WORKERS
    engine.close()
    assert engine._stage_pool is None and pool._shutdown
    engine._fill_frames(fr, None, clips)
    assert engine._stage_pool not in (None, pool)


def test_fill_spans_on_the_workers(engine, monkeypatch, tmp_path):
    """Each worker's run opens `jt.stage.fill` on its own thread, inside
    the calling thread's `jt.stage` in time; the calling thread opens
    none."""
    if P._all_threads() is None:
        pytest.skip("this torch cannot record every thread")
    monkeypatch.setattr(TAPI, "_stage_workers", lambda: 3)
    clips = _clips("planar", [5, 8], seed=3)
    fr = np.empty((2, T_BUCKET) + TAPI.PLANAR_FRAME, np.uint8)
    with P.trace(str(tmp_path)):
        with annotate("jt.stage"):
            engine._fill_frames(fr, None, clips)
    trace, = tmp_path.iterdir()
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if str(e.get("name", "")).startswith("jt.")]
    stage, = [e for e in events if e["name"] == "jt.stage"]
    fills = [e for e in events if e["name"] == "jt.stage.fill"]
    assert len(fills) == 3
    assert stage["tid"] not in {e["tid"] for e in fills}
    for e in fills:
        assert stage["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= stage["ts"] + stage["dur"]


def test_fill_under_thread_switches(engine, monkeypatch):
    """More workers than the host has cores, and a thread switch every
    microsecond: five fills of a 16-row batch all write the reference's
    bytes (a lost or overlapping run would show)."""
    monkeypatch.setattr(TAPI, "STAGE_WORKERS", 32)
    monkeypatch.setattr(TAPI, "_stage_workers", lambda: 32)
    clips = _clips("raw", [3, 8, 1, 7, 8, 2, 5], seed=4)
    fr, cut, ref_fr, ref_cut = _buffers("raw", 16, seed=5)
    reference_fill(ref_fr, ref_cut, clips)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            fr[...] = 7
            engine._fill_frames(fr, cut, clips)
            assert np.array_equal(fr, ref_fr)
            assert np.array_equal(cut, ref_cut)
    finally:
        sys.setswitchinterval(before)
