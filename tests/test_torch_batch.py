"""The port's engine on planar frames and in batches, on the CPU, against
the JAX engine: `extract` on planar frames (host-repacked by
jegal_torch.ops.video.s2d_repack) against the port on the raw frames and
the JAX engine on the raw frames; `extract_many` over mixed samples (raw
frames, planar frames, visual features only, a malformed sample) against
the port's single-sample `extract` and the JAX engine's `extract_many` on
the raw equivalents; the batch ladder; the pipeline's order, error notes
and pool; frames written by the staging pool against the JAX engine; the
tower's front doors.

One 8-frame clip at the real 270x480 geometry (T bucket 32) serves every
tower run, with a tiny XLM-R (1 layer, d 768, 8 heads) and the tiny BPE
tokenizer of tests/tok_util.py. The JAX engine's planar path is no oracle
off the TPU (it interprets the stem at full size); the repack is an exact
permutation plus mask, so the JAX raw path on the same frames and chin rows
serves instead.

Tolerance: rtol = atol = 2e-5 on unit-norm embeddings, the JAX suite's
path-equality bar (a conv tower and three transformer stacks summed in
another order by oneDNN and XLA:CPU)."""

import threading

import numpy as np
import pytest
import torch

import jax

from jegal_tpu import api as JAPI
from jegal_tpu.models import roberta as JR
from jegal_tpu.text.tokenizer import WordTokenizer as JaxWordTokenizer
from jegal_torch import api as TAPI
from jegal_torch.convert import (
    gestsync_params_from_jax,
    init_gestsync_params,
    init_jegal_params,
    init_roberta_params,
    jegal_params_from_jax,
    roberta_params_from_jax,
)
from jegal_torch.data.bucketing import batch_ladder
from jegal_torch.models.roberta import RobertaConfig
from jegal_torch.ops.video import s2d_repack
from jegal_torch.text.tokenizer import WordTokenizer
from tok_util import make_tiny_tokenizer
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
T = 8
TINY_XLMR = dict(vocab_size=64, hidden_size=768, num_layers=1, num_heads=8,
                 intermediate_size=256, max_position_embeddings=64)
VF_LENGTHS = (20, 40, 50, 60)        # T buckets 32, 64, 64, 64


def _as_numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def weights():
    """JAX-layout numpy trees: JEGAL, GestSync (randomized BatchNorm
    statistics and LayerNorm parameters) and the tiny XLM-R."""
    return (_as_numpy(init_jegal_params(torch.Generator().manual_seed(51))),
            _as_numpy(init_gestsync_params(torch.Generator().manual_seed(52))),
            _as_numpy(init_roberta_params(torch.Generator().manual_seed(53),
                                          RobertaConfig(**TINY_XLMR))))


@pytest.fixture(scope="module")
def content():
    rng = np.random.default_rng(54)
    return dict(wav=(rng.standard_normal(T * 640) * 1000).astype(np.float32),
                word_boundaries=[["a", 0, 1], ["b", 2, 4], ["c", 5, 7]],
                text="hello world abc")


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(55)
    frames = rng.integers(0, 256, (T, 270, 480, 3), dtype=np.uint8)
    chin = rng.integers(90, 200, T).astype(np.int32)
    return frames, chin, s2d_repack(frames, chin)


@pytest.fixture(scope="module")
def jax_engine(weights):
    jp, gp, rp = weights
    return JAPI.JegalEngine(
        jegal_params=jp, gestsync_params=gp, roberta_params=rp,
        roberta_cfg=JR.RobertaConfig(**TINY_XLMR),
        tokenizer=JaxWordTokenizer(make_tiny_tokenizer()))


def _port_engine(weights, **kw):
    jp, gp, rp = weights
    return TAPI.JegalEngine(jegal_params_from_jax(jp),
                            gestsync_params_from_jax(gp), device="cpu",
                            roberta_params=roberta_params_from_jax(rp),
                            roberta_cfg=RobertaConfig(**TINY_XLMR),
                            tokenizer=WordTokenizer(make_tiny_tokenizer()),
                            **kw)


@pytest.fixture(scope="module")
def port_engine(weights):
    engine = _port_engine(weights)
    yield engine
    engine.close()


@pytest.fixture(scope="module")
def single(port_engine, clip, content):
    """The port's single-clip `vta` on the raw and the planar frames."""
    frames, chin, planar = clip
    return {"raw": port_engine.extract("vta", frames=frames, chin_rows=chin,
                                       fname="clip", **content),
            "planar": port_engine.extract("vta", frames=planar, fname="clip",
                                          **content)}


@pytest.fixture(scope="module")
def jax_single(jax_engine, clip, content):
    frames, chin, _ = clip
    return jax_engine.extract("vta", frames=frames, chin_rows=chin,
                              fname="clip", **content)


def _same(got, want):
    for key in ("gesture_emb", "content_emb"):
        if want[key] is None:
            assert got[key] is None
            continue
        assert got[key].shape == want[key].shape
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], **TOL)
    assert got["info"] == want["info"]


@pytest.mark.parametrize("kind", ["raw", "planar"])
def test_planar_extract_matches_raw_and_jax(single, jax_single, kind):
    assert single[kind]["gesture_emb"].shape == (T, 512)
    assert single[kind]["content_emb"].shape == (3, 512)
    _same(single[kind], jax_single)
    _same(single["planar"], single["raw"])


@pytest.mark.parametrize("frames,chin,match", [
    ("planar", "chin", "already masked"),
    (np.zeros((4, 90, 27, 161), np.uint8), None, "frames must be"),
    (np.zeros((4, 90, 27, 160), np.float32), None, "uint8"),
    (np.zeros((0, 90, 27, 160), np.uint8), None, "frames must be"),
])
def test_planar_client_errors(port_engine, clip, content, frames, chin,
                              match):
    if isinstance(frames, str):
        frames, chin = clip[2], clip[1]
    with pytest.raises(TAPI.ClientError, match=match):
        port_engine.extract("vta", frames=frames, chin_rows=chin, **content)


@pytest.fixture(scope="module")
def samples(clip, content):
    """Mixed samples, in an order that interleaves their groups: visual
    features of T = 20 (bucket 32) and T = 40, 50, 60 (bucket 64: a chunk
    of 2 and a straggler of 1 at batch_size 2), the clip's raw and planar
    frames, and a malformed planar sample. -> (the port's samples, the JAX
    engine's, with the planar sample as its raw frames)."""
    frames, chin, planar = clip
    rng = np.random.default_rng(56)
    vf = {n: dict(content, visual_feats=rng.standard_normal(
        (n, 1024)).astype(np.float32), fname=f"vf{n}") for n in VF_LENGTHS}
    raw = dict(content, frames=frames, chin_rows=chin, fname="raw")
    port = [vf[20], raw, vf[40], dict(content, fname="bad",
                                      frames=np.zeros((4, 90, 27, 161),
                                                      np.uint8)),
            dict(content, frames=planar, fname="planar"), vf[50], vf[60]]
    jax_side = list(port)
    jax_side[4] = dict(raw, fname="planar")
    return port, jax_side


@pytest.fixture(scope="module")
def many(port_engine, jax_engine, samples):
    port, jax_side = samples
    return (port_engine.extract_many(port, "vta", batch_size=2),
            jax_engine.extract_many(jax_side, "vta", batch_size=2))


@pytest.mark.parametrize("i", range(7))
def test_extract_many_matches_single_and_jax(port_engine, single, samples,
                                             many, i):
    s = samples[0][i]
    got, jax_got = many[0][i], many[1][i]
    assert got is not None or s["fname"] == "bad"
    if got is None:
        assert jax_got is None
        return
    assert got["info"]["fname"] == s["fname"]
    if s["fname"] in ("raw", "planar"):
        want = dict(single[s["fname"]],
                    info=dict(single[s["fname"]]["info"], fname=s["fname"]))
    else:
        want = port_engine.extract("vta", **s)
    _same(got, want)
    _same(got, jax_got)


def test_extract_many_straggler_padding_is_neutral(port_engine, samples):
    """Three samples at batch_size 4 run as one chunk padded to the ladder's
    4 (one zero row); padding rows are neutral, so the rows match
    unpadded chunks of one."""
    vf = [s for s in samples[0] if s["fname"] in ("vf40", "vf50", "vf60")]
    a = port_engine.extract_many(vf, "vta", batch_size=4)
    b = port_engine.extract_many(vf, "vta", batch_size=1)
    for x, y in zip(a, b):
        _same(x, y)


@pytest.mark.parametrize("cap", [1, 4, 16])
def test_batch_ladder_matches_jax(cap):
    for n in range(1, 41):
        assert batch_ladder(n, cap) == JAPI._batch_ladder(n, cap)


def test_pipeline_dispatches_ahead_of_settle():
    """Chunk k+1 is dispatched before chunk k is settled; the last chunk
    is settled too."""
    log = []

    def dispatches():
        for k in range(3):
            log.append(f"d{k}")
            yield [k], k

    TAPI.JegalEngine._pipeline(dispatches(),
                               lambda chunk, k: log.append(f"s{k}"))
    assert log == ["d0", "d1", "s0", "d2", "s1", "s2"]


def test_settle_error_names_its_chunk(port_engine, samples, monkeypatch):
    def fail(fetch):
        raise RuntimeError("fetch failed")

    monkeypatch.setattr(port_engine, "_finish_fetch", fail)
    vf = [s for s in samples[0] if s["fname"] in ("vf40", "vf50")]
    with pytest.raises(RuntimeError, match="fetch failed") as info:
        port_engine.extract_many(vf, "vta", batch_size=2)
    assert any("['vf40', 'vf50']" in n for n in info.value.__notes__)


def test_close_shuts_the_prep_pool(weights, samples):
    """More than 4 samples share one prep pool; close() shuts it, and a
    later call starts a new one."""
    engine = _port_engine(weights)
    vf = [s for s in samples[0] if "visual_feats" in s] * 2
    engine.extract_many(vf, "v")
    pool = engine._prep_pool
    assert pool is not None
    engine.close()
    assert engine._prep_pool is None and pool._shutdown
    assert all(r is not None for r in engine.extract_many(vf, "v"))
    engine.close()


def test_tower_front_doors_agree(port_engine, clip):
    """gestsync_features on raw frames with chin rows, on planar frames,
    and the batched gestsync_features_from_raw_many on both, give one
    clip's (T, 1024) features."""
    frames, chin, planar = clip
    want = port_engine.gestsync_features(frames, chin)
    assert want.shape == (T, 1024)
    np.testing.assert_allclose(port_engine.gestsync_features(planar), want,
                               **TOL)
    for batch in ([(frames, chin)], [(planar, None)]):
        got, = port_engine.gestsync_features_from_raw_many(batch)
        np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(TAPI.ClientError, match="already masked"):
        port_engine.gestsync_features(planar, chin)
    with pytest.raises(TAPI.ClientError, match="all raw or all planar"):
        port_engine.gestsync_features_from_raw_many([(frames, chin),
                                                     (planar, None)])


def test_frames_staged_on_the_pool_match_jax(port_engine, jax_engine, clip,
                                             content, monkeypatch):
    """extract_many's fused path and the batched tower write their host
    frames through the staging pool, in several runs on `jegal-stage`
    threads, and give the JAX engine's answers on the same raw frames."""
    names = []
    fill = TAPI._fill_slots

    def spy(fr, clips, lo, hi):
        names.append(threading.current_thread().name)
        fill(fr, clips, lo, hi)

    monkeypatch.setattr(TAPI, "_fill_slots", spy)
    frames, chin, _ = clip
    sample = [dict(content, frames=frames, chin_rows=chin, fname="raw")]
    got, = port_engine.extract_many(sample, "vta", batch_size=2)
    want, = jax_engine.extract_many(sample, "vta", batch_size=2)
    _same(got, want)
    runs = len(names)
    assert runs > 1
    clips = [(frames, chin), (frames[:5], chin[:5])]
    got = port_engine.gestsync_features_from_raw_many(clips, batch_size=2)
    want = jax_engine.gestsync_features_from_raw_many(clips, batch_size=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    assert len(names) > runs + 1
    assert all(n.startswith("jegal-stage") for n in names)


def test_engine_passes_its_tower_settings(weights, clip):
    """JegalEngine(stem_impl="window", conv2_impl="dense"), the settings
    other than the defaults, runs every tower call with them (on the CPU,
    their twins: the same features to 2e-5); unknown settings raise."""
    planar = clip[2][:2]
    want = _port_engine(weights).gestsync_features(planar)
    got = _port_engine(weights, stem_impl="window",
                       conv2_impl="dense").gestsync_features(planar)
    np.testing.assert_allclose(got, want, **TOL)
    for kw in (dict(stem_impl="rotate"), dict(conv2_impl="mgrid")):
        with pytest.raises(ValueError, match="impl"):
            _port_engine(weights, **kw)
