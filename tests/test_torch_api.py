"""The port's engine against the JAX package's on the CPU, in all seven
modality combos: jegal_torch.api.JegalEngine(device="cpu").extract and
jegal_tpu.api.JegalEngine.extract on one short clip at the real 270x480
geometry (the only one at which the GestSync tower reduces to 1x1), with
the same weights, chin rows, text, audio and word boundaries, a tiny XLM-R
(1 layer, d 768, 8 heads) and the tiny BPE tokenizer of tests/tok_util.py
wrapped by each package's WordTokenizer. Combos with 'v' take the frames;
the JAX engine runs `vta` from frames and `t`, `a`, `ta` without: a
combo's gesture rows are `vta`'s (the gesture branch reads nothing else)
and its content rows those of the combo without 'v'.

Tolerance: the embeddings are unit-norm rows after a 270x480 conv tower, two
6-layer transformers and the audio CNN, each summed in another order by
oneDNN (torch) and XLA:CPU; rtol = atol = 2e-5 holds for every element."""

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
from jegal_torch.models.roberta import RobertaConfig
from jegal_torch.text.tokenizer import WordTokenizer
from tok_util import make_tiny_tokenizer
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
T = 8                                    # frames: T bucket 32, 56 padded
TINY_XLMR = dict(vocab_size=64, hidden_size=768, num_layers=1, num_heads=8,
                 intermediate_size=256, max_position_embeddings=64)
WITH_FRAMES = ("va", "v", "vta", "vt")
WITHOUT_FRAMES = ("ta", "t", "a")


def _as_numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def sample():
    rng = np.random.default_rng(21)
    return dict(
        frames=rng.integers(0, 256, (T, 270, 480, 3), dtype=np.uint8),
        chin_rows=rng.integers(90, 200, T).astype(np.int32),
        wav=(rng.standard_normal(T * 640) * 1000).astype(np.float32),
        word_boundaries=[["a", 0, 1], ["b", 2, 4], ["c", 5, 7]],
        text="hello world abc", fname="clip")


def _without_frames(sample):
    return {k: v for k, v in sample.items()
            if k not in ("frames", "chin_rows")}


@pytest.fixture(scope="module")
def weights():
    """JAX-layout numpy trees (randomized BN statistics and LN
    parameters), drawn by the port's init_* from a seed."""
    return (_as_numpy(init_jegal_params(torch.Generator().manual_seed(31))),
            _as_numpy(init_gestsync_params(torch.Generator().manual_seed(32))))


@pytest.fixture(scope="module")
def roberta():
    """Tiny XLM-R weights (randomized LN parameters) as a numpy tree."""
    cfg = RobertaConfig(**TINY_XLMR)
    return _as_numpy(init_roberta_params(torch.Generator().manual_seed(33),
                                         cfg)), cfg


@pytest.fixture(scope="module")
def jax_results(weights, roberta, sample):
    """The JAX engine's `vta` from frames, and `t`, `a`, `ta` without."""
    jp, gp = weights
    rp, cfg = roberta
    eng = JAPI.JegalEngine(
        jegal_params=jp, gestsync_params=gp, roberta_params=rp,
        roberta_cfg=JR.RobertaConfig(**TINY_XLMR),
        tokenizer=JaxWordTokenizer(make_tiny_tokenizer()))
    out = {"vta": eng.extract(modalities="vta", **sample)}
    for combo in WITHOUT_FRAMES:
        out[combo] = eng.extract(modalities=combo, **_without_frames(sample))
    return out


@pytest.fixture(scope="module")
def port_engine(weights, roberta):
    jp, gp = weights
    rp, cfg = roberta
    return TAPI.JegalEngine(jegal_params_from_jax(jp),
                            gestsync_params_from_jax(gp), device="cpu",
                            roberta_params=roberta_params_from_jax(rp),
                            roberta_cfg=cfg,
                            tokenizer=WordTokenizer(make_tiny_tokenizer()))


@pytest.fixture(scope="module")
def port_results(port_engine, sample):
    out = {combo: port_engine.extract(modalities=combo, **sample)
           for combo in WITH_FRAMES}
    for combo in WITHOUT_FRAMES:
        out[combo] = port_engine.extract(modalities=combo,
                                         **_without_frames(sample))
    return out


def _check_content(got, jax_results, combo):
    content_combo = combo.replace("v", "")
    if not content_combo:
        assert got["content_emb"] is None
        return
    want = jax_results[content_combo]["content_emb"]
    assert got["content_emb"].shape == want.shape == (3, 512)
    np.testing.assert_allclose(got["content_emb"], want, **TOL)


@pytest.mark.parametrize("combo", WITH_FRAMES)
def test_fused_slice_matches_jax(port_results, jax_results, combo):
    got, want = port_results[combo], jax_results["vta"]
    assert got["gesture_emb"].shape == (T, 512)
    assert got["gesture_emb"].dtype == np.float32
    np.testing.assert_allclose(
        np.linalg.norm(got["gesture_emb"], axis=-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got["gesture_emb"], want["gesture_emb"], **TOL)
    _check_content(got, jax_results, combo)
    assert got["info"] == want["info"]


@pytest.mark.parametrize("combo", WITHOUT_FRAMES)
def test_combos_without_frames_match_jax(port_results, jax_results, combo):
    got, want = port_results[combo], jax_results[combo]
    assert got["gesture_emb"] is None
    np.testing.assert_allclose(
        np.linalg.norm(got["content_emb"], axis=-1), 1.0, rtol=1e-6)
    _check_content(got, jax_results, combo)
    assert got["info"] == want["info"]


def test_features_form_matches_frames_form(port_engine, port_results,
                                           sample):
    """extract(visual_feats=...) on the tower's features gives the fused
    path's gesture rows (the two-stage form pads features with zeros, the
    fused form with edge-repeat frames; the mask hides both)."""
    from jegal_torch.models import gestsync as G
    from jegal_torch.ops.video import mask_frames_device

    masked = mask_frames_device(torch.from_numpy(sample["frames"]),
                                torch.from_numpy(sample["chin_rows"]))
    with torch.inference_mode():
        feats = G.extract_features(port_engine.gestsync_params, masked)
    two_stage = port_engine.extract(modalities="v",
                                    visual_feats=feats.numpy())
    np.testing.assert_allclose(two_stage["gesture_emb"],
                               port_results["v"]["gesture_emb"], **TOL)


def test_no_card_raises(weights, monkeypatch):
    """Without a card, the default device raises; nothing falls back to the
    CPU unless the caller asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jp, gp = weights
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TAPI.JegalEngine(jegal_params_from_jax(jp),
                         gestsync_params_from_jax(gp))


@pytest.mark.parametrize("kwargs,match", [
    (dict(modalities="vx"), "modalities"),
    (dict(modalities="v"), "requires visual_feats"),
    (dict(modalities="a", wav=np.zeros(100, np.float32),
          word_boundaries=[["a", 0, 1]]), ">= 640 samples"),
    (dict(modalities="a", wav=np.zeros(1000, np.float32),
          word_boundaries=[["a", 3, 1]]), "start <= end"),
    (dict(modalities="v", frames=np.zeros((2, 270, 480, 3), np.float32)),
     "uint8"),
    (dict(modalities="v", frames=np.zeros((2, 27, 48, 3), np.uint8)),
     "frames must be"),
    (dict(modalities="v", visual_feats=np.zeros((3, 512), np.float32)),
     "visual_feats must be"),
    (dict(modalities="v", visual_feats=np.zeros((3, 1024), np.float32),
          chin_rows=np.zeros(3)), "chin_rows requires frames"),
])
def test_client_errors(port_engine, kwargs, match):
    with pytest.raises(TAPI.ClientError, match=match):
        port_engine.extract(**kwargs)


@pytest.mark.parametrize("text,match", [
    (None, "requires text"),
    ("   ", "non-empty string"),
    (["hello"], "non-empty string"),
])
def test_text_client_errors(port_engine, text, match):
    with pytest.raises(TAPI.ClientError, match=match):
        port_engine.extract(modalities="t", text=text)


def test_text_needs_a_tokenizer(weights, roberta):
    jp, _ = weights
    rp, cfg = roberta
    eng = TAPI.JegalEngine(jegal_params_from_jax(jp), device="cpu",
                           roberta_params=roberta_params_from_jax(rp),
                           roberta_cfg=cfg)
    with pytest.raises(RuntimeError, match="no tokenizer"):
        eng.extract(modalities="t", text="hello world")


def test_text_audio_word_count_mismatch_is_invalid(port_engine, sample):
    """Two words of text against three word boundaries: the reference's
    concat would fail; the engine rejects the sample with None (the JAX
    engine's rule, api.py:775-776)."""
    s = dict(_without_frames(sample), text="hello world")
    assert port_engine.extract(modalities="ta", **s) is None
