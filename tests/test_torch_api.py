"""The whole `va` slice of the port against the JAX package on the CPU:
jegal_torch.api.JegalEngine(device="cpu").extract(frames=...) and
jegal_tpu.api.JegalEngine.extract(frames=...) on one short clip at the real
270x480 geometry (the only one at which the GestSync tower reduces to 1x1),
with the same weights, chin rows, audio and word boundaries. Each side
runs once in a module fixture.

Tolerance: the embeddings are unit-norm rows after a 270x480 conv tower, two
6-layer transformers and the audio CNN, each summed in another order by
oneDNN (torch) and XLA:CPU; rtol = atol = 2e-5 holds for every element."""

import numpy as np
import pytest
import torch

import jax

from jegal_tpu import api as JAPI
from jegal_torch import api as TAPI
from jegal_torch.convert import (
    gestsync_params_from_jax,
    init_gestsync_params,
    init_jegal_params,
    jegal_params_from_jax,
)
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
T = 8                                    # frames: T bucket 32, 56 padded


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
        fname="clip")


@pytest.fixture(scope="module")
def weights():
    """JAX-layout numpy trees (randomized BN statistics and LN
    parameters), drawn by the port's init_* from a seed."""
    return (_as_numpy(init_jegal_params(torch.Generator().manual_seed(31))),
            _as_numpy(init_gestsync_params(torch.Generator().manual_seed(32))))


@pytest.fixture(scope="module")
def jax_va(weights, sample):
    """The JAX engine's `va` result. Its gesture rows are also the `v`
    combo's: the gesture branch does not read the audio."""
    jp, gp = weights
    eng = JAPI.JegalEngine(jegal_params=jp, gestsync_params=gp)
    return eng.extract(modalities="va", **sample)


@pytest.fixture(scope="module")
def port_engine(weights):
    jp, gp = weights
    return TAPI.JegalEngine(jegal_params_from_jax(jp),
                            gestsync_params_from_jax(gp), device="cpu")


@pytest.fixture(scope="module")
def port_results(port_engine, sample):
    return {combo: port_engine.extract(modalities=combo, **sample)
            for combo in ("va", "v")}


@pytest.mark.parametrize("combo", ["va", "v"])
def test_fused_slice_matches_jax(port_results, jax_va, combo):
    got, want = port_results[combo], jax_va
    assert got["gesture_emb"].shape == (T, 512)
    assert got["gesture_emb"].dtype == np.float32
    np.testing.assert_allclose(
        np.linalg.norm(got["gesture_emb"], axis=-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got["gesture_emb"], want["gesture_emb"], **TOL)
    if combo == "va":
        assert got["content_emb"].shape == (3, 512)
        np.testing.assert_allclose(got["content_emb"], want["content_emb"],
                                   **TOL)
    else:
        assert got["content_emb"] is None
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
    two_stage = port_engine.extract(modalities="v", visual_feats=feats.numpy())
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


def test_text_is_the_next_slice(port_engine):
    with pytest.raises(NotImplementedError, match="next slice"):
        port_engine.extract(modalities="vta")
