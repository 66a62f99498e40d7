"""jegal_torch models against the JAX package on the CPU: the GestSync
tower at the real 270x480 geometry (the only one where it reduces to 1x1)
on a few frames, and the JEGAL gesture/audio branches and forward_inference
combos without text (the text combos: tests/test_torch_text.py). Weights are drawn by jegal_torch.convert.init_* (randomized BN
statistics and LN parameters), handed to JAX as numpy and carried back with
*_params_from_jax, so both packages compute with the same weights.

Tolerance rtol = atol = 2e-5 unless a test says otherwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_tpu.models import gestsync as JG
from jegal_tpu.models import jegal as JJ
from jegal_torch.convert import (
    gestsync_params_from_jax,
    init_gestsync_params,
    init_jegal_params,
    jegal_params_from_jax,
)
from jegal_torch.models import gestsync as TG
from jegal_torch.models import jegal as TJ
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


def _as_numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def gs():
    jp = _as_numpy(init_gestsync_params(torch.Generator().manual_seed(1)))
    return jp, gestsync_params_from_jax(jp)


@pytest.fixture(scope="module")
def jg():
    jp = _as_numpy(init_jegal_params(torch.Generator().manual_seed(2)))
    return jp, jegal_params_from_jax(jp)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    return rng.random((8, 270, 480, 3), dtype=np.float32)


def test_conv_tokens_and_chunking(gs, frames):
    """Conv tower over 8 padded frames (4 tokens) == the JAX XLA tower; a
    chunk of 3 (two pieces, 4-frame halo) changes nothing."""
    jp, tp = gs
    want = np.asarray(JG.conv_tokens(jp, jnp.asarray(frames),
                                     use_pallas=False))
    got = TG.conv_tokens(tp, torch.from_numpy(frames)).numpy()
    assert got.shape == (4, 512)
    np.testing.assert_allclose(got, want, **TOL)
    chunked = TG.conv_tokens(tp, torch.from_numpy(frames), chunk=3).numpy()
    np.testing.assert_allclose(chunked, got, **TOL)


def test_window_head(gs, rng):
    jp, tp = gs
    tokens = rng.standard_normal((7 + 20, 512)).astype(np.float32)
    want = np.asarray(JG.window_head(jp, jnp.asarray(tokens)))
    got = TG.window_head(tp, torch.from_numpy(tokens)).numpy()
    assert got.shape == (7, 1024)
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_vid_windowed_and_shared_conv(gs, rng):
    """The per-window oracle on one 25-frame clip == the JAX oracle, and
    its token mean == the shared-conv extract_features of the same frames
    (one window)."""
    jp, tp = gs
    clip = rng.random((1, 25, 270, 480, 3), dtype=np.float32)
    want = np.asarray(JG.forward_vid_windowed(jp, jnp.asarray(clip)))
    got = TG.forward_vid_windowed(tp, torch.from_numpy(clip)).numpy()
    assert got.shape == (1, 1024, 21)
    np.testing.assert_allclose(got, want, **TOL)
    feats = TG.extract_features(tp, torch.from_numpy(clip[0])).numpy()
    np.testing.assert_allclose(feats, got.mean(axis=-1), **TOL)


def test_forward_gestures_masked(jg, rng):
    jp, tp = jg
    t_bucket, t = 32, 19
    feats = rng.standard_normal((1, t_bucket, 1024)).astype(np.float32)
    mask = (np.arange(t_bucket) < t).astype(np.float32)[None]
    want = np.asarray(JJ.forward_gestures(jp, jnp.asarray(feats),
                                          jnp.asarray(mask), fused=False))
    got = TJ.forward_gestures(tp, torch.from_numpy(feats),
                              torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[:, :t], want[:, :t], **TOL)


@pytest.mark.parametrize("combo", ["v", "va", "a"])
def test_forward_inference_combos(jg, rng, combo):
    jp, tp = jg
    use_v, use_a = "v" in combo, "a" in combo
    arrays = {}
    if use_v:
        arrays["visual_feats"] = rng.standard_normal(
            (1, 32, 1024)).astype(np.float32)
        arrays["visual_mask"] = (np.arange(32) < 27).astype(np.float32)[None]
    if use_a:
        arrays["audio_mel"] = rng.standard_normal((1, 128, 80)).astype(
            np.float32)
        pool = np.zeros((1, 8, 32), np.float32)
        pool[0, 0, 0:3], pool[0, 1, 3:9], pool[0, 2, 9:20] = 1 / 3, 1 / 6, 1 / 11
        arrays["audio_pool"] = pool
        arrays["audio_valid"] = np.array([121])
    want = JJ.forward_inference(
        jp, use_v=use_v, use_t=False, use_a=use_a,
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    got = TJ.forward_inference(
        tp, use_v=use_v, use_t=False, use_a=use_a,
        **{k: torch.from_numpy(v) for k, v in arrays.items()})
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_forward_inference_needs_a_modality(jg):
    with pytest.raises(ValueError, match="at least one modality"):
        TJ.forward_inference(jg[1], use_v=False, use_t=False, use_a=False)
