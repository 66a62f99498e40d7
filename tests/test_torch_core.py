"""jegal_torch core layers and encoder stacks against the JAX package, on the
CPU, at narrow widths. The same numpy inputs and weights go through both;
tolerance rtol = atol = 2e-5, as the JAX suite uses for its own path
equalities (tests/test_fused_engine.py:77)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_tpu.core import layers as JL
from jegal_tpu.core import transformer as JT
from jegal_torch.convert import tree_to_torch
from jegal_torch.core import layers as TL
from jegal_torch.core import transformer as TT
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _norm_params(rng, d):
    return {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}


def _bn_params(rng, d):
    return dict(_norm_params(rng, d),
                mean=(0.1 * rng.standard_normal(d)).astype(np.float32),
                var=(0.5 + rng.random(d)).astype(np.float32))


def _randomized(tree, rng):
    """A JAX init tree with every leaf redrawn around its scale (LN/BN
    parameters and biases away from their identity values)."""
    def redraw(x):
        x = np.asarray(x)
        s = max(float(np.abs(x).max()), 0.1)
        return (rng.uniform(-s, s, x.shape)).astype(np.float32)
    return jax.tree.map(redraw, tree)


def test_linear_and_norms(rng):
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    lin = {"kernel": rng.standard_normal((24, 16)).astype(np.float32),
           "bias": rng.standard_normal(16).astype(np.float32)}
    ln = _norm_params(rng, 24)
    bn = _bn_params(rng, 24)
    pairs = [
        (JL.linear(lin, x), TL.linear(tree_to_torch(lin), _t(x))),
        (JL.ref_layer_norm(ln, x), TL.ref_layer_norm(tree_to_torch(ln), _t(x))),
        (JL.std_layer_norm(ln, x), TL.std_layer_norm(tree_to_torch(ln), _t(x))),
        (JL.batch_norm_inference(bn, x),
         TL.batch_norm_inference(tree_to_torch(bn), _t(x))),
        (JL.batch_norm_inference(bn, x).transpose(0, 2, 1),
         TL.batch_norm_nchw(tree_to_torch(bn), _t(x).transpose(1, 2))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("stride,padding", [((1, 1), (0, 0)),
                                            ((2, 3), (1, 1))])
def test_conv2d_and_pool(rng, stride, padding):
    x = rng.standard_normal((2, 17, 23, 4)).astype(np.float32)
    p = {"kernel": (0.2 * rng.standard_normal((3, 3, 4, 6))).astype(np.float32),
         "bias": rng.standard_normal(6).astype(np.float32)}
    want = JL.conv2d(p, x, stride=stride, padding=padding)
    got = TL.conv2d(tree_to_torch(p), _t(x), stride=stride, padding=padding)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        _np(TL.max_pool2d(_t(x), (3, 3), (2, 2))),
        np.asarray(JL.max_pool2d(x, (3, 3), (2, 2))), **TOL)


def test_conv3d_and_pool(rng):
    x = rng.standard_normal((1, 7, 20, 26, 3)).astype(np.float32)
    p = {"kernel": (0.1 * rng.standard_normal((5, 7, 7, 3, 8))
                    ).astype(np.float32),
         "bias": rng.standard_normal(8).astype(np.float32)}
    want = JL.conv3d(p, x, stride=(1, 3, 3))
    got = TL.conv3d(tree_to_torch(p), _t(x), stride=(1, 3, 3))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        _np(TL.max_pool3d(_t(x), (1, 3, 3), (1, 2, 2))),
        np.asarray(JL.max_pool3d(x, (1, 3, 3), (1, 2, 2))), **TOL)


def test_position_encoding_bit_equal():
    for n, d in ((50, 512), (700, 64)):
        np.testing.assert_array_equal(
            _np(TT.sinusoidal_position_encoding(n, d)),
            np.asarray(JT.sinusoidal_position_encoding(n, d)))


def test_masked_attention_weights_fill(rng):
    s = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    m = (rng.random((2, 1, 1, 6)) > 0.5).astype(np.float32)
    m[1] = 0.0  # a fully masked row: uniform over its keys, as -1e9 gives
    want = JT.masked_attention_weights(jnp.asarray(s), jnp.asarray(m))
    got = TT.masked_attention_weights(_t(s), _t(m))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_multi_head_attention_dense(rng):
    d, h, b, t = 32, 4, 2, 9
    p = _randomized(JT.init_mha(jax.random.PRNGKey(1), d), rng)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([9, 4])[:, None])
    mask = mask.astype(np.float32)[:, None, :]
    want = JT.multi_head_attention(p, x, x, x, jnp.asarray(mask), h)
    got = TT.multi_head_attention(tree_to_torch(p), _t(x), _t(x), _t(x),
                                  _t(mask), h)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_encoder_stacks(rng):
    """Pre-norm (with final ref LN, key mask) and post-norm stacks, 2 layers
    at d=64, d_ff=96 — the CPU tensor path of both port stacks."""
    d, h, b, t = 64, 2, 2, 11
    pre = _randomized(JT.init_encoder_stack(jax.random.PRNGKey(2), 2, d, 96),
                      rng)
    post = {"layers": _randomized(
        JT.init_encoder_stack(jax.random.PRNGKey(3), 2, d, 96,
                              final_norm=False), rng)["layers"]}
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([11, 5])[:, None])
    mask = mask.astype(np.float32)[:, None, :]
    want_pre = JT.encoder_stack(pre, x, jnp.asarray(mask), h, fused=False)
    want_post = JT.torch_encoder_stack(post, x, None, h)
    got_pre = TT.encoder_stack(tree_to_torch(pre), _t(x), _t(mask), h)
    got_post = TT.torch_encoder_stack(tree_to_torch(post), _t(x), None, h)
    np.testing.assert_allclose(_np(got_pre), np.asarray(want_pre), **TOL)
    np.testing.assert_allclose(_np(got_post), np.asarray(want_post), **TOL)
