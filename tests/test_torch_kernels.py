"""Plain twins of the port's CUDA kernels against the JAX package's Pallas
kernels (interpret mode, as tests/test_fused_layer.py and
tests/test_stem_pallas.py run them) and against its XLA oracles, on the
CPU. A CPU tensor takes the twin, so the stacks and the stem below run the
twins; the kernels themselves are held against these twins on the card by
chip_smoke.py.

Tolerance: rtol = atol = 2e-5 throughout, as the JAX suite uses for its
own path equalities (tests/test_fused_engine.py:77)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_tpu.core import transformer as JT
from jegal_tpu.core.layers import (
    batch_norm_inference,
    conv3d,
    max_pool3d,
)
from jegal_tpu.models import gestsync as JG
from jegal_tpu.ops.pallas import fused_layer as JF
from jegal_tpu.ops.pallas import stem as JS
from jegal_torch.convert import tree_to_torch
from jegal_torch.core.layers import ref_layer_norm
from jegal_torch.ops.kernels import _build
from jegal_torch.ops.kernels import fused_layer as TF
from jegal_torch.ops.kernels import stem as TS
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


def _randomize_norms(stack, rng):
    for layer in stack["layers"]:
        for n in ("norm1", "norm2"):
            d = layer[n]["scale"].shape[0]
            layer[n] = {
                "scale": jnp.asarray(1 + 0.1 * rng.standard_normal(d),
                                     jnp.float32),
                "bias": jnp.asarray(0.1 * rng.standard_normal(d),
                                    jnp.float32)}
    return stack


@pytest.fixture(scope="module")
def post_stack():
    rng = np.random.default_rng(11)
    return _randomize_norms({"layers": [
        JT.init_encoder_layer(jax.random.PRNGKey(i), 128, 256)
        for i in range(2)]}, rng)


@pytest.fixture(scope="module")
def pre_stack():
    rng = np.random.default_rng(12)
    stack = _randomize_norms(
        JT.init_encoder_stack(jax.random.PRNGKey(7), 2, 128, 256), rng)
    stack["norm"] = {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(128),
                                          jnp.float32),
                     "bias": jnp.asarray(0.1 * rng.standard_normal(128),
                                         jnp.float32)}
    return stack


def test_torch_stack_twin_windows(post_stack, rng):
    """Post-norm twin over 21-token windows, a ragged window count (19
    windows: the Pallas kernel pads them to two 336-row blocks), against
    fused_torch_stack(interpret=True) and torch_encoder_stack."""
    n, d, heads = 19, 128, 2
    wins = rng.standard_normal((n, 21, d)).astype(np.float32)
    got = TF.fused_torch_stack(tree_to_torch(post_stack),
                               torch.from_numpy(wins.reshape(n * 21, d)),
                               21, heads).numpy().reshape(n, 21, d)
    pallas = np.asarray(JF.fused_torch_stack(
        post_stack, jnp.asarray(wins.reshape(n * 21, d)), 21, heads,
        interpret=True)).reshape(n, 21, d)
    oracle = np.asarray(JT.torch_encoder_stack(post_stack, wins, None, heads))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


def test_prenorm_stack_twin_masked(pre_stack, rng):
    """Pre-norm twin (ref LN, no final norm) over three 64-row sequences
    with partly masked keys, against fused_prenorm_stack(kmask,
    interpret=True) and encoder_stack's layers; then with the final norm
    against encoder_stack itself."""
    b, t, d, heads = 3, 64, 128, 2
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    lens = np.array([64, 17, 1])
    kmask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    params = tree_to_torch(pre_stack)
    got = TF.fused_prenorm_stack(
        params, torch.from_numpy(x.reshape(b * t, d)), t, heads,
        kmask=torch.from_numpy(kmask.reshape(-1))).numpy().reshape(b, t, d)
    pallas = np.asarray(JF.fused_prenorm_stack(
        pre_stack, jnp.asarray(x.reshape(b * t, d)), t, heads,
        kmask=jnp.asarray(kmask.reshape(-1)), interpret=True))
    np.testing.assert_allclose(got, pallas.reshape(b, t, d), **TOL)

    oracle = jnp.asarray(x)
    for layer in pre_stack["layers"]:
        oracle = JT.encoder_layer(layer, oracle, jnp.asarray(kmask)[:, None],
                                  heads)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)

    full = ref_layer_norm(params["norm"], torch.from_numpy(got)).numpy()
    want = JT.encoder_stack(pre_stack, x, jnp.asarray(kmask)[:, None], heads,
                            fused=False)
    np.testing.assert_allclose(full, np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def stem_blk():
    p = JG.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    blk = p["net_vid"][0]
    blk["bn"] = {
        "mean": jnp.asarray(rng.standard_normal(64), jnp.float32) * 0.1,
        "var": jnp.asarray(rng.random(64) + 0.5, jnp.float32),
        "scale": jnp.asarray(rng.standard_normal(64), jnp.float32),
        "bias": jnp.asarray(rng.standard_normal(64), jnp.float32) * 0.1,
    }
    return blk


def test_stem_twin(stem_blk, rng):
    """conv3d + BN + ReLU + maxpool twin at the geometry of
    tests/test_stem_pallas.py, (13, 54, 96, 3), against the XLA conv path
    and fused_stem_pool(interpret=True)."""
    frames = rng.random((13, 54, 96, 3)).astype(np.float32)
    ops = TS.stem_kernel_params(tree_to_torch(stem_blk))
    got = TS.stem_pool_plain(torch.from_numpy(frames), *ops).numpy()
    assert got.shape == TS.pooled_shape(13, 54, 96) == (9, 7, 14, 64)

    y = conv3d(stem_blk["conv"], jnp.asarray(frames)[None], stride=(1, 3, 3))
    y = jax.nn.relu(batch_norm_inference(stem_blk["bn"], y))
    oracle = np.asarray(max_pool3d(y, (1, 3, 3), (1, 2, 2))[0])
    np.testing.assert_allclose(got, oracle, **TOL)

    lhs, scale, bias = JS.stem_kernel_params(stem_blk)
    pallas = np.asarray(JS.fused_stem_pool(jnp.asarray(frames), lhs, scale,
                                           bias, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)


def test_cpu_tensors_take_the_twins_and_count_nothing(post_stack, rng):
    """A CPU tensor runs the plain twin and launches no kernel: the launch
    counters only move where a kernel is launched."""
    _build.reset_launches()
    x = torch.from_numpy(rng.standard_normal((42, 128)).astype(np.float32))
    w = TF.fused_weights(tree_to_torch(post_stack)["layers"][0])
    a = TF.attn_sublayer(x, w, 21, 2, prenorm=False, ln_kind="std")
    torch.testing.assert_close(
        a, TF.attn_sublayer_plain(x, w, 21, 2, prenorm=False, ln_kind="std"),
        rtol=0, atol=0)
    f = TF.ffn_sublayer(x, w, prenorm=True, ln_kind="ref")
    torch.testing.assert_close(
        f, TF.ffn_sublayer_plain(x, w, prenorm=True, ln_kind="ref"),
        rtol=0, atol=0)
    assert _build.LAUNCHES == {k: 0 for k in _build.LAUNCHES}
