"""The port's blockwise attention (ops/kernels/flash_attention.py) and the
encoder routing around it (core/transformer.py) against the JAX package on
the CPU: the plain twin against the Pallas kernel in interpret mode, the
autograd backward against jax.vjp of flash_attention_diff, the dispatch
gates, and which encoders take the layer loop and its flash attention.

Inputs are drawn with numpy from fixed seeds. Tolerance rtol = atol = 2e-5
(the port's float32 parity bar)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_tpu.core import transformer as JT
from jegal_tpu.ops.pallas import flash_attention as JFA
from jegal_tpu.ops.pallas import fused_layer as JFL
from jegal_torch.convert import init_jegal_params
from jegal_torch.core import transformer as TT
from jegal_torch.models import jegal as TJ
from jegal_torch.ops.kernels import _build
from jegal_torch.ops.kernels import flash_attention as FA
from jegal_torch.ops.kernels import fused_layer as FL
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkvm(seed, b, h, t, d):
    """q, k, v (B, H, T, D) and a (B, T) key mask with a partial row and,
    in batch row 1, every key masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32)
               for _ in range(3))
    mask = (rng.random((b, t)) > 0.3).astype(np.float32)
    mask[0, 0] = 1.0
    mask[1] = 0.0
    return q, k, v, mask


@pytest.mark.parametrize("t", [16, 128, 256])
@pytest.mark.parametrize("d", [64, 96])
def test_plain_twin_matches_pallas_kernel(t, d):
    q, k, v, mask = _qkvm(t + d, 2, 2, t, d)
    want = np.asarray(JFA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        128, 128, True))
    got = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the fully masked batch row averages V uniformly, as the dense softmax
    np.testing.assert_allclose(got[1].numpy(),
                               np.broadcast_to(v[1].mean(1, keepdims=True),
                                               v[1].shape), **TOL)


@pytest.mark.parametrize("t,d", [(16, 96), (128, 64)])
def test_backward_matches_jax_vjp(t, d):
    q, k, v, mask = _qkvm(7 * t + d, 2, 2, t, d)
    g = np.random.default_rng(t).standard_normal(q.shape).astype(np.float32)
    out, vjp = jax.vjp(
        lambda q, k, v: JFA.flash_attention_diff(q, k, v, jnp.asarray(mask),
                                                 128, 128, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = FA.flash_attention_diff(tq, tk, tv, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    got.backward(torch.from_numpy(g))
    for name, gt, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("t,d_k", [(8, 64), (16, 96), (21, 64), (100, 64),
                                   (128, 96), (200, 64), (256, 64),
                                   (384, 96), (512, 64), (640, 64),
                                   (1024, 64), (128, 48)])
def test_flash_gate_equals_jax(t, d_k):
    assert TT._flash_ok(t, d_k) == JT._flash_ok(t, d_k)


@pytest.mark.parametrize("seg,d,heads", [(21, 512, 8), (32, 512, 8),
                                         (128, 768, 8), (512, 512, 8),
                                         (513, 512, 8), (640, 512, 8),
                                         (1024, 512, 8), (16, 768, 12),
                                         (16, 640, 8), (7, 512, 8)])
def test_fused_gate_equals_jax(seg, d, heads):
    assert FL.fused_stack_ok(seg, d, heads) == JFL.fused_stack_ok(seg, d,
                                                                   heads)
    if seg <= 512:
        assert FL.block_rows(seg) == JFL.block_rows(seg)


@pytest.fixture
def routes(monkeypatch):
    """Drive the card's routing on the CPU: the routing's device test says
    "on the card", and the fused stack and the flash entry are counted.
    Their CPU tensors then run the kernels' plain twins."""
    calls = {"fused": [], "flash": []}
    fused, flash = FL.fused_prenorm_stack, FA.flash_attention_diff

    def count_fused(stack, x, seg, *a, **kw):
        calls["fused"].append(seg)
        return fused(stack, x, seg, *a, **kw)

    def count_flash(q, k, v, mask=None):
        calls["flash"].append(tuple(q.shape))
        return flash(q, k, v, mask)

    monkeypatch.setattr(TT, "_on_card", lambda t: True)
    monkeypatch.setattr(FL, "fused_prenorm_stack", count_fused)
    monkeypatch.setattr(FA, "flash_attention_diff", count_flash)
    return calls


@pytest.fixture(scope="module")
def jegal():
    params = init_jegal_params(torch.Generator().manual_seed(5))
    for enc in ("encoder_rgb", "encoder_text"):     # 2 layers each
        params[enc]["layers"] = params[enc]["layers"][:2]
    return params


@pytest.mark.parametrize("t,fused,want_fused,want_flash", [
    (128, False, 0, 2),     # training: the layer loop, flash in every layer
    (128, True, 1, 0),      # inference at T <= 512: the fused sublayers
    (640, True, 0, 2),      # a long clip (T > 512): the loop and flash
])
def test_gesture_encoder_routes(routes, jegal, t, fused, want_fused,
                                want_flash):
    rng = np.random.default_rng(t)
    feats = torch.from_numpy(rng.standard_normal((1, t, 1024))
                             .astype(np.float32))
    mask = torch.ones(1, t)
    mask[0, t - 5:] = 0.0
    with torch.no_grad():
        got = TJ.forward_gestures(jegal, feats, mask, fused=fused)
    assert routes["fused"] == [t] * want_fused
    assert routes["flash"] == [(1, 8, t, 64)] * want_flash
    # every route computes the same function
    want = TJ.forward_gestures(jegal, feats, mask, fused=False)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), **TOL)


def test_text_encoder_trains_on_flash(routes, jegal):
    x = torch.randn(2, 32, 768, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 32)
    mask[1, 20:] = 0.0
    TJ.forward_text(jegal, x, mask, fused=False)
    assert routes["fused"] == []
    assert routes["flash"] == [(2, 8, 32, 96)] * 2


def test_forced_flash_matches_dense_on_the_cpu(monkeypatch, jegal):
    """With the routing's device test saying "on the card", the CPU loop's
    attention is flash_attention_diff (its twin, with the dense backward)
    and matches the dense path, value and gradient."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 32, 512)).astype(np.float32))
    mask = torch.from_numpy((rng.random((2, 1, 32)) > 0.2)
                            .astype(np.float32))
    seen = []
    real = FA.flash_attention_diff

    def count_flash(q, k, v, m=None):
        seen.append(tuple(q.shape))
        return real(q, k, v, m)

    monkeypatch.setattr(FA, "flash_attention_diff", count_flash)

    def run():
        xg = x.clone().requires_grad_(True)
        out = TT.encoder_stack(jegal["encoder_rgb"], xg, mask, 8, fused=False)
        out.square().sum().backward()
        return out.detach().numpy(), xg.grad.numpy()

    dense = run()
    assert seen == []
    monkeypatch.setattr(TT, "_on_card", lambda t: True)
    _build.reset_launches()
    flash = run()
    assert seen == [(2, 8, 32, 64)] * 2
    assert _build.LAUNCHES["flash_attention"] == 0     # no kernel on the CPU
    for a, b in zip(flash, dense):
        np.testing.assert_allclose(a, b, **TOL)


def _refused(jegal, case):
    """One input that no kernel takes, run through the card's routing."""
    rng = np.random.default_rng(3)
    b, t, d = 2, 32, 512
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))
    pair_mask = torch.ones(b, t, t)             # (B, Tq, Tk): no key mask
    enc = jegal["encoder_rgb"]
    if case == "fused stack, pair mask":
        return TT.encoder_stack(enc, x, pair_mask, 8)
    if case == "layer loop, pair mask":
        return TT.encoder_stack(enc, x, pair_mask, 8, fused=False)
    if case == "layer loop, T the flash gate refuses":
        return TT.encoder_stack(enc, x[:, :21], None, 8, fused=False)
    if case == "post-norm stack, pair mask":
        return TT.torch_encoder_stack(enc, x, pair_mask, 8)
    h = enc["layers"][0]
    return TT.multi_head_attention(h["attn"], x, x[:, :16], x[:, :16],
                                   None, 8)


@pytest.mark.parametrize("case", [
    "fused stack, pair mask", "layer loop, pair mask",
    "layer loop, T the flash gate refuses", "post-norm stack, pair mask",
    "cross-attention"])
def test_card_routing_raises_where_no_kernel_takes_the_input(routes, jegal,
                                                             case):
    """On the card nothing falls back to the plain attention: an input the
    kernels cannot take raises, and no kernel (or twin) was entered."""
    with torch.no_grad(), pytest.raises(ValueError):
        _refused(jegal, case)
    assert routes == {"fused": [], "flash": []}
