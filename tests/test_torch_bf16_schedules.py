"""The arithmetic of the bf16 kernels 6b and 7b, emulated on the CPU and
held against their plain twins and the JAX Pallas kernels interpreted on
bf16 inputs. The kernels run only on the card
(tests/test_torch_kernels_cuda.py); these tests keep their schedules
testable here:

* flash attention in bf16 (csrc/flash_attention.cu, kernel 6b): q * scale
  (float32) and p split into two bf16 pieces, hi = bf16(x) and lo = bf16(x
  - hi), each product two passes (lo, then hi) of exact bf16 products
  summed in float32; 64-key tiles; keys cut into two slices, each with its
  own online softmax (running max from -2e9, the -1e9 fill, -inf past T),
  merged in slice order: at head width 64 (the wgmma kernel) the even and
  the odd tiles, at 96 (the mma.sync kernel) each tile's two halves of 32
  keys; each tile's P V from zero, added to the rescaled O in float32;
  the output rounded to bf16 once;
* block 2 in bf16 (csrc/conv2.cu, kernel 7b): the implicit GEMM's K one
  (kh, kw) tap a stage, 25 stages of 64 channels, one float32 chain
  through all of them; then the folded scale, bias and ReLU in float32 and
  the output rounded to bf16 once.

A product of two bf16 values is exact in float32, so float32 matmuls of
the bf16 pieces stand in for the tensor cores (their sums run in another
order inside a 16-deep step; the bars below absorb that).

Bars: tests/bf16_bars.py's MAX_ULPS (2 bf16 ulps an element, measured at
its row's RMS when smaller) and KERNEL_COS (min row cosine 0.9999), the
bars the card tests hold the kernels to."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_tpu.ops.pallas import conv2 as JC2
from jegal_tpu.ops.pallas import flash_attention as JFA
from jegal_tpu.ops.pallas import stem as JS
from jegal_torch.convert import tree_to_torch
from jegal_torch.ops.kernels import conv2 as TC2
from jegal_torch.ops.kernels import flash_attention as FA
import bf16_bars as bars
from torch_threads import few_torch_threads  # noqa: F401

BF = torch.bfloat16
KT = 64                   # keys a tile
NEG_FILL = -1e9


def pieces(x, n: int = 2):
    """x (float32) as n bf16 pieces, each the bf16 rounding of what the
    ones before leave, as float32 tensors."""
    out = []
    for _ in range(n):
        p = x.to(BF).float()
        out.append(p)
        x = x - p
    return out


def split_mm(a, b, n: int = 2):
    """a @ b with a (float32) in n bf16 pieces and b exact in bf16: the
    smallest piece's pass first."""
    acc = None
    for p in reversed(pieces(a, n)):
        term = p @ b
        acc = term if acc is None else acc + term
    return acc


def _slices(t: int, d: int):
    """Each key slice's blocks of keys [k0, k1): d 64, the even and the
    odd 64-key tiles; d 96, each tile's first and second 32 keys."""
    n = -(-t // KT)
    if d == 64:
        return [[(i * KT, i * KT + KT) for i in range(w, n, 2)]
                for w in (0, 1)]
    return [[(i * KT + 32 * w, i * KT + 32 * w + 32) for i in range(n)]
            for w in (0, 1)]


def flash_bf16_emulated(q, k, v, mask, n: int = 2):
    """Kernel 6b's schedule on bf16 (B, H, T, D) q, k, v and a (B, T) key
    mask or None -> bf16 (B, H, T, D); q * scale and p in n pieces."""
    b, h, t, d = q.shape
    qs = q.float() * torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    kf, vf = k.float(), v.float()
    parts = []
    for blocks in _slices(t, d):
        m = torch.full((b, h, t), 2 * NEG_FILL)
        l = torch.zeros(b, h, t)
        o = torch.zeros(b, h, t, d)
        for k0, k1 in blocks:
            keys = torch.arange(k0, k1)
            live = keys < t
            at = keys.clamp(max=t - 1)
            kt = kf[:, :, at] * live[:, None]      # zero past T
            vt = vf[:, :, at] * live[:, None]
            s = split_mm(qs, kt.transpose(-1, -2), n)
            if mask is not None:
                filled = (mask[:, at] == 0)[:, None, None, :]
                s = torch.where(filled, torch.tensor(NEG_FILL), s)
            s = torch.where(live, s, torch.tensor(-math.inf))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + split_mm(p, vt, n)
            m = m_new
        parts.append((m, l, o))
    m_all = torch.maximum(parts[0][0], parts[1][0])
    num = sum(o * torch.exp(m - m_all)[..., None] for m, _, o in parts)
    den = sum(l * torch.exp(m - m_all) for m, l, _ in parts)
    return (num / den[..., None]).to(BF)


def _qkvm(seed, b, h, t, d, masked=True):
    """bf16 q, k, v (B, H, T, D) and a (B, T) key mask: a pad tail in
    every batch row and, in the last, every key masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                .astype(np.float32)).to(BF)
               for _ in range(3))
    mask = np.ones((b, t), np.float32)
    mask[:, t - t // 4:] = 0.0
    mask[-1] = 0.0
    return q, k, v, torch.from_numpy(mask) if masked else None


@pytest.mark.parametrize("t", [5, 100, 128, 256])
@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("masked", [True, False])
def test_flash_bf16_schedule_matches_twin(t, d, masked):
    """Ragged T (under one tile, a ragged last tile, one slice's tiles all
    past T at 5) and whole tiles, with a pad tail and a fully masked batch
    row (which averages V uniformly), and without a mask."""
    q, k, v, mask = _qkvm(7 * t + d, 2, 2, t, d, masked)
    got = flash_bf16_emulated(q, k, v, mask)
    bars.check_kernel_bar(got, FA.flash_attention_plain(q, k, v, mask),
                          f"6b schedule, T {t}, D {d}")
    if masked:
        bars.check_kernel_bar(got[-1], v[-1].float().mean(1, keepdim=True)
                              .expand_as(v[-1]).to(BF), "the masked row")


def test_two_pieces_hold_the_bar_one_does_not():
    """Why two bf16 pieces of q * scale and p: at D 96 (1/sqrt(96) is no
    power of two, so q * scale is no bf16 value) one piece leaves errors of
    bf16 ulps on the output; two keep it within the bar, as three do."""
    q, k, v, mask = _qkvm(5, 2, 4, 256, 96)
    want = FA.flash_attention_plain(q, k, v, mask)
    worst = {n: bars.kernel_bar(flash_bf16_emulated(q, k, v, mask, n),
                                want)[0] for n in (1, 2, 3)}
    assert worst[2] <= bars.MAX_ULPS and worst[3] <= bars.MAX_ULPS, worst
    assert worst[1] > worst[2], worst


def _jax_bf16(x):
    return jnp.asarray(x.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("t", [5, 100, 128, 256])
@pytest.mark.parametrize("d", [64, 96])
def test_flash_bf16_schedule_and_twin_match_pallas_kernel(t, d):
    """The schedule and the bf16 twin against the Pallas kernel interpreted
    on the same bf16 q, k, v (T 256 spans two of its 128-key blocks; at 5
    and 100 its one block is the whole T)."""
    q, k, v, mask = _qkvm(3 * t + d, 2, 2, t, d)
    want = np.asarray(JFA.flash_attention(
        _jax_bf16(q), _jax_bf16(k), _jax_bf16(v), jnp.asarray(mask.numpy()),
        128, 128, True).astype(jnp.float32))
    bars.check_kernel_bar(flash_bf16_emulated(q, k, v, mask), want,
                          f"6b schedule vs Pallas, T {t}, D {d}")
    bars.check_kernel_bar(FA.flash_attention(q, k, v, mask), want,
                          f"bf16 twin vs Pallas, T {t}, D {d}")


def conv2_bf16_emulated(x, w, scale, bias):
    """Kernel 7b's schedule: bf16 x (T, J, Wp, 64), w (5, 5, 64, 128) ->
    bf16 (T, J2, W2, 128)."""
    t, n_j, w_pool, c = x.shape
    _, j2, w2, n = TC2.out_shape(t, n_j, w_pool)
    xf, wf = x.float(), w.float()
    acc = torch.zeros(t * j2 * w2, n)
    for kh in range(5):                 # one stage a tap, in (kh, kw) order
        for kw in range(5):
            a = xf[:, kh:kh + 2 * j2 - 1:2, kw:kw + 2 * w2 - 1:2]
            acc = acc + a.reshape(-1, c) @ wf[kh, kw]
    y = torch.relu(acc * scale + bias)
    return y.reshape(t, j2, w2, n).to(BF)


def _blk2(rng):
    """Block 2's tree with randomized BatchNorm statistics, float32."""
    return {"conv": {"kernel": rng.standard_normal((1, 5, 5, 64, 128),
                                                   dtype=np.float32) * 0.03,
                     "bias": rng.standard_normal(128, dtype=np.float32)
                     * 0.1},
            "bn": {"scale": rng.random(128, dtype=np.float32) + 0.5,
                   "bias": rng.standard_normal(128, dtype=np.float32) * 0.1,
                   "mean": rng.standard_normal(128, dtype=np.float32) * 0.1,
                   "var": rng.random(128, dtype=np.float32) + 0.5}}


@pytest.mark.parametrize("t,n_j,w_pool", [(3, 11, 14), (2, 9, 16)])
def test_conv2_bf16_schedule_matches_twin_and_pallas_kernel(t, n_j, w_pool):
    """Against the bf16 twin and mgrid_conv2_fused interpreted on the same
    bf16 values (the port's dense input is the m-grid's even lanes, as
    tests/test_torch_bf16.py builds it), with randomized BatchNorm
    statistics."""
    rng = np.random.default_rng(13 + t)
    blk2 = _blk2(rng)
    dense = torch.from_numpy(rng.random((t, n_j, w_pool, 64),
                                        dtype=np.float32)).to(BF)
    # the tree in bf16 on both sides (the same values), folded in float32
    ops = TC2.conv2_kernel_params(jax.tree.map(lambda a: a.to(BF),
                                               tree_to_torch(blk2)))
    assert ops[0].dtype == BF and ops[1].dtype == torch.float32
    got = conv2_bf16_emulated(dense, *ops)
    assert tuple(got.shape) == TC2.out_shape(t, n_j, w_pool)
    bars.check_kernel_bar(got, TC2.conv2_bn_relu_plain(dense, *ops),
                          "7b schedule vs twin")
    m = np.zeros((t, n_j, 64, JS.SLOT), np.float32)
    m[..., 0:2 * w_pool:2] = dense.float().numpy().transpose(0, 1, 3, 2)
    want = JC2.mgrid_conv2_fused(jnp.asarray(m, jnp.bfloat16),
                                 *JC2.conv2_kernel_params(jax.tree.map(
                                     lambda a: jnp.asarray(a, jnp.bfloat16),
                                     blk2)), w_pool,
                                 interpret=True)
    bars.check_kernel_bar(got, np.asarray(want.astype(jnp.float32)),
                          "7b schedule vs Pallas")
