"""The arithmetic of kernels 1, 2, 3, 6 and 7 on the tensor cores, emulated on
the CPU and held against the JAX package and the port's plain twins. The
kernels themselves run only on the card (tests/test_torch_kernels_cuda.py);
these tests keep their schedules testable here:

* flash attention (csrc/flash_attention.cu): keys in 32-key tiles, each
  split into two 16-key halves that run their own online softmax (running
  max from -2e9, the -1e9 fill, -inf past T) and merge at the end; S = (q *
  scale) K^T in 3xTF32 with a float32 flush every 32 columns of D; each
  tile's P V in 3xTF32 from zero, added to the rescaled O in float32;
* block 2 (csrc/conv2.cu): the implicit GEMM's K in (kh, kw, c) order, 50
  stages of 32, each stage's 3xTF32 product from zero and added to a
  float32 sum, then the folded scale, bias and ReLU;
* the window stem (csrc/stem.cu): the implicit GEMM's K one temporal tap
  at a time, each tap's 147 columns in (dy, dx, c) order padded with zero
  weights to 152, a float32 flush every 32 columns; float frames in
  3xTF32, the planar entry's integer pixels (exact in TF32) in two passes,
  x w_lo + x w_hi; then the folded scale, bias, ReLU and the 3x3/2 pool;
* the band stem (csrc/stem_band.cu): the same products and K order, on
  blocks of 8 pooled columns x 7 frames walking the pairs of conv rows
  through a 10-row ring (6 new rows a pair), the carried row max of the
  last pair, and runs of pooled rows that start one pair early;
* the encoders' attention core (csrc/encoder.cuh): a split QKV product's
  partials summed in slice order, then the bias; segments of up to 64
  rows packed whole into 64-row tiles with -inf across segments, the
  tile's two 32-key halves on their own softmax, merged in order; longer
  ones streamed in 64-key tiles whose four 16-key quarters run their own
  online softmax and merge in order; the -1e9 fill, S with a float32 flush
  every 32 columns, each 32 keys' P V from zero.

A TF32 product is exact in float32, so float32 matmuls of the split
operands stand in for the tensor cores (tests/test_torch_gemm.py).

Tolerances: abs 1e-5 against float32 references at the same inputs (the
3xTF32 products keep float32 accuracy: ~1e-6 here, where one TF32 pass is
~1e-3 off); block 2 against the Pallas kernel interpreted at atol = rtol =
1e-4, the JAX conv2 test's own bar (tests/test_conv2_pallas.py:63), as
tests/test_torch_planar.py holds the plain twin; the stem against the
Pallas kernel interpreted at 2e-5, the JAX planar stem test's bar, as
tests/test_torch_planar.py holds the stem twins (the band stem against
the band kernel); the attention sublayer against `_attn_sublayer`
interpreted at 2e-5, the JAX suite's own bar for its path equalities
(tests/test_fused_engine.py:77), as tests/test_torch_kernels.py holds the
sublayer twins."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jegal_tpu.ops.pallas import conv2 as JC2
from jegal_tpu.ops.pallas import flash_attention as JFA
from jegal_tpu.ops.pallas import fused_layer as JF
from jegal_tpu.ops.pallas import stem as JS
from jegal_torch.convert import tree_to_torch
from jegal_torch.core.layers import ref_layer_norm, std_layer_norm
from jegal_torch.ops.kernels import conv2 as TC2
from jegal_torch.ops.kernels import flash_attention as FA
from jegal_torch.ops.kernels import fused_layer as TFL
from jegal_torch.ops.kernels import gemm_plan as GP
from jegal_torch.ops.kernels import stem as TS
from jegal_torch.ops.video import s2d_repack, s2d_unpack
from test_torch_gemm import _tf32
from torch_threads import few_torch_threads  # noqa: F401

ATOL = 1e-5
KT, KH = 32, 16          # keys a ring stage, keys a warp of it
NEG_FILL = -1e9


def mm3(a, b):
    """a @ b in 3xTF32: lo*hi + hi*lo + hi*hi, small terms first."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm2(a, b):
    """a @ b in two TF32 passes, a*lo + a*hi: float32 accuracy for an `a`
    exact in TF32 (integers 0..255), one pass's error for any other."""
    a, b_hi = _tf32(a), _tf32(b)
    return a @ _tf32(b - b_hi) + a @ b_hi


def flash_emulated(q, k, v, mask):
    """Kernel 6's schedule on (B, H, T, D) float32 tensors and a (B, T)
    key mask or None. Query rows are independent, so all of them run at
    once; the key tiles, halves, flushes and merge are the kernel's."""
    b, h, t, d = q.shape
    qs = q * torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    halves = []
    for half in (0, 1):
        m = torch.full((b, h, t), 2 * NEG_FILL)
        l = torch.zeros(b, h, t)
        o = torch.zeros(b, h, t, d)
        for k0 in range(half * KH, t, KT):
            keys = torch.arange(k0, k0 + KH)
            live = keys < t
            at = keys.clamp(max=t - 1)
            kt = k[:, :, at] * live[:, None]       # zero-filled past T
            vt = v[:, :, at] * live[:, None]
            s = torch.zeros(b, h, t, KH)
            for c0 in range(0, d, 32):             # a float32 flush each 32
                s = s + mm3(qs[..., c0:c0 + 32],
                            kt[..., c0:c0 + 32].transpose(-1, -2))
            if mask is not None:
                filled = (mask[:, at] == 0)[:, None, None, :]
                s = torch.where(filled, torch.tensor(NEG_FILL), s)
            s = torch.where(live, s, torch.tensor(-math.inf))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + mm3(p, vt)
            m = m_new
        halves.append((m, l, o))
    (m0, l0, o0), (m1, l1, o1) = halves
    m_all = torch.maximum(m0, m1)
    c0, c1 = torch.exp(m0 - m_all), torch.exp(m1 - m_all)
    return (o0 * c0[..., None] + o1 * c1[..., None]) \
        / (l0 * c0 + l1 * c1)[..., None]


def _qkvm(seed, b, h, t, d):
    """q, k, v (B, H, T, D) and a (B, T) key mask: a pad tail in every
    batch row and, in the last, every key masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, t), np.float32)
    mask[:, t - t // 4:] = 0.0
    mask[-1] = 0.0
    return q, k, v, mask


@pytest.mark.parametrize("t", [16, 128, 256])
@pytest.mark.parametrize("d", [64, 96])
def test_flash_schedule_matches_pallas_kernel(t, d):
    q, k, v, mask = _qkvm(t + d, 2, 2, t, d)
    want = np.asarray(JFA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        128, 128, True))
    got = flash_emulated(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the fully masked row averages V uniformly over its T keys
    np.testing.assert_allclose(got[-1].numpy(),
                               np.broadcast_to(v[-1].mean(1, keepdims=True),
                                               v[-1].shape), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("t", [5, 100])
@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("masked", [True, False])
def test_flash_schedule_matches_plain_twin_at_ragged_t(t, d, masked):
    """T that no JAX block divides: under one tile (5) and a ragged last
    tile (100), where one key half of a tile lies wholly past T."""
    q, k, v, mask = (torch.from_numpy(a) for a in _qkvm(3 * t + d, 2, 3, t,
                                                        d))
    if not masked:
        mask = None
    torch.testing.assert_close(flash_emulated(q, k, v, mask),
                               FA.flash_attention_plain(q, k, v, mask),
                               rtol=0, atol=ATOL)


def conv2_emulated(x, w, scale, bias):
    """Kernel 7's schedule: x (T, J, Wp, 64) -> (T, J2, W2, 128)."""
    t, n_j, w_pool, c = x.shape
    _, j2, w2, n = TC2.out_shape(t, n_j, w_pool)
    # im2col in (kh, kw, c) order: the rows the kernel gathers stage by stage
    a = torch.cat([x[:, kh:kh + 2 * j2 - 1:2, kw:kw + 2 * w2 - 1:2]
                   for kh in range(5) for kw in range(5)], dim=-1)
    a = a.reshape(-1, 25 * c)
    wk = w.reshape(25 * c, n)
    acc = torch.zeros(a.shape[0], n)
    for k0 in range(0, 25 * c, 32):
        acc = acc + mm3(a[:, k0:k0 + 32], wk[k0:k0 + 32])
    return torch.relu(acc * scale + bias).reshape(t, j2, w2, n)


@pytest.mark.parametrize("t,n_j,w_pool", [(3, 11, 14), (2, 9, 16)])
def test_conv2_schedule_matches_plain_twin(t, n_j, w_pool):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((t, n_j, w_pool, 64), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 5, 64, 128),
                                             dtype=np.float32) * 0.03)
    scale = torch.from_numpy(rng.random(128, dtype=np.float32) + 0.5)
    bias = torch.from_numpy(rng.standard_normal(128, dtype=np.float32) * 0.1)
    got = conv2_emulated(x, w, scale, bias)
    assert tuple(got.shape) == TC2.out_shape(t, n_j, w_pool)
    torch.testing.assert_close(got, TC2.conv2_bn_relu_plain(x, w, scale,
                                                            bias),
                               rtol=0, atol=ATOL)


def test_conv2_schedule_matches_pallas_kernel():
    """Against mgrid_conv2_fused interpreted, on a block-2 tree with
    randomized BatchNorm statistics; the port's dense input is the
    m-grid's even lanes (as tests/test_torch_planar.py builds it)."""
    t, n_j, w_pool = 3, 11, 14
    rng = np.random.default_rng(12)
    blk2 = {"conv": {"kernel": rng.standard_normal((1, 5, 5, 64, 128),
                                                   dtype=np.float32) * 0.03,
                     "bias": rng.standard_normal(128, dtype=np.float32)
                     * 0.1},
            "bn": {"scale": rng.random(128, dtype=np.float32) + 0.5,
                   "bias": rng.standard_normal(128, dtype=np.float32) * 0.1,
                   "mean": rng.standard_normal(128, dtype=np.float32) * 0.1,
                   "var": rng.random(128, dtype=np.float32) + 0.5}}
    dense = rng.random((t, n_j, w_pool, 64), dtype=np.float32)
    m = np.zeros((t, n_j, 64, JS.SLOT), np.float32)
    m[..., 0:2 * w_pool:2] = dense.transpose(0, 1, 3, 2)
    want = np.asarray(JC2.mgrid_conv2_fused(
        jnp.asarray(m), *JC2.conv2_kernel_params(blk2), w_pool,
        interpret=True))
    ops = TC2.conv2_kernel_params(tree_to_torch(blk2))
    got = conv2_emulated(torch.from_numpy(dense), *ops)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


STEM_TAPS, STEM_KP, STEM_FLUSH = 147, 152, 32


def stem_emulated(frames, w, scale, bias, exact=False):
    """Kernel 1's schedule: frames (T4, H, W, 3), w (5, 7, 7, 3, 64) ->
    (T4 - 4, J, W_pool, 64). Conv positions are independent, so all of
    them run at once; the K order, padding and flushes are the kernel's.
    exact: the pixels are exact in TF32 (the planar entry's integers)."""
    t4, h, wd, _ = frames.shape
    hc, wc = (h - 7) // 3 + 1, (wd - 7) // 3 + 1
    mm = mm2 if exact else mm3
    acc = torch.zeros((t4 - 4) * hc * wc, 64)
    for dt in range(5):
        # the tap's patch columns in (dy, dx, c) order, padded to 152
        a = torch.cat([frames[dt:dt + t4 - 4, dy:dy + 3 * hc - 2:3,
                              dx:dx + 3 * wc - 2:3]
                       for dy in range(7) for dx in range(7)], dim=-1)
        a = torch.cat([a.reshape(-1, STEM_TAPS),
                       torch.zeros(a.numel() // STEM_TAPS,
                                   STEM_KP - STEM_TAPS)], dim=1)
        wk = torch.cat([w[dt].reshape(STEM_TAPS, 64),
                        torch.zeros(STEM_KP - STEM_TAPS, 64)])
        for k0 in range(0, STEM_KP, STEM_FLUSH):
            acc = acc + mm(a[:, k0:k0 + STEM_FLUSH], wk[k0:k0 + STEM_FLUSH])
    y = torch.relu(acc * scale + bias).reshape(t4 - 4, hc, wc, 64)
    y = torch.nn.functional.max_pool2d(y.permute(0, 3, 1, 2), 3, 2)
    return y.permute(0, 2, 3, 1)


def _stem_ops(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((5, 7, 7, 3, 64),
                                                 dtype=np.float32) * 0.05),
            torch.from_numpy(rng.random(64, dtype=np.float32) + 0.5),
            torch.from_numpy(rng.standard_normal(64, dtype=np.float32) * 0.1))


@pytest.mark.parametrize("shape", [(7, 30, 45, 3), (6, 61, 110, 3)])
def test_stem_schedule_matches_plain_twin(shape):
    """Float frames in [0, 1) of ragged size, three passes."""
    frames = torch.from_numpy(np.random.default_rng(13).random(
        shape, dtype=np.float32))
    ops = _stem_ops(14)
    got = stem_emulated(frames, *ops)
    assert tuple(got.shape) == TS.pooled_shape(*shape[:3])
    torch.testing.assert_close(got, TS.stem_pool_plain(frames, *ops),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(7, 30, 45, 3), (6, 63, 111, 3)])
def test_stem_planar_schedule_matches_plain_twin(shape):
    """The planar entry's two passes on integer pixels, with chin rows
    masked, against the planar twin; the float three-pass schedule on the
    same pixels / 255 agrees."""
    rng = np.random.default_rng(15)
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    cut = rng.integers(0, shape[1] // 2, shape[0])
    planar = torch.from_numpy(s2d_repack(u8, cut))
    ops = _stem_ops(16)
    pixels = s2d_unpack(planar).to(torch.float32)
    got = stem_emulated(pixels, ops[0] / 255.0, *ops[1:], exact=True)
    torch.testing.assert_close(got, TS.stem_pool_planar_plain(planar, *ops),
                               rtol=0, atol=ATOL)
    torch.testing.assert_close(got, stem_emulated(pixels / 255.0, *ops),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(13, 45, 48, 3), (9, 54, 96, 3)])
def test_stem_schedule_matches_pallas_kernel(shape):
    """Against stem_mgrid_x interpreted (the window kernel), on a block-1
    tree with randomized BatchNorm statistics, as
    tests/test_torch_planar.py drives it."""
    t4, h, w, _ = shape
    rng = np.random.default_rng(17)
    blk = {"conv": {"kernel": rng.standard_normal((5, 7, 7, 3, 64),
                                                  dtype=np.float32) * 0.05,
                    "bias": rng.standard_normal(64, dtype=np.float32) * 0.1},
           "bn": {"scale": rng.random(64, dtype=np.float32) + 0.5,
                  "bias": rng.standard_normal(64, dtype=np.float32) * 0.1,
                  "mean": rng.standard_normal(64, dtype=np.float32) * 0.1,
                  "var": rng.random(64, dtype=np.float32) + 0.5}}
    frames = rng.random(shape, dtype=np.float32)
    m = JS.stem_mgrid_x(JS.s2d_lanes(jnp.asarray(frames)),
                        *JS.stem_kernel_params(blk), w_valid=w // 3,
                        interpret=True)
    got = stem_emulated(torch.from_numpy(frames),
                        *TS.stem_kernel_params(tree_to_torch(blk)))
    w_pool = got.shape[2]
    want = np.asarray(m)[..., 0:2 * w_pool:2].transpose(0, 1, 3, 2)
    assert tuple(got.shape) == want.shape == TS.pooled_shape(t4, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)



BAND_PI, BAND_F, BAND_RING = 8, 7, 10   # pooled cols, frames, ring rows


def band_emulated(frames, w, scale, bias, exact=False, run=None):
    """Kernel 2's schedule: frames (T4, H, W, 3), w (5, 7, 7, 3, 64) ->
    (T4 - 4, J, W_pool, 64). Blocks of 8 pooled columns x 7 output frames
    each walk runs of `run` pooled rows (all J by default) down the pairs of
    conv rows: a 10-row ring a frame (row y in slot y % 10; rows past the
    clip or the frame zero) starts with the run's first 10 rows and takes 6
    new rows after each pair; pair m reads slots (6m + 3r + dy) % 10 for its
    row 2m + r; each tap's 147 columns in (dy, dx, c) order padded to 152,
    a float32 flush every 32; BN + ReLU; pooled row m - 1 from the carried
    row max of pair m - 1, conv row 2m and the 3-column window; the carry
    becomes pair m's row max; the run's first pair only makes the carry.
    exact: the pixels are exact in TF32 (the planar entry's integers)."""
    t4, h, wd, _ = frames.shape
    t_out, n_j, wp, _ = TS.pooled_shape(t4, h, wd)
    run = n_j if run is None else run
    mm = mm2 if exact else mm3
    cc, span = 2 * BAND_PI + 1, 6 * BAND_PI + 7     # conv, input columns
    wk = [torch.cat([w[dt].reshape(STEM_TAPS, 64),
                     torch.zeros(STEM_KP - STEM_TAPS, 64)]) for dt in range(5)]
    out = torch.full((t_out, n_j, wp, 64), float("nan"))
    for i0 in range(0, wp, BAND_PI):
        x0 = 6 * i0
        for t0 in range(0, t_out, BAND_F):
            # the block's input frames and columns, zero past the clip
            nf = min(BAND_F + 4, t4 - t0)
            nx = min(span, wd - x0)
            src = torch.zeros(BAND_F + 4, h, span, 3)
            src[:nf, :, :nx] = frames[t0:t0 + nf, :, x0:x0 + nx]
            for j_a in range(0, n_j, run):
                j_b = min(n_j, j_a + run)
                ring = torch.zeros(BAND_F + 4, BAND_RING, span, 3)

                def stage(y0, n):
                    for y in range(y0, min(y0 + n, h)):
                        ring[:, y % BAND_RING] = src[:, y]

                stage(6 * j_a, BAND_RING)
                carry = None
                for m in range(j_a, j_b + 1):
                    sums = [torch.zeros(BAND_F * cc, 64) for _ in (0, 1)]
                    for dt in range(5):
                        fr = ring[dt:dt + BAND_F]
                        for r in (0, 1):
                            slots = [(6 * m + 3 * r + dy) % BAND_RING
                                     for dy in range(7)]
                            x = fr[:, slots]            # (F, dy, span, 3)
                            a = torch.stack(
                                [x[:, :, dx:dx + 3 * cc - 2:3]
                                 for dx in range(7)], dim=3)
                            # (F, dy, col, dx, c) -> (F col, dy dx c)
                            a = a.permute(0, 2, 1, 3, 4).reshape(
                                BAND_F * cc, STEM_TAPS)
                            a = torch.cat([a, torch.zeros(
                                a.shape[0], STEM_KP - STEM_TAPS)], dim=1)
                            for k0 in range(0, STEM_KP, STEM_FLUSH):
                                sums[r] = sums[r] + mm(
                                    a[:, k0:k0 + STEM_FLUSH],
                                    wk[dt][k0:k0 + STEM_FLUSH])
                    y0, y1 = (torch.relu(v * scale + bias).reshape(
                        BAND_F, cc, 64) for v in sums)
                    if m > j_a:
                        v = torch.maximum(carry, y0)
                        pooled = torch.maximum(torch.maximum(
                            v[:, 0:cc - 2:2], v[:, 1:cc - 1:2]), v[:, 2:cc:2])
                        nt = min(BAND_F, t_out - t0)
                        ni = min(BAND_PI, wp - i0)
                        out[t0:t0 + nt, m - 1, i0:i0 + ni] = pooled[:nt, :ni]
                    carry = torch.maximum(y0, y1)
                    if m < j_b:
                        stage(6 * m + BAND_RING, 6)
    return out


@pytest.mark.parametrize("shape,run", [((13, 30, 111, 3), None),
                                       ((13, 30, 111, 3), 2),
                                       ((5, 13, 60, 3), None)])
def test_band_schedule_matches_plain_twin(shape, run):
    """Float frames in [0, 1) in three passes, over ragged strips (17
    pooled columns: 8, 8, 1) and frame groups (9 output frames: 7, 2), in
    one run or runs of 2 pooled rows, and at J = 1 with t_in = 5."""
    frames = torch.from_numpy(np.random.default_rng(23).random(
        shape, dtype=np.float32))
    ops = _stem_ops(24)
    got = band_emulated(frames, *ops, run=run)
    assert tuple(got.shape) == TS.pooled_shape(*shape[:3])
    torch.testing.assert_close(got, TS.stem_pool_plain(frames, *ops),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(12, 30, 111, 3), (5, 15, 57, 3)])
def test_band_planar_schedule_matches_plain_twin(shape):
    """The planar entry's two passes on integer pixels, with chin rows
    masked, against the planar twin, over ragged strips and at J = 1; the
    float three-pass schedule on the same pixels / 255 agrees."""
    rng = np.random.default_rng(25)
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    cut = rng.integers(0, shape[1] // 2, shape[0])
    planar = torch.from_numpy(s2d_repack(u8, cut))
    ops = _stem_ops(26)
    pixels = s2d_unpack(planar).to(torch.float32)
    got = band_emulated(pixels, ops[0] / 255.0, *ops[1:], exact=True)
    torch.testing.assert_close(got, TS.stem_pool_planar_plain(planar, *ops),
                               rtol=0, atol=ATOL)
    torch.testing.assert_close(got, band_emulated(pixels / 255.0, *ops),
                               rtol=0, atol=ATOL)


def test_band_schedule_matches_pallas_band_kernel():
    """Against stem_mgrid_x(impl="band") interpreted, on a block-1 tree
    with randomized BatchNorm statistics, over a ragged strip."""
    t4, h, w = 9, 45, 111
    rng = np.random.default_rng(27)
    blk = {"conv": {"kernel": rng.standard_normal((5, 7, 7, 3, 64),
                                                  dtype=np.float32) * 0.05,
                    "bias": rng.standard_normal(64, dtype=np.float32) * 0.1},
           "bn": {"scale": rng.random(64, dtype=np.float32) + 0.5,
                  "bias": rng.standard_normal(64, dtype=np.float32) * 0.1,
                  "mean": rng.standard_normal(64, dtype=np.float32) * 0.1,
                  "var": rng.random(64, dtype=np.float32) + 0.5}}
    frames = rng.random((t4, h, w, 3), dtype=np.float32)
    m = JS.stem_mgrid_x(JS.s2d_lanes(jnp.asarray(frames)),
                        *JS.stem_kernel_params(blk), w_valid=w // 3,
                        interpret=True, impl="band")
    got = band_emulated(torch.from_numpy(frames),
                        *TS.stem_kernel_params(tree_to_torch(blk)))
    w_pool = got.shape[2]
    want = np.asarray(m)[..., 0:2 * w_pool:2].transpose(0, 1, 3, 2)
    assert tuple(got.shape) == want.shape == TS.pooled_shape(t4, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)

AC_KT, AC_QUARTER = 64, 16   # keys a tile; keys a warp of a streamed tile


def sum_partials(parts, bias):
    """A split product's partials summed as the attention core loads them:
    slice 0, then 1, ..., then the bias (row_epilogue_kernel's order)."""
    v = parts[0]
    for p in parts[1:]:
        v = v + p
    return v + bias


def _scores(qs, kt, dk):
    """(q * scale) K^T in 3xTF32, a float32 flush every 32 columns of dk."""
    s = 0
    for c0 in range(0, dk, 32):
        s = s + mm3(qs[..., c0:c0 + 32], kt[..., c0:c0 + 32].transpose(-1, -2))
    return s


def attention_core_emulated(parts, bias, seg, heads, kmask=None):
    """The attention core's schedule (csrc/encoder.cuh) on the QKV product's
    partials (a list of (R, 3d), one when unsplit) and its bias -> (R, d).
    Query rows are independent, so all of a tile's run at once; the tiles,
    flushes, fills, key quarters and merge are the kernel's."""
    qkv = sum_partials(parts, bias)
    r, d = qkv.shape[0], qkv.shape[1] // 3
    dk = d // heads
    scale = torch.tensor(1.0 / math.sqrt(dk), dtype=torch.float32)
    q, k, v = (t.reshape(r, heads, dk).transpose(0, 1)   # (heads, R, dk)
               for t in qkv.split(d, dim=1))
    valid = torch.ones(r) if kmask is None else kmask
    fill, ninf = torch.tensor(NEG_FILL), torch.tensor(-math.inf)
    if seg <= AC_KT:
        # packed: 64-row tiles of 64 // seg whole segments, zero-filled past
        # R; keys are the tile's rows, -inf across segments
        per = AC_KT // seg
        tiles = -(-(r // seg) // per)
        i = torch.arange(AC_KT)
        rows = torch.arange(tiles)[:, None] * per * seg + i        # (tiles, 64)
        live = (i < per * seg) & (rows < r)
        at = rows.clamp(max=r - 1)
        qt, kt, vt = (t[:, at] * live[..., None] for t in (q, k, v))
        s = _scores(qt * scale, kt, dk)                   # (heads, tiles, 64, 64)
        s = torch.where((valid[at] * live == 0)[:, None, :], fill, s)
        s = torch.where((i[:, None] // seg) == (i[None, :] // seg), s, ninf)
        halves = []      # each half of the keys on its own softmax
        for k0 in (0, AC_KT // 2):
            sh = s[..., k0:k0 + AC_KT // 2]
            m = torch.maximum(torch.tensor(2 * NEG_FILL), sh.amax(-1))
            p = torch.exp(sh - m[..., None])
            halves.append((m, p.sum(-1),
                           mm3(p, vt[..., k0:k0 + AC_KT // 2, :])))
        out = torch.zeros(heads, r, dk)
        out[:, rows[live]] = _merge(halves)[:, live]
    else:
        # streamed: keys in tiles of 64, each tile's 4 quarters of 16 keys
        # on their own online softmax, merged in quarter order
        n, nt = r // seg, -(-seg // AC_KT)
        pad = nt * AC_KT - seg

        def keyed(t):    # (..., R, c) -> (..., n, nt 64, c), zero-filled
            t = t.reshape(*t.shape[:-2], n, seg, t.shape[-1])
            return torch.nn.functional.pad(t, (0, 0, 0, pad))

        qs = q.reshape(heads, n, seg, dk) * scale
        kp, vp = keyed(k), keyed(v)
        mp = keyed(valid.reshape(r, 1)).squeeze(-1)          # (n, nt 64)
        livep = torch.arange(nt * AC_KT) < seg
        quarters = []
        for kq in range(AC_KT // AC_QUARTER):
            m = torch.full((heads, n, seg), 2 * NEG_FILL)
            l = torch.zeros(heads, n, seg)
            o = torch.zeros(heads, n, seg, dk)
            for k0 in range(kq * AC_QUARTER, nt * AC_KT, AC_KT):
                keys = slice(k0, k0 + AC_QUARTER)
                s = _scores(qs, kp[:, :, keys], dk)
                s = torch.where((mp[:, keys] == 0)[None, :, None], fill, s)
                s = torch.where(livep[keys], s, ninf)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                o = o * corr[..., None] + mm3(p, vp[:, :, keys])
                m = m_new
            quarters.append((m, l, o))
        out = _merge(quarters).reshape(heads, r, dk)
    return out.transpose(0, 1).reshape(r, d)


def _merge(slices):
    """The core's merge of (max, sum, O) over key slices, in key order."""
    m_all = torch.stack([m for m, _, _ in slices]).amax(0)
    o, l = 0, 0
    for m, ls, os_ in slices:
        c = torch.exp(m - m_all)
        o, l = o + os_ * c[..., None], l + ls * c
    return o / l[..., None]


def staged_product(a, w, splits=1):
    """The shared GEMM's partials of a @ w (csrc/gemm.cuh): one a K slice
    (gemm_plan.k_slices), each a float32 sum of 32-deep 3xTF32 stages."""
    parts = []
    for k0, k1 in GP.k_slices(a.shape[1], splits):
        acc = torch.zeros(a.shape[0], w.shape[1])
        for s0 in range(k0, k1, 32):
            acc = acc + mm3(a[:, s0:min(s0 + 32, k1)], w[s0:min(s0 + 32, k1)])
        parts.append(acc)
    return parts


# (seg, segments, d, heads, masked, QKV splits): packed with one row a
# segment, 7 windows of 21 (a ragged last tile of one window), head width
# 96, a whole 64-row segment; streamed at 65 (a second key tile of one
# key), 128 (the gesture encoder) and 300
CORE_CASES = [(1, 5, 128, 2, False, 1), (21, 7, 128, 2, True, 3),
              (33, 3, 768, 8, True, 4), (64, 2, 128, 2, True, 1),
              (65, 2, 128, 2, True, 2), (128, 2, 128, 2, True, 8),
              (300, 1, 128, 2, False, 1)]


def _key_mask(rng, n, seg, masked):
    """(R,) key validity or None: ~40 % masked, every segment keeping its
    first key (a segment with every key masked is another case)."""
    if not masked:
        return None
    km = (rng.random((n, seg)) > 0.4).astype(np.float32)
    km[:, 0] = 1.0
    return km.reshape(-1)


def _core_inputs(seg, n, d, masked, splits, full=None):
    """QKV partials, bias and key mask (segment `full` wholly masked). The
    partials of a product's K slices sum to unit-scale rows, as q, k and v
    are in the flash tests."""
    rng = np.random.default_rng(seg * 10 + n)
    parts = [torch.from_numpy(rng.standard_normal((n * seg, 3 * d),
                                                  dtype=np.float32)
                              / np.float32(math.sqrt(splits)))
             for _ in range(splits)]
    bias = torch.from_numpy(rng.standard_normal(3 * d, dtype=np.float32)
                            * np.float32(0.1))
    km = _key_mask(rng, n, seg, masked)
    if full is not None:
        km[full * seg:(full + 1) * seg] = 0.0
    return parts, bias, None if km is None else torch.from_numpy(km)


@pytest.mark.parametrize("seg,n,d,heads,masked,splits,full",
                         [c + (None,) for c in CORE_CASES]
                         + [(21, 4, 128, 2, True, 2, 1),
                            (128, 2, 128, 2, True, 1, 0)])
def test_attention_core_schedule_matches_plain_twin(seg, n, d, heads, masked,
                                                    splits, full):
    """The core on split partials against the twin's attention on their
    sum. A segment with every key masked (`full`) averages its own keys
    in both (the JAX kernel's -1e9 across segments would average all of
    its block's keys instead)."""
    parts, bias, km = _core_inputs(seg, n, d, masked, splits, full)
    got = attention_core_emulated(parts, bias, seg, heads, km)
    want = TFL.attention_plain(sum_partials(parts, bias), seg, heads, km)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    if full is not None:
        v = sum_partials(parts, bias)[full * seg:(full + 1) * seg, 2 * d:]
        torch.testing.assert_close(
            got[full * seg:(full + 1) * seg],
            v.mean(0, keepdim=True).expand(seg, d), rtol=0, atol=ATOL)


def _pallas_attn_sublayer(x, layer, seg, heads, prenorm, kind, kmask):
    """JAX's _attn_sublayer interpreted, its blocks, segment matrix and key
    columns built as fused_encoder_stack builds them."""
    r = x.shape[0]
    br = JF.block_rows(seg)
    if r < br and r % 8 == 0:
        br = r
    rp = -(-r // br) * br
    rows = np.arange(br)
    segm = jnp.asarray((rows[:, None] // seg) == (rows[None, :] // seg),
                       jnp.float32)
    kc = np.ones(rp, np.float32) if kmask is None else np.pad(
        (kmask != 0).astype(np.float32), (0, rp - r), constant_values=1.0)
    out = JF._attn_sublayer(
        jnp.asarray(np.pad(x, ((0, rp - r), (0, 0)))), layer["attn"],
        layer["norm1"], segm, jnp.asarray(kc.reshape(rp // br, 1, br)),
        heads=heads, prenorm=prenorm, ln_kind=kind, br=br, interpret=True)
    return np.asarray(out)[:r]


@pytest.mark.parametrize("seg,n,d,heads,masked,splits", CORE_CASES)
@pytest.mark.parametrize("prenorm,kind", [(False, "std"), (True, "ref")])
def test_attention_sublayer_schedule_matches_pallas_kernel(
        seg, n, d, heads, masked, splits, prenorm, kind):
    """The whole attention sublayer as the card runs it -- the QKV product's
    split partials, the core, the output product, the LayerNorm -- with
    every product in 3xTF32 stages, against _attn_sublayer interpreted."""
    rng = np.random.default_rng(seg + 7 * n)

    def rn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    layer = {"attn": {name: {"kernel": rn(d, d, scale=d ** -0.5),
                             "bias": rn(d, scale=0.1)}
                      for name in ("q", "k", "v", "o")},
             "norm1": {"scale": 1 + rn(d, scale=0.1), "bias": rn(d, scale=0.1)}}
    x = rn(n * seg, d)
    km = _key_mask(rng, n, seg, masked)
    want = _pallas_attn_sublayer(x, layer, seg, heads, prenorm, kind, km)

    a = {k: torch.from_numpy(v["kernel"]) for k, v in layer["attn"].items()}
    b = {k: torch.from_numpy(v["bias"]) for k, v in layer["attn"].items()}
    g, be = (torch.from_numpy(layer["norm1"][k]) for k in ("scale", "bias"))
    xt = torch.from_numpy(x)
    ln = ref_layer_norm if kind == "ref" else std_layer_norm
    h = ln({"scale": g, "bias": be}, xt) if prenorm else xt
    wqkv = torch.cat([a["q"], a["k"], a["v"]], dim=1)
    bqkv = torch.cat([b["q"], b["k"], b["v"]])
    att = attention_core_emulated(staged_product(h, wqkv, splits), bqkv, seg,
                                  heads,
                                  None if km is None else torch.from_numpy(km))
    y = xt + (staged_product(att, a["o"])[0] + b["o"])
    got = y if prenorm else ln({"scale": g, "bias": be}, y)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
