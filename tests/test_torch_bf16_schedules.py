"""The arithmetic of the bf16 kernels 1b, 2b, 5b, 6b and 7b, emulated on the
CPU and held against their plain twins and the JAX Pallas kernels
interpreted on bf16 inputs. The kernels run only on the card
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
  the output rounded to bf16 once;
* the bf16 stem schedule that the window stem (csrc/stem.cu, kernel 1b)
  and the band stem (csrc/stem_band.cu, kernel 2b) share (csrc/stem.cuh),
  on both entries: each temporal tap's K in (dy, dx, c) order with each dy
  row's 21 columns padded to 24 and 168 padded to 176, exact bf16 products
  summed in float32 a flush group of 32 columns at a time (each group from
  zero, added to the float32 sum), taps in order; BN and ReLU in float32;
  the 3x3 / 2 max pool; one bf16 rounding. Held against the Pallas window
  kernel (`_stem_kernel`) and band kernel (`_stem_kernel_band`), each
  interpreted in bf16; and kernel 1b's addressing (its GEMM rows in
  column order, each tap's patch kept twice, the swizzled conv tile),
  which reads the schedule's columns and pools to its bits;
* the XLM-R stack in bf16 (csrc/encoder_stack.cu, kernel 5b): each
  product's K cut into gemm_plan.plan_bf16's slices on the H100's 132 SMs,
  each slice one float32 chain, the slices added in slice order by the
  last to finish, then bias, activation and residual, at `_stack_kernel`'s
  rounding sites.

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
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from jegal_tpu.ops.pallas import conv2 as JC2
from jegal_tpu.ops.pallas import flash_attention as JFA
from jegal_tpu.ops.pallas import fused_layer as JF
from jegal_tpu.ops.pallas import stem as JS
from jegal_torch.convert import tree_to_torch
from jegal_torch.ops.kernels import conv2 as TC2
from jegal_torch.ops.kernels import flash_attention as FA
from jegal_torch.ops.kernels import fused_layer as TF
from jegal_torch.ops.kernels import gemm_plan as GP
from jegal_torch.ops.kernels import stem as TS
from jegal_torch.ops.video import s2d_repack, s2d_unpack
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


# ---------------------------------------------------------------------------
# Kernels 1b and 2b: the bf16 stem schedule (window and band)
# ---------------------------------------------------------------------------

BAND_DY = 24        # K columns of a dy row: 21 taps, 3 zero
BAND_KP = 176       # 7 x 24, padded to k16 steps
BAND_FLUSH = 32     # K columns a float32 flush


def stem_columns(x, dt: int):
    """Tap dt's A rows of every conv position in the K layout of kernels
    1b and 2b: x (T4, H, W, 3) float32 -> (T4 - 4, hc, wc, 176), column
    24 dy + 3 dx + c the pixel (3 y + dy, 3 x + dx, c) of frame t + dt,
    zero at the padding."""
    t4, h, wd, _ = x.shape
    t_out = t4 - 4
    hc, wc = (h - 7) // 3 + 1, (wd - 7) // 3 + 1
    ys, xs = 3 * torch.arange(hc), 3 * torch.arange(wc)
    cols = torch.zeros(t_out, hc, wc, BAND_KP)
    for dy in range(7):
        rows = x[dt:dt + t_out][:, ys + dy]         # (t, hc, W, 3)
        for dx in range(7):
            k = BAND_DY * dy + 3 * dx
            cols[..., k:k + 3] = rows[:, :, xs + dx]
    return cols


def stem_bf16_sums(columns, w, scale, bias):
    """BN + ReLU of the float32 sums of kernels 1b and 2b: columns(dt) ->
    each conv position's K row (stem_columns' layout) -> float32 (t, hc,
    wc, 64), each flush group of 32 columns from zero, taps in order."""
    wf = w.float()
    acc = None
    for dt in range(5):                   # the taps in order
        cols = columns(dt)
        wk = torch.zeros(BAND_KP, 64)
        for dy in range(7):
            for dx in range(7):
                k = BAND_DY * dy + 3 * dx
                wk[k:k + 3] = wf[dt, dy, dx]
        a = cols.reshape(-1, BAND_KP)
        if acc is None:
            acc = torch.zeros(a.shape[0], 64)
        for k0 in range(0, BAND_KP, BAND_FLUSH):
            acc = acc + a[:, k0:k0 + BAND_FLUSH] @ wk[k0:k0 + BAND_FLUSH]
    return torch.relu(acc * scale + bias).reshape(*cols.shape[:3], 64)


def stem_bf16_emulated(frames, w, scale, bias):
    """The schedule of kernels 1b and 2b (each position's float32 sums are
    the same in both; they differ in which positions a block computes, and
    1b computes some twice): frames (T4, H, W, 3) holding bf16 values (the
    planar entry's raw pixels are exact in bf16), w (5, 7, 7, 3, 64) bf16
    (the planar entry's with /255 folded) -> bf16 (T4 - 4, J, W_pool,
    64)."""
    x = frames.float()
    y = stem_bf16_sums(lambda dt: stem_columns(x, dt), w, scale, bias)
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    return y.to(BF)


# Kernel 1b's tile and shared memory (csrc/stem.cu): a tap's 49 input rows
# of 168 elements, kept twice in a buffer, copy 1 (shifted by one element)
# WINDOW_COPY elements after copy 0
WINDOW_ROW = 168
WINDOW_COPY = 49 * WINDOW_ROW + 24


def window_rows(order: str = "column"):
    """Kernel 1b's GEMM rows: row m is conv position (m % 15, m // 15) of
    its tile (order "row": (m // 17, m % 17), for comparison); row 255
    pads, reads position (14, 15) and is not stored. -> (row, column,
    stored), each (256,)."""
    m = np.arange(256)
    r, col = (m % 15, m // 15) if order == "column" else (m // 17, m % 17)
    return np.where(m < 255, r, 14), np.where(m < 255, col, 15), m < 255


def window_offsets(order: str = "column"):
    """The element of a tap's buffer that kernel 1b reads for each (GEMM
    row, K column) (window_load): the position's window at 9 x in copy 0
    (x even) or at 9 x - 1 in copy 1 (x odd), then dy rows of 168 and the
    k8 group's 8 (q % 3); group 21 (dy 7, zero weights) reads row 6.
    -> (256, 176)."""
    r, col, _ = window_rows(order)
    xo = (3 * r * WINDOW_ROW + 9 * col
          + np.where(col % 2 == 1, WINDOW_COPY - 1, 0))
    k = np.arange(BAND_KP)
    q = k // 8
    dy = np.minimum(q // 3, 6)
    return torch.from_numpy(xo[:, None] + dy * WINDOW_ROW + 8 * (q % 3)
                            + k % 8)


def window_buffer(x, t: int, y0: int, x0: int):
    """A tap's buffer as kernel 1b stages and builds it: frame t's input
    rows y0..y0 + 48, 168 elements from column x0 each (zero past the
    frame), as copy 0 and copy 1 (each row shifted by one element, zero
    past it). -> (2 WINDOW_COPY,) float32."""
    _, h, wd, _ = x.shape
    flat = x[t].reshape(h, 3 * wd)
    rows = torch.zeros(49, WINDOW_ROW)
    n_y, n_e = min(h - y0, 49), min(3 * wd - 3 * x0, WINDOW_ROW)
    rows[:n_y, :n_e] = flat[y0:y0 + n_y, 3 * x0:3 * x0 + n_e]
    shifted = torch.zeros_like(rows)
    shifted[:, :-1] = rows[:, 1:]
    buf = torch.zeros(2 * WINDOW_COPY)
    buf[:49 * WINDOW_ROW] = rows.reshape(-1)
    buf[WINDOW_COPY:WINDOW_COPY + 49 * WINDOW_ROW] = shifted.reshape(-1)
    return buf


def window_bf16_emulated(frames, w, scale, bias, columns_out=None):
    """Kernel 1b's schedule through its addressing: each unit (tile, frame)
    reads its A rows from its taps' buffers at window_offsets, sums them
    as stem_bf16_sums does, and pools its conv tile through the kernel's
    swizzled bf16 tile (row p's 8-channel chunk c at chunk c ^ (p % 8)).
    Frames as stem_bf16_emulated's -> bf16 (T4 - 4, J, W_pool, 64).
    columns_out: a dict that receives each tap's columns as the units read
    them (every conv position the pool reads)."""
    x = frames.float()
    t4, h, wd, _ = x.shape
    t_out, n_j, w_pool, _ = TS.pooled_shape(t4, h, wd)
    hc, wc = (h - 7) // 3 + 1, (wd - 7) // 3 + 1
    strips, tiles = -(-w_pool // 8), -(-w_pool // 8) * -(-n_j // 7)
    r, col, stored = window_rows()
    off = window_offsets()
    units = [(7 * (tile // strips), 8 * (tile % strips), t)
             for tile in range(tiles) for t in range(t_out)]

    def columns(dt):
        cols = torch.zeros(t_out, hc, wc, BAND_KP)
        for j0, i0, t in units:
            cy, cx = 2 * j0 + r, 2 * i0 + col
            keep = stored & (cy < hc) & (cx < wc)
            a = window_buffer(x, t + dt, 6 * j0, 6 * i0)[off]
            cols[t, cy[keep], cx[keep]] = a[torch.from_numpy(keep)]
        if columns_out is not None:
            columns_out[dt] = cols
        return cols

    y = stem_bf16_sums(columns, w, scale, bias).to(BF)
    out = torch.zeros(t_out, n_j, w_pool, 64, dtype=BF)
    ch = np.arange(64)
    for j0, i0, t in units:
        tile = torch.zeros(255 * 64, dtype=BF)   # the conv tile
        cy, cx = 2 * j0 + r, 2 * i0 + col
        keep = stored & (cy < hc) & (cx < wc)
        p = 17 * r[keep] + col[keep]
        at = p[:, None] * 64 + ((ch // 8) ^ (p[:, None] % 8)) * 8 + ch % 8
        tile[torch.from_numpy(at)] = y[t, cy[keep], cx[keep]]
        for pj in range(min(7, n_j - j0)):
            for pi in range(min(8, w_pool - i0)):
                q = np.array([(2 * pj + a) * 17 + 2 * pi + b
                              for a in range(3) for b in range(3)])
                at = q[:, None] * 64 + ((ch // 8) ^ (q[:, None] % 8)) * 8 \
                    + ch % 8
                out[t, j0 + pj, i0 + pi] = tile[torch.from_numpy(at)] \
                    .float().amax(0).to(BF)
    return out


def _blk1(rng):
    """Block 1's tree with randomized BatchNorm statistics, float32."""
    return {"conv": {"kernel": rng.standard_normal((5, 7, 7, 3, 64),
                                                   dtype=np.float32) * 0.05,
                     "bias": rng.standard_normal(64, dtype=np.float32)
                     * 0.1},
            "bn": {"scale": rng.random(64, dtype=np.float32) + 0.5,
                   "bias": rng.standard_normal(64, dtype=np.float32) * 0.1,
                   "mean": rng.standard_normal(64, dtype=np.float32) * 0.1,
                   "var": rng.random(64, dtype=np.float32) + 0.5}}


def _blk1_ops(blk):
    """Block 1 in bf16 on both sides (the same values), folded in float32:
    the port's (weight, scale, bias) and the JAX package's."""
    ops = TS.stem_kernel_params(jax.tree.map(lambda a: a.to(BF),
                                             tree_to_torch(blk)))
    jops = JS.stem_kernel_params(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), blk))
    return ops, jops


def _mgrid_dense(m, w_pool):
    return np.asarray(m.astype(jnp.float32))[
        ..., 0:2 * w_pool:2].transpose(0, 1, 3, 2)


@pytest.mark.parametrize("t4,h,w", [(13, 45, 48), (5, 15, 57), (9, 30, 111)])
def test_band_bf16_schedule_matches_twin_float_entry(t4, h, w):
    """The float entry's schedule against the bf16 twin: t_in 5 and J 1,
    ragged strips and tiles; the /255 pixels rounded to bf16 as the mask
    rounds them."""
    rng = np.random.default_rng(31 + t4)
    u8 = rng.integers(0, 256, (t4, h, w, 3), dtype=np.uint8)
    frames = (torch.from_numpy(u8).float() / 255.0).to(BF)
    ops, _ = _blk1_ops(_blk1(rng))
    got = stem_bf16_emulated(frames, *ops)
    assert tuple(got.shape) == TS.pooled_shape(t4, h, w)
    bars.check_kernel_bar(got, TS.stem_pool_plain(frames, *ops),
                          f"bf16 stem schedule vs twin, {(t4, h, w)}")


@pytest.mark.parametrize("impl", ["band", "window"])
def test_band_bf16_schedule_matches_pallas_band_kernel(impl):
    """The float entry's schedule and twin against stem_mgrid_x(impl=impl)
    interpreted on the same bf16 frames and block: the band kernel
    (`_stem_kernel_band`, which kernel 2b replaces) and the window kernel
    (`_stem_kernel`, which kernel 1b replaces)."""
    t4, h, w = 13, 45, 48
    rng = np.random.default_rng(37)
    frames = torch.from_numpy(rng.random((t4, h, w, 3), dtype=np.float32)
                              ).to(BF)
    ops, jops = _blk1_ops(_blk1(rng))
    got = stem_bf16_emulated(frames, *ops)
    m = JS.stem_mgrid_x(JS.s2d_lanes(_jax_bf16(frames)), *jops,
                        w_valid=w // 3, interpret=True, impl=impl)
    want = _mgrid_dense(m, got.shape[2])
    bars.check_kernel_bar(got, want,
                          f"bf16 stem schedule vs Pallas {impl} (float entry)")
    bars.check_kernel_bar(TS.stem_pool_plain(frames, *ops), want,
                          f"bf16 twin vs Pallas {impl} (float entry)")


@pytest.mark.parametrize("t4,h,w,impl", [
    pytest.param(12, 27, 48, "band", id="12-27-48"),
    pytest.param(5, 15, 57, "band", id="5-15-57"),
    pytest.param(12, 27, 48, "window", id="window-12-27-48")])
def test_band_bf16_schedule_planar_entry(t4, h, w, impl):
    """The planar entry's schedule (raw bytes, the folded bf16 weight, chin
    rows masked) against the planar twin, and at (12, 27, 48) against
    stem_mgrid_planar(impl=impl) interpreted in bf16, the band kernel and
    the window kernel; all-255 pixels too."""
    rng = np.random.default_rng(41 + w)
    ops, jops = _blk1_ops(_blk1(rng))
    for u8 in (rng.integers(0, 256, (t4, h, w, 3), dtype=np.uint8),
               np.full((t4, h, w, 3), 255, np.uint8)):
        cut = rng.integers(0, h // 2, t4).astype(np.int32)
        planar = torch.from_numpy(s2d_repack(u8, cut))
        pixels = s2d_unpack(planar).to(torch.float32)
        got = stem_bf16_emulated(pixels, TS.planar_weight(ops[0]), *ops[1:])
        bars.check_kernel_bar(got, TS.stem_pool_planar_plain(planar, *ops),
                              f"bf16 stem planar schedule vs twin, "
                              f"{(t4, h, w)}")
        if (t4, h, w) == (12, 27, 48):
            m = JS.stem_mgrid_planar(jnp.asarray(planar.numpy()), *jops,
                                     dtype=jnp.bfloat16, interpret=True,
                                     impl=impl)
            want = _mgrid_dense(m, got.shape[2])
            bars.check_kernel_bar(got, want, f"bf16 stem planar schedule "
                                  f"vs Pallas {impl}")
            bars.check_kernel_bar(TS.stem_pool_planar_plain(planar, *ops),
                                  want, f"bf16 planar twin vs Pallas {impl}")


def _real_columns():
    """The K columns of stem_columns' layout that hold a tap (not padding)."""
    k = torch.arange(BAND_KP)
    return (k % BAND_DY < 21) & (k < 7 * BAND_DY)


@pytest.mark.parametrize("t4,h,w", [(13, 45, 48), (5, 15, 57), (9, 30, 111),
                                    (6, 57, 150)])
def test_window_bf16_schedule_reads_the_stem_columns(t4, h, w):
    """Kernel 1b's addressing (its GEMM rows in column order, each tap's
    patch kept twice, copy 1 for an odd conv column, the padding group read
    from row 6, the swizzled conv tile) reads each conv position the pool
    reads as stem_columns lays it out, at every column that holds a tap,
    and pools to stem_bf16_emulated's bits: t_in 5 and J 1, ragged row
    tiles and strips, several strips and row tiles."""
    rng = np.random.default_rng(43 + w)
    u8 = rng.integers(0, 256, (t4, h, w, 3), dtype=np.uint8)
    frames = (torch.from_numpy(u8).float() / 255.0).to(BF)
    ops, _ = _blk1_ops(_blk1(rng))
    seen = {}
    got = window_bf16_emulated(frames, *ops, columns_out=seen)
    _, n_j, w_pool, _ = TS.pooled_shape(t4, h, w)
    real = _real_columns()
    for dt in range(5):
        want = stem_columns(frames.float(), dt)
        assert torch.equal(seen[dt][:, :2 * n_j + 1, :2 * w_pool + 1, real],
                           want[:, :2 * n_j + 1, :2 * w_pool + 1, real]), dt
    assert torch.equal(got, stem_bf16_emulated(frames, *ops))


def window_bank_conflicts(order: str) -> float:
    """The mean bank conflict (the most distinct 32-bit words one bank
    serves) of kernel 1b's A loads: each load is a warp's 8 GEMM rows (g,
    or g + 8) at lanes' columns 2t of one k8 group, 4 words a row."""
    words = window_offsets(order).numpy() // 2
    ways = []
    for rows in range(0, 256, 8):
        for q in range(BAND_KP // 8):
            w = np.unique(words[rows:rows + 8, 8 * q:8 * q + 8:2])
            ways.append(np.bincount(w % 32).max())
    return float(np.mean(ways))


def test_window_rows_spread_the_a_loads_over_the_banks():
    """Kernel 1b's rows in column order: the 8 rows of one A load are
    mostly one column's consecutive conv rows, whose windows (3 input rows
    of 84 words apart) fall in distinct banks; in row order two windows
    share a bank in most loads."""
    column, row = window_bank_conflicts("column"), window_bank_conflicts("row")
    assert column < 1.25 < 1.9 < row, (column, row)


def test_window_bf16_schedule_planar_entry():
    """Kernel 1b's schedule on the planar entry's raw bytes (the folded
    bf16 weight, chin rows masked): stem_bf16_emulated's bits, the planar
    twin's bars, and stem_mgrid_planar(impl="window") interpreted in
    bf16."""
    t4, h, w = 12, 27, 48
    rng = np.random.default_rng(47)
    ops, jops = _blk1_ops(_blk1(rng))
    u8 = rng.integers(0, 256, (t4, h, w, 3), dtype=np.uint8)
    planar = torch.from_numpy(s2d_repack(u8, rng.integers(0, h // 2, t4)
                                         .astype(np.int32)))
    pixels = s2d_unpack(planar).to(torch.float32)
    got = window_bf16_emulated(pixels, TS.planar_weight(ops[0]), *ops[1:])
    assert torch.equal(got, stem_bf16_emulated(
        pixels, TS.planar_weight(ops[0]), *ops[1:]))
    bars.check_kernel_bar(got, TS.stem_pool_planar_plain(planar, *ops),
                          "1b planar schedule vs twin")
    m = JS.stem_mgrid_planar(jnp.asarray(planar.numpy()), *jops,
                             dtype=jnp.bfloat16, interpret=True,
                             impl="window")
    bars.check_kernel_bar(got, _mgrid_dense(m, got.shape[2]),
                          "1b planar schedule vs Pallas window")


# ---------------------------------------------------------------------------
# Kernel 5b: the bf16 encoder stack
# ---------------------------------------------------------------------------

H100_SMS = 132


def _split_mm(a, w, splits):
    """a @ w (float32 holding bf16 values) as the stack kernel sums it: K in
    plan_bf16's slices, each one float32 chain, added in slice order."""
    out = None
    for k0, k1 in GP.k_slices(a.shape[1], splits, GP.BK_BF16):
        part = a[:, k0:k1] @ w[k0:k1]
        out = part if out is None else out + part
    return out


def stack_bf16_emulated(x, w, seg, heads, *, prenorm, ln_kind, activation,
                        kmask):
    """Kernel 5b's schedule on bf16 rows x (R, d) -> bf16 (R, d): the
    float32 residual stream r32 / y32 between sublayers and layers, bf16
    product inputs, each product split as the kernel plans it."""
    f32, bf = TF._f32, TF._bf
    r, d = x.shape
    dff = w["w1"].shape[-1]
    splits = [GP.plan_bf16(m, n, k, H100_SMS)[2]
              for m, n, k in TF.stack_products(r, d, dff)]
    r32 = f32(x)
    for l in range(w["wqkv"].shape[0]):
        wl = {k: f32(w[k][l]) for k in TF.STACK_KEYS}
        h = TF._ln_f32(r32, wl["g1"], wl["be1"], ln_kind) if prenorm else r32
        qkv = _split_mm(bf(h), wl["wqkv"], splits[0]) + wl["bqkv"]
        att = TF._attention_bf16(qkv, seg, heads, kmask)
        y32 = r32 + (_split_mm(att, wl["wo"], splits[1]) + wl["bo"])
        if not prenorm:
            y32 = TF._ln_f32(y32, wl["g1"], wl["be1"], ln_kind)
        h = TF._ln_f32(y32, wl["g2"], wl["be2"], ln_kind) if prenorm else y32
        h1 = _split_mm(bf(h), wl["w1"], splits[2]) + wl["b1"]
        h1 = bf(F.gelu(h1) if activation == "gelu" else torch.relu(h1))
        r32 = y32 + (_split_mm(h1, wl["w2"], splits[3]) + wl["b2"])
        if not prenorm:
            r32 = TF._ln_f32(r32, wl["g2"], wl["be2"], ln_kind)
    return r32.to(BF)


def _stack_layers(seed, n, d, dff):
    """n encoder layers (core/transformer layout), float32 numpy, with
    randomized biases and LayerNorm parameters."""
    rng = np.random.default_rng(seed)

    def lin(i, o):
        return {"kernel": (rng.standard_normal((i, o)) / np.sqrt(i))
                .astype(np.float32),
                "bias": (0.1 * rng.standard_normal(o)).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(
                    np.float32),
                "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}

    return [{"attn": {k: lin(d, d) for k in "qkvo"},
             "ff": {"w1": lin(d, dff), "w2": lin(dff, d)},
             "norm1": ln(), "norm2": ln()} for _ in range(n)]


@pytest.mark.parametrize("n_seg,prenorm", [(1, False), (4, False),
                                            (1, True)])
def test_stack_bf16_schedule_matches_twin_and_pallas_kernel(n_seg, prenorm):
    """XLM-R's widths (d 768, 12 heads, d_ff 3072), 2 layers, R 32 (a
    clip's text) and R 128 (an extract_many chunk), whose products split
    K as the H100's plans do, 32-token segments with a pad tail; against
    the bf16 twin and fused_encoder_stack's single kernel interpreted on
    the same bf16 values, at the stack's bar."""
    seg, d, heads, dff = 32, 768, 12, 3072
    r = n_seg * seg
    layers = _stack_layers(71 + n_seg, 2, d, dff)
    rng = np.random.default_rng(73 + n_seg)
    x = rng.standard_normal((r, d)).astype(np.float32)
    kmask = np.ones((n_seg, seg), np.float32)
    kmask[:, 21:] = 0.0
    kmask = kmask.reshape(-1)
    kind = "ref" if prenorm else "std"
    act = "relu" if prenorm else "gelu"
    w = TF.stacked_weights(jax.tree.map(lambda a: a.to(BF),
                                        tree_to_torch(layers)))
    xb = torch.from_numpy(x).to(BF)
    km = torch.from_numpy(kmask)
    assert GP.plan_bf16(r, d, dff, H100_SMS)[2] > 1     # W2 split
    got = stack_bf16_emulated(xb, w, seg, heads, prenorm=prenorm,
                              ln_kind=kind, activation=act, kmask=km)
    twin = TF.encoder_stack_plain_bf16(xb, w, seg, heads, prenorm=prenorm,
                                       ln_kind=kind, activation=act,
                                       kmask=km)
    bars.check_kernel_bar(got, twin, f"5b schedule vs twin, R {r}",
                          bars.STACK_MAX_ULPS)
    want = JF.fused_encoder_stack(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), layers),
        jnp.asarray(x, jnp.bfloat16), seg, heads, prenorm=prenorm,
        ln_kind=kind, kmask=jnp.asarray(kmask), interpret=True,
        activation=act, single_kernel=True)
    bars.check_kernel_bar(got, np.asarray(want.astype(jnp.float32)),
                          f"5b schedule vs Pallas, R {r}",
                          bars.STACK_MAX_ULPS)
