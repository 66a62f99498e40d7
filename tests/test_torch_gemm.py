"""The shared tensor-core GEMM of the encoder kernels (csrc/gemm.cuh) on the
CPU: its tile planners (ops/kernels/gemm_plan.py: the float32 product's and
the bf16 wgmma product's) at every product shape the main paths run and at
ragged shapes, the plans and workspace the kernel wrappers pass to the C
entries, and a torch emulation of its 3xTF32
arithmetic, which records why one TF32 pass is not enough. The kernel
itself runs only on the card (tests/test_torch_kernels_cuda.py).

    PYTHONPATH=. python tests/test_torch_gemm.py   # prints its errors

Tolerance of the emulation: the port's kernels are held to abs 1e-4 of
their float32 twins. 3xTF32 must stay within 1e-5 of a float64 product
(float32 alone is ~3e-6 off here); one TF32 pass (10 mantissa bits) must
exceed 1e-4, or the three passes would be wasted."""

import math

import numpy as np
import pytest
import torch

from jegal_torch.ops.kernels import fused_layer as FL
from jegal_torch.ops.kernels import gemm_plan as GP
from torch_threads import few_torch_threads  # noqa: F401

SMS = 132   # streaming multiprocessors of an H100 SXM
# (M, K, N) of the main paths' products: XLM-R at R = 32 (QKV, output, W1,
# W2; the text encoder's FFN shares W1 and W2), the gesture encoder's FFN
# at R = 128, the window head's W2 at R = 2688, XLM-R's W2 in a training
# step at R = 256
TABLE = [(32, 768, 2304), (32, 768, 768), (32, 768, 3072), (32, 3072, 768),
         (128, 512, 2048), (128, 2048, 512), (2688, 2048, 512),
         (256, 3072, 768)]
# the window head's other products, and ragged rows against K that is not
# a multiple of 128 (the C code takes K and N in multiples of 4)
MORE = [(2688, 512, 1536), (2688, 512, 512), (2688, 512, 2048)] + [
    (m, k, n) for m in (1, 21, 33, 2688)
    for k, n in ((100, 512), (1000, 768), (3000, 64))]


@pytest.mark.parametrize("m,k,n", TABLE + MORE)
def test_plan_invariants(m, k, n):
    bm, bn, splits = GP.plan(m, n, k, SMS)
    assert (bm, bn) in GP.TILES
    assert bm == min([t for t in GP.TILE_M if t >= m] or [128])
    # the K slices cover K exactly, each but the last whole BK steps
    slices = GP.k_slices(k, splits)
    assert len(slices) == splits
    assert slices[0][0] == 0 and slices[-1][1] == k
    for (a0, a1), (b0, _) in zip(slices, slices[1:]):
        assert a1 == b0 and (a1 - a0) % GP.BK == 0
    assert all(k1 > k0 for k0, k1 in slices)
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    steps = math.ceil(k / GP.BK)
    if tiles >= SMS:
        assert splits == 1               # the tiles already fill the card
    elif steps >= math.ceil(SMS / tiles):
        assert tiles * splits >= SMS     # one wave where splitting can
    else:
        assert splits == steps           # a slice per step: all it can
    assert GP.workspace_floats(m, n, splits) == (
        splits * m * n if splits > 1 else 0)


@pytest.mark.parametrize("m,k,n,want", [
    (32, 768, 2304, (32, 64, 4)),        # XLM-R QKV at R = 32
    (32, 3072, 768, (32, 64, 12)),       # XLM-R W2 at R = 32
    (128, 2048, 512, (128, 64, 22)),     # gesture W2
    (2688, 512, 2048, (128, 128, 1)),    # window-head W1: tiles fill it
    (2688, 2048, 512, (128, 64, 1)),     # window-head W2: at BN 64
])
def test_plan_values(m, k, n, want):
    assert GP.plan(m, n, k, SMS) == want


def test_plan_refuses_empty_products():
    with pytest.raises(ValueError, match="no plan"):
        GP.plan(0, 768, 768, SMS)
    with pytest.raises(ValueError, match="no plan"):
        GP.plan_bf16(0, 768, 768, SMS)


@pytest.mark.parametrize("m,k,n", TABLE + MORE + [(128, 512, 1536)])
def test_plan_bf16_invariants(m, k, n):
    """The bf16 wgmma product's plan (gemm_plan.plan_bf16): a built tile;
    tiles that cover M and N; K slices of whole 64-deep steps that cover
    K; a persistent grid of one block an SM (two of a BM 64 tile) that the
    units fill, or, when the tiles alone do not, slices of at most
    STEPS_BF16 steps where the units stay within one round of the blocks;
    and the workspace the wrappers allocate for it."""
    bm, bn, splits = GP.plan_bf16(m, n, k, SMS)
    assert (bm, bn) in GP.TILES_BF16
    assert bm == (128 if math.ceil(m / 128) * math.ceil(n / 64) >= SMS
                  else 64)
    rows, cols = math.ceil(m / bm), math.ceil(n / bn)
    assert (rows - 1) * bm < m <= rows * bm
    assert (cols - 1) * bn < n <= cols * bn
    slices = GP.k_slices(k, splits, GP.BK_BF16)
    assert len(slices) == splits
    assert slices[0][0] == 0 and slices[-1][1] == k
    for (a0, a1), (b0, _) in zip(slices, slices[1:]):
        assert a1 == b0 and (a1 - a0) % GP.BK_BF16 == 0
    assert all(k1 > k0 for k0, k1 in slices)
    tiles, steps = rows * cols, math.ceil(k / GP.BK_BF16)
    slots = SMS * GP.blocks_per_sm_bf16(bm)
    assert GP.blocks_per_sm_bf16(bm) == (2 if bm == 64 else 1)
    if tiles >= slots:
        assert splits == 1                 # the grid: `slots` blocks, each
    else:                                  # walking its tiles in turn
        want = max(1, min(math.ceil(steps / GP.STEPS_BF16), slots // tiles))
        assert tiles * splits <= slots
        assert math.ceil(steps / splits) == math.ceil(steps / want)
        assert splits == 1 or math.ceil(steps / splits) <= GP.STEPS_BF16 \
            or splits == slots // tiles
    for ln in (False, True):
        floats, counters = GP.workspace_bf16(m, n, (bm, bn, splits), ln)
        want_f = splits * m * n if splits > 1 else 0
        assert floats == (max(want_f, m * n) if ln else want_f)
        assert counters == (tiles * bm // 64 if splits > 1 else 0)


@pytest.mark.parametrize("r,d,dff,prenorm", [(32, 768, 3072, False),
                                             (32, 768, 2048, True),
                                             (128, 512, 2048, True),
                                             (2688, 512, 2048, False)])
def test_gemm_operands_bf16(r, d, dff, prenorm):
    """The bf16 entries' C arguments: plan_bf16's {BM, BN, splits} per
    product in the entry's order, one float32 workspace the size of the
    largest split or post-LN's rows, and one int32 counter array the size
    of the largest split's tiles (None where nothing needs them)."""
    products = FL.stack_products(r, d, dff)
    ln = (False, not prenorm, False, not prenorm)
    plans, ws, cnt = FL.gemm_operands_bf16(products, SMS,
                                           torch.device("cpu"), ln)
    want = [GP.plan_bf16(m, n, k, SMS) for m, n, k in products]
    assert list(plans) == [v for p in want for v in p]
    need = [GP.workspace_bf16(m, n, p, x)
            for (m, n, _), p, x in zip(products, want, ln)]
    n_ws, n_cnt = max(f for f, _ in need), max(c for _, c in need)
    assert (ws is None) == (n_ws == 0) and (cnt is None) == (n_cnt == 0)
    if ws is not None:
        assert ws.dtype == torch.float32 and ws.numel() == n_ws
    if cnt is not None:
        assert cnt.dtype == torch.int32 and cnt.numel() == n_cnt


@pytest.mark.parametrize("r,d,dff", [(32, 768, 3072), (256, 768, 3072),
                                     (128, 512, 2048), (21, 512, 2048)])
def test_gemm_operands(r, d, dff):
    """The wrappers' C arguments: {BM, BN, splits} per product in the
    entry's order, and one workspace the size of the largest split."""
    products = FL.stack_products(r, d, dff)
    plans, ws = FL.gemm_operands(products, SMS, torch.device("cpu"))
    want = [GP.plan(m, n, k, SMS) for m, n, k in products]
    assert list(plans) == [v for p in want for v in p]
    n_ws = max(GP.workspace_floats(m, n, p[2])
               for (m, n, _), p in zip(products, want))
    assert n_ws > 0 and ws.dtype == torch.float32 and ws.numel() == n_ws
    _, none = FL.gemm_operands(((2688, 2048, 512),), SMS, torch.device("cpu"))
    assert none is None


def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero
    (add half of the dropped 13 bits' range to the magnitude, then mask)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_rounding():
    """Exact values stay; a half-ulp tie (ulp 2^-10 at 1) rounds away from
    zero; less than half an ulp (2^-9 at 3) rounds down."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0 + 2 ** -12], dtype=torch.float32)
    want = [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
            -(1.0 + 2 ** -10), 3.0]
    assert _tf32(x).tolist() == want


def emulation_errors(m, k, n):
    """Max abs error against a float64 product of an (m, k) @ (k, n)
    product with unit-variance inputs and weights scaled by 1/sqrt(k), in
    3xTF32, one TF32 pass and float32."""
    rng = np.random.default_rng(m * 7 + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)
                         / np.float32(math.sqrt(k)))
    exact = a.double() @ b.double()
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    # TF32 products are exact in float32; the tensor cores sum them in
    # float32, the small terms first
    three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    return {name: (c.double() - exact).abs().max().item()
            for name, c in (("3xtf32", three), ("tf32", a_hi @ b_hi),
                            ("float32", a @ b))}


@pytest.mark.parametrize("m,k,n", TABLE)
def test_3xtf32_holds_float32_accuracy(m, k, n):
    err = emulation_errors(m, k, n)
    assert err["3xtf32"] <= 1e-5, err
    assert err["tf32"] > 1e-4, err


if __name__ == "__main__":
    for shape in TABLE:
        print(shape, {k: f"{v:.2e}" for k, v in
                      emulation_errors(*shape).items()})
