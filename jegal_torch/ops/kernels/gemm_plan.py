"""Tile and split-K plans of the shared tensor-core GEMM (csrc/gemm.cuh).

The CUDA code is built for the tile pairs in `TILES` only; a product
C[M, N] = A[M, K] @ B[K, N] runs as ceil(N/BN) x ceil(M/BM) x splits blocks,
block (n, m, s) taking K slice s of `k_slices(K, splits)`. The plan is
pure Python so that the CPU tests reach every shape the card runs:

  * BM: the smallest of 32, 64, 128 that covers M (128 past that);
  * BN: 128 when the tiles at that width already fill the card (one block
    per SM), else 64;
  * splits: 1 when the tiles fill the card; otherwise the K steps (of
    BK = 32) are cut into slices of `steps // want` whole steps, `want`
    being the splits that reach one wave, so that the grid reaches at least
    `sms` blocks wherever K has that many steps.

The C code derives each slice's depth from `splits` alone (ceil(steps /
splits) steps, the last slice ragged), which `k_slices` mirrors.

`plan_bf16` plans the bf16 product (gemm.cuh's `gemm_bf16`, on wgmma), whose
stages are BK_BF16 = 64 deep, whose tiles are `TILES_BF16` (a consumer
warpgroup a 64-row slab) and whose grid is persistent: at most one block
an SM, two of a one-warpgroup (BM 64) tile (`blocks_per_sm_bf16`), each
walking units (a tile and a K slice) in turn.

  * BM: 128 (two warpgroups sharing B's stage) when the 128-row tiles at
    BN 64 already fill the SMs, else 64 (more, smaller units);
  * BN: of 128 and 64, the one whose rounds of tiles over the blocks
    cost least, a round's cost in proportion to BN (the wider on a tie);
  * splits: 1 when the tiles fill the SMs; otherwise K is cut into
    slices of about STEPS_BF16 64-deep steps (a split costs its partials'
    round trip and the tile's last slice's sum: on the H100 a unit of 8-16
    steps ran faster split no further), and no more than keep the units
    within one round of the blocks. The
    slices are summed in the product kernel (the last to finish a tile
    adds them in slice order), which needs the (splits, M, N) float32
    partials and BM / 64 counters a tile (`workspace_bf16`).
"""

from __future__ import annotations

BK = 32
TILE_M = (32, 64, 128)
TILE_N = (64, 128)
TILES = frozenset((bm, bn) for bm in TILE_M for bn in TILE_N)

BK_BF16 = 64
TILE_M_BF16 = (64, 128)
TILE_N_BF16 = (64, 128)
TILES_BF16 = frozenset((bm, bn) for bm in TILE_M_BF16 for bn in TILE_N_BF16)
STEPS_BF16 = 16    # 64-deep steps a slice of a split bf16 product

_sms: dict = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(M: int, N: int, K: int, sms: int) -> tuple[int, int, int]:
    """(BM, BN, splits) of an (M, K) @ (K, N) product on a card with `sms`
    streaming multiprocessors."""
    if min(M, N, K, sms) < 1:
        raise ValueError(f"no plan for M={M} N={N} K={K} on {sms} SMs")
    bm = next((t for t in TILE_M if t >= M), TILE_M[-1])
    rows = _cdiv(M, bm)
    bn = 128 if rows * _cdiv(N, 128) >= sms else 64
    tiles = rows * _cdiv(N, bn)
    if tiles >= sms:
        return bm, bn, 1
    steps = _cdiv(K, BK)
    per = max(1, steps // _cdiv(sms, tiles))
    return bm, bn, _cdiv(steps, per)


def blocks_per_sm_bf16(bm: int) -> int:
    """Blocks of a (bm, *) bf16 tile an SM runs at once: a one-warpgroup
    tile takes half an SM's shared memory (csrc/gemm.cuh's WgTile)."""
    return 2 if bm == TILE_M_BF16[0] else 1


def plan_bf16(M: int, N: int, K: int, sms: int) -> tuple[int, int, int]:
    """(BM, BN, splits) of a bf16 (M, K) @ (K, N) product on a card with
    `sms` streaming multiprocessors."""
    if min(M, N, K, sms) < 1:
        raise ValueError(f"no plan for M={M} N={N} K={K} on {sms} SMs")
    big = _cdiv(M, TILE_M_BF16[-1]) * _cdiv(N, TILE_N_BF16[0]) >= sms
    bm = TILE_M_BF16[-1] if big else TILE_M_BF16[0]
    rows, slots = _cdiv(M, bm), sms * blocks_per_sm_bf16(bm)
    bn = min(sorted(TILE_N_BF16, reverse=True),
             key=lambda b: _cdiv(rows * _cdiv(N, b), slots) * b)
    tiles = rows * _cdiv(N, bn)
    if tiles >= slots:
        return bm, bn, 1
    steps = _cdiv(K, BK_BF16)
    want = max(1, min(_cdiv(steps, STEPS_BF16), slots // tiles))
    return bm, bn, _cdiv(steps, _cdiv(steps, want))


def k_slices(K: int, splits: int, bk: int = BK) -> list[tuple[int, int]]:
    """The [k0, k1) ranges of the K slices as the C code cuts them (bk
    BK_BF16 for a bf16 plan)."""
    steps = _cdiv(K, bk)
    per = _cdiv(steps, splits)
    return [(s * per * bk, min(K, (s + 1) * per * bk)) for s in range(splits)]


def workspace_floats(M: int, N: int, splits: int) -> int:
    """Floats of the split partials (splits, M, N), 0 unsplit."""
    return splits * M * N if splits > 1 else 0


def workspace_bf16(M: int, N: int, plan, ln: bool = False) -> tuple[int, int]:
    """(floats, counters) a bf16 product under `plan` needs: its split
    partials (splits, M, N), or with a LayerNorm after it (`ln`) at least
    its (M, N) float32 rows, which wait there for the row pass; and split,
    a counter a tile's 64-row slab."""
    bm, bn, splits = plan
    floats = splits * M * N if splits > 1 else 0
    if ln:
        floats = max(floats, M * N)
    counters = _cdiv(M, bm) * _cdiv(N, bn) * (bm // 64) if splits > 1 else 0
    return floats, counters


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    import torch

    device = torch.device(device)
    idx = torch.cuda.current_device() if device.index is None else device.index
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]
