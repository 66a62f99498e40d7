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
"""

from __future__ import annotations

BK = 32
TILE_M = (32, 64, 128)
TILE_N = (64, 128)
TILES = frozenset((bm, bn) for bm in TILE_M for bn in TILE_N)

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


def k_slices(K: int, splits: int) -> list[tuple[int, int]]:
    """The [k0, k1) ranges of the K slices as the C code cuts them."""
    steps = _cdiv(K, BK)
    per = _cdiv(steps, splits)
    return [(s * per * BK, min(K, (s + 1) * per * BK)) for s in range(splits)]


def workspace_floats(M: int, N: int, splits: int,
                     row_pass: bool = False) -> int:
    """Floats of the split partials (splits, M, N); unsplit, M * N when
    the epilogue runs in the row kernel (`row_pass`: a bf16 product's
    float32 sum waits there for its LayerNorm), else 0."""
    if splits > 1:
        return splits * M * N
    return M * N if row_pass else 0


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    import torch

    device = torch.device(device)
    idx = torch.cuda.current_device() if device.index is None else device.index
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]
