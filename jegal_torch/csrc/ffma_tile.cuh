// The register-blocked float32 tile step on the CUDA cores (FFMA), used by
// the block-2 convolution (conv2.cu). A block computes a 128x128 tile of C
// with 256 threads, each holding an 8x8 register tile; each K step stages
// 128x8 of A (transposed) and 8x128 of B in shared memory. Each thread
// issues 4 shared-memory float4 loads per 64 FMAs, which keeps the loop
// FMA-bound rather than bound by shared memory.
#pragma once

#include "common.cuh"

namespace jt {

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 8;
constexpr int GEMM_THREADS = 256;

// Row (or column) of the block's tile that a thread's i-th register row
// (column) holds: two runs of 4, 64 apart.
__device__ __forceinline__ int gemm_tile_index(int i, int t) {
  return i < 4 ? t * 4 + i : 64 + t * 4 + (i - 4);
}

// One BK-deep step of a thread's 8x8 register tile from the staged tiles:
// As holds A transposed (k, row), Bs holds B (k, col).
__device__ __forceinline__ void gemm_tile_step(
    const float (&As)[GEMM_BK][GEMM_BM], const float (&Bs)[GEMM_BK][GEMM_BN],
    int tx, int ty, float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < GEMM_BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

}  // namespace jt
