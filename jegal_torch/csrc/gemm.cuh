// Tiled float32 matrix product with a fused epilogue, written for the
// CUDA cores (no tensor cores: TF32 would not hold float32 parity).
//
//   C[M,N] = act(A[M,K] @ B[K,N] + bias[N]) + res[M,N]
//
// All operands row-major and contiguous; bias and res may be null. A block
// computes a 128x128 tile of C with 256 threads, each holding an 8x8
// register tile; the K loop stages 128x8 of A (transposed) and 8x128 of B
// in shared memory. Each thread issues 4 shared-memory float4 loads per 64
// FMAs, which keeps the loop FMA-bound rather than bound by shared memory.
#pragma once

#include "common.cuh"

namespace jt {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 8;
constexpr int GEMM_THREADS = 256;

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;
}

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

__global__ void __launch_bounds__(GEMM_THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ C, int M, int N, int K, int act) {
  __shared__ __align__(16) float As[GEMM_BK][GEMM_BM];
  __shared__ __align__(16) float Bs[GEMM_BK][GEMM_BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.y * GEMM_BM;
  const int col0 = blockIdx.x * GEMM_BN;
  // loaders: A as 128 rows x 2 quads of k, B as 8 rows x 32 quads of n
  const int a_r = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int b_k = tid >> 5;
  const int b_c = (tid & 31) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    const int gr = row0 + a_r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + a_k + i;
      As[a_k + i][a_r] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : 0.f;
    }
    const int gk = k0 + b_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gc = col0 + b_c + i;
      Bs[b_k][b_c + i] = (gk < K && gc < N) ? B[(size_t)gk * N + gc] : 0.f;
    }
    __syncthreads();
    gemm_tile_step(As, Bs, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + gemm_tile_index(i, ty);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + gemm_tile_index(j, tx);
      if (c >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[c];
      v = apply_act(v, act);
      if (res != nullptr) v += res[(size_t)r * N + c];
      C[(size_t)r * N + c] = v;
    }
  }
}

inline void gemm_f32(const float* A, const float* B, const float* bias,
                     const float* res, float* C, int M, int N, int K, int act,
                     cudaStream_t stream) {
  dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_f32_kernel<<<grid, GEMM_THREADS, 0, stream>>>(A, B, bias, res, C, M, N,
                                                     K, act);
}

}  // namespace jt
