// Device code shared by the encoder sources (fused_layer.cu: one sublayer a
// call; encoder_stack.cu: a whole stack a call): the per-(segment, head)
// online-softmax attention. The products and the row LayerNorm are in
// gemm.cuh.
//
// Attention is computed per segment (the 21-token GestSync windows, or one
// T-token sequence), never as the TPU kernel's block-diagonal (rows x rows)
// score matrix, which only existed to keep the MXU fed. A block owns 32
// query rows of one (segment, head) and streams the segment's keys through
// shared memory 32 at a time with an online softmax, so any segment length
// fits (a 512-key segment's K and V alone would be 256 KB, more than a
// block's 227 KB).
#pragma once

#include <math.h>

#include "common.cuh"

namespace jt {

constexpr int ATT_QT = 32;      // query rows per block
constexpr int ATT_KT = 32;      // keys per shared-memory tile
constexpr int ATT_TPR = 4;      // threads per query row
constexpr int ATT_THREADS = ATT_QT * ATT_TPR;

// qkv: (R, 3d) rows [q | k | v], head h at columns h*DK of each third.
// kmask: (R,) key validity (0 = masked) or null. out: (R, d).
// grid: (R / seg segments, heads, ceil(seg / 32) query tiles).
template <int DK>
__global__ void __launch_bounds__(ATT_THREADS)
segment_attention(const float* __restrict__ qkv,
                  const float* __restrict__ kmask, float* __restrict__ out,
                  int d, int seg, float scale) {
  constexpr int DPT = DK / ATT_TPR;        // output dims per thread
  constexpr int KPT = ATT_KT / ATT_TPR;    // scores per thread per tile
  __shared__ float Qs[ATT_QT][DK + 1];
  __shared__ float Ks[ATT_KT][DK + 1];
  __shared__ float Vs[ATT_KT][DK];
  __shared__ float Ps[ATT_QT][ATT_KT + 1];

  const int tid = threadIdx.x;
  const int r = tid / ATT_TPR;
  const int sub = tid % ATT_TPR;
  const int base = blockIdx.x * seg;
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * ATT_QT;
  const size_t ld = 3 * (size_t)d;

  for (int i = tid; i < ATT_QT * DK; i += ATT_THREADS) {
    const int rr = i / DK, cc = i % DK;
    Qs[rr][cc] = (q0 + rr < seg)
                     ? qkv[(size_t)(base + q0 + rr) * ld + h * DK + cc]
                     : 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < seg; k0 += ATT_KT) {
    __syncthreads();  // Q staged / previous tile consumed
    for (int i = tid; i < ATT_KT * DK; i += ATT_THREADS) {
      const int j = i / DK, cc = i % DK;
      const bool ok = k0 + j < seg;
      const size_t row = (size_t)(base + k0 + j) * ld;
      Ks[j][cc] = ok ? qkv[row + d + h * DK + cc] : 0.f;
      Vs[j][cc] = ok ? qkv[row + 2 * d + h * DK + cc] : 0.f;
    }
    __syncthreads();

    float sc[KPT];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = sub + ATT_TPR * jj;
      float s = -INFINITY;  // keys past the segment take no part
      if (k0 + j < seg) {
        float dot = 0.f;
#pragma unroll 16
        for (int c = 0; c < DK; ++c) dot = fmaf(Qs[r][c], Ks[j][c], dot);
        s = dot * scale;
        if (kmask != nullptr && kmask[base + k0 + j] == 0.f) s = -1e9f;
      }
      sc[jj] = s;
      tmax = fmaxf(tmax, s);
    }
    // the row's 4 threads are adjacent lanes of one warp
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);  // finite: key k0 is in the segment
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = (sc[jj] == -INFINITY) ? 0.f : expf(sc[jj] - m_new);
      Ps[r][sub + ATT_TPR * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    for (int j = 0; j < ATT_KT; ++j) {
      const float p = Ps[r][j];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(p, Vs[j][sub + ATT_TPR * i], acc[i]);
    }
  }

  if (q0 + r < seg) {
    float* o = out + (size_t)(base + q0 + r) * d + h * DK;
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[sub + ATT_TPR * i] = acc[i] * inv;
  }
}

inline int attention(const float* qkv, const float* kmask, float* out, int R,
                     int d, int heads, int seg, cudaStream_t s) {
  const int dk = d / heads;
  dim3 grid(R / seg, heads, (seg + ATT_QT - 1) / ATT_QT);
  const float scale = 1.f / sqrtf((float)dk);
  if (dk == 64) {
    segment_attention<64><<<grid, ATT_THREADS, 0, s>>>(qkv, kmask, out, d, seg,
                                                        scale);
  } else if (dk == 96) {
    segment_attention<96><<<grid, ATT_THREADS, 0, s>>>(qkv, kmask, out, d, seg,
                                                        scale);
  } else {
    return JT_ERR_SHAPE;
  }
  return 0;
}

}  // namespace jt
