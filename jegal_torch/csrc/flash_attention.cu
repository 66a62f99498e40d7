// Blockwise (flash-style) multi-head attention for Hopper (sm_90a), float32.
//
// Replaces jegal_tpu/ops/pallas/flash_attention.py:_make_kernel (called by
// `flash_attention`, :113-146). q, k, v and out are contiguous (B, H, T, D);
// mask is a (B, T) key validity (0.0 = masked) or null. The TPU kernel's
// semantics are kept exactly:
//   * q is multiplied by `scale` (1/sqrt(D), rounded to float32 by the
//     caller) before the QK^T product;
//   * a masked key's score is FILLED with -1e9 (not -inf);
//   * the online softmax keeps its running max, sum and accumulator in
//     float32, the running max starting at -2e9. A row whose keys are all
//     masked then sees every score at -1e9 and averages V uniformly, as the
//     dense softmax does.
// Keys past T (the ragged last tile) take no part at all.
//
// What bounds it on the H100: 4*B*H*T^2*D operations against 16*B*H*T*D
// bytes, so at the training shapes (T 128, D 64) it does ~32 operations a
// byte and the 67 TFLOP/s float32 rate of the CUDA cores bounds it, not
// HBM. The design keeps every score in registers and shared memory: a block
// owns 32 query rows of one (b, h), 4 threads a row, and streams the keys
// and values through shared memory 32 rows at a time, so the (T, T) score
// matrix never reaches device memory and any T fits (a 1024-key clip's K
// and V would be 512 KB, more than a block's 227 KB). Tensor cores (TF32,
// bf16) would break float32 parity with the plain twin; they are later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int FA_QT = 32;                  // query rows per block
constexpr int FA_KT = 32;                  // keys per shared-memory tile
constexpr int FA_TPR = 4;                  // threads per query row
constexpr int FA_THREADS = FA_QT * FA_TPR;
constexpr float NEG_FILL = -1e9f;          // flash_attention.py:27

// grid: (B * H, ceil(T / 32)). Thread (r, sub) owns query row q0 + r, the
// scores of keys sub, sub + 4, ... of each tile and the output columns
// sub, sub + 4, ... of that row.
template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_fwd(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int H, int T, float scale) {
  constexpr int DPT = D / FA_TPR;          // output columns per thread
  constexpr int KPT = FA_KT / FA_TPR;      // scores per thread per tile
  __shared__ float Qs[FA_QT][D + 1];
  __shared__ float Ks[FA_KT][D + 1];
  __shared__ float Vs[FA_KT][D];
  __shared__ float Ps[FA_QT][FA_KT + 1];

  const int tid = threadIdx.x;
  const int r = tid / FA_TPR;
  const int sub = tid % FA_TPR;
  const int bh = blockIdx.x;               // b * H + h
  const int q0 = blockIdx.y * FA_QT;
  const size_t base = (size_t)bh * T * D;
  const float* mrow = (mask != nullptr) ? mask + (size_t)(bh / H) * T : nullptr;

  for (int i = tid; i < FA_QT * D; i += FA_THREADS) {
    const int rr = i / D, cc = i % D;
    Qs[rr][cc] =
        (q0 + rr < T) ? q[base + (size_t)(q0 + rr) * D + cc] * scale : 0.f;
  }

  float m = 2.f * NEG_FILL, l = 0.f;       // flash_attention.py:69-70
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < T; k0 += FA_KT) {
    __syncthreads();  // Q staged / the previous tile consumed
    for (int i = tid; i < FA_KT * D; i += FA_THREADS) {
      const int j = i / D, cc = i % D;
      const bool ok = k0 + j < T;
      const size_t at = base + (size_t)(k0 + j) * D + cc;
      Ks[j][cc] = ok ? k[at] : 0.f;
      Vs[j][cc] = ok ? v[at] : 0.f;
    }
    __syncthreads();

    float sc[KPT];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = sub + FA_TPR * jj;
      float s = -INFINITY;  // a key past T takes no part
      if (k0 + j < T) {
        float dot = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) dot = fmaf(Qs[r][c], Ks[j][c], dot);
        s = (mrow != nullptr && mrow[k0 + j] == 0.f) ? NEG_FILL : dot;
      }
      sc[jj] = s;
      tmax = fmaxf(tmax, s);
    }
    // the row's 4 threads are adjacent lanes of one warp
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);    // finite: key k0 is below T
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = (sc[jj] == -INFINITY) ? 0.f : expf(sc[jj] - m_new);
      Ps[r][sub + FA_TPR * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    for (int j = 0; j < FA_KT; ++j) {
      const float p = Ps[r][j];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(p, Vs[j][sub + FA_TPR * i], acc[i]);
    }
  }

  if (q0 + r < T) {
    float* o = out + base + (size_t)(q0 + r) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[sub + FA_TPR * i] = acc[i] / l;
  }
}

}  // namespace

// out = softmax(fill(q*scale @ k^T, mask, -1e9)) @ v over (B, H, T, D)
// float32, on the caller's stream. D must be 64 or 96.
extern "C" int jt_flash_attention(const float* q, const float* k,
                                  const float* v, const float* mask,
                                  float* out, int B, int H, int T, int D,
                                  float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || T <= 0) return JT_ERR_SHAPE;
  const dim3 grid(B * H, (T + FA_QT - 1) / FA_QT);
  if (D == 64) {
    flash_attention_fwd<64><<<grid, FA_THREADS, 0, s>>>(q, k, v, mask, out, H,
                                                         T, scale);
  } else if (D == 96) {
    flash_attention_fwd<96><<<grid, FA_THREADS, 0, s>>>(q, k, v, mask, out, H,
                                                         T, scale);
  } else {
    return JT_ERR_SHAPE;
  }
  JT_CHECK_LAUNCH();
  return 0;
}
