// Fused transformer encoder sublayers for Hopper (sm_90a), float32.
//
// Replaces jegal_tpu/ops/pallas/fused_layer.py:_attn_kernel and
// :_ffn_kernel. Each C entry point below is one sublayer, run as a few
// launches of hand-written kernels on the caller's stream:
//
//   attention:  [pre-LN] -> QKV (one d x 3d product + bias) -> per-segment
//               multi-head softmax attention with a key mask (-1e9 fill)
//               -> output product + bias + residual -> [post-LN]
//   FFN:        [pre-LN] -> W1 + bias -> ReLU | exact GELU -> W2 + bias +
//               residual -> [post-LN]
//
// What bounds it on the H100: the four products (QKV, output, W1, W2) are
// ~99% of the operations; in float32 on the CUDA cores their bound is the
// 67 TFLOP/s non-tensor rate, not memory (the window head's 2688-row
// products do ~30 FLOP per byte moved even counting every operand once).
// The design keeps them on one tiled register-blocked GEMM (gemm.cuh) with
// bias, activation and residual fused into its epilogue, so the only extra
// passes over device memory are the LayerNorm rows and the (R, 3d) QKV and
// (R, d_ff) activations, which the TPU kernel kept in VMEM.
//
// Attention is computed per segment (the 21-token GestSync windows, or one
// T-token JEGAL sequence), never as the TPU kernel's block-diagonal
// (rows x rows) score matrix, which only existed to keep the MXU fed. A
// block owns 32 query rows of one (segment, head) and streams the
// segment's keys through shared memory 32 at a time with an online softmax,
// so any segment length fits (a 512-key segment's K and V alone would be
// 256 KB, more than a block's 227 KB). LayerNorm owns whole rows: one warp
// per row, run after the residual product has written the row.
#include <math.h>

#include "common.cuh"
#include "gemm.cuh"

namespace jt {

// y = LN(x) row-wise. kind 0: torch nn.LayerNorm (biased variance,
// rsqrt(var + 1e-5)); kind 1: the reference LayerNorm (Bessel variance,
// 1 / (sqrt(var) + 1e-6)). x may alias y: each element is read by the
// thread that writes it, after the row statistics are complete.
__global__ void layer_norm_rows(const float* x, const float* __restrict__ g,
                                const float* __restrict__ b, float* y, int R,
                                int d, int kind) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const float* xr = x + (size_t)row * d;
  float* yr = y + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += xr[c];
  const float mean = warp_sum(s) / (float)d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = xr[c] - mean;
    ss = fmaf(t, t, ss);
  }
  ss = warp_sum(ss);
  const float inv = (kind == 1) ? 1.f / (sqrtf(ss / (float)(d - 1)) + 1e-6f)
                                : rsqrtf(ss / (float)d + 1e-5f);
  for (int c = lane; c < d; c += 32) yr[c] = (xr[c] - mean) * inv * g[c] + b[c];
}

inline void layer_norm(const float* x, const float* g, const float* b,
                       float* y, int R, int d, int kind, cudaStream_t s) {
  const int rows_per_block = 8;  // 8 warps
  layer_norm_rows<<<(R + rows_per_block - 1) / rows_per_block, 256, 0, s>>>(
      x, g, b, y, R, d, kind);
}

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

// One attention sublayer over R = n_segments * seg rows of width d.
// Scratch (caller-allocated): h (R, d) when prenorm, qkv (R, 3d), att (R, d).
extern "C" int jt_attn_sublayer(const float* x, const float* wqkv,
                                const float* bqkv, const float* wo,
                                const float* bo, const float* ln_g,
                                const float* ln_b, const float* kmask,
                                float* h, float* qkv, float* att, float* out,
                                int R, int d, int heads, int seg, int prenorm,
                                int ln_kind, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (seg <= 0 || R % seg != 0 || d % heads != 0) return JT_ERR_SHAPE;
  const float* src = x;
  if (prenorm) {
    jt::layer_norm(x, ln_g, ln_b, h, R, d, ln_kind, s);
    JT_CHECK_LAUNCH();
    src = h;
  }
  jt::gemm_f32(src, wqkv, bqkv, nullptr, qkv, R, 3 * d, d, jt::ACT_NONE, s);
  JT_CHECK_LAUNCH();
  const int rc = jt::attention(qkv, kmask, att, R, d, heads, seg, s);
  if (rc != 0) return rc;
  JT_CHECK_LAUNCH();
  jt::gemm_f32(att, wo, bo, x, out, R, d, d, jt::ACT_NONE, s);
  JT_CHECK_LAUNCH();
  if (!prenorm) {
    jt::layer_norm(out, ln_g, ln_b, out, R, d, ln_kind, s);
    JT_CHECK_LAUNCH();
  }
  return 0;
}

// One FFN sublayer over R rows. Scratch: h (R, d) when prenorm,
// h1 (R, dff). act: 1 ReLU, 2 exact-erf GELU.
extern "C" int jt_ffn_sublayer(const float* x, const float* w1,
                               const float* b1, const float* w2,
                               const float* b2, const float* ln_g,
                               const float* ln_b, float* h, float* h1,
                               float* out, int R, int d, int dff, int prenorm,
                               int ln_kind, int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* src = x;
  if (prenorm) {
    jt::layer_norm(x, ln_g, ln_b, h, R, d, ln_kind, s);
    JT_CHECK_LAUNCH();
    src = h;
  }
  jt::gemm_f32(src, w1, b1, nullptr, h1, R, dff, d, act, s);
  JT_CHECK_LAUNCH();
  jt::gemm_f32(h1, w2, b2, x, out, R, d, dff, jt::ACT_NONE, s);
  JT_CHECK_LAUNCH();
  if (!prenorm) {
    jt::layer_norm(out, ln_g, ln_b, out, R, d, ln_kind, s);
    JT_CHECK_LAUNCH();
  }
  return 0;
}
