// Band GestSync stem for Hopper (sm_90a), float32: the function of
// stem.cu (conv3d k(5,7,7) s(1,3,3) 3->64 -> folded BN -> ReLU -> maxpool
// (1,3,3)/(1,2,2)), computed down each frame's rows instead of in tiles.
//
// Replaces jegal_tpu/ops/pallas/stem.py:_stem_kernel_band (reached through
// stem_mgrid_x / stem_mgrid_planar with impl="band"), on both input forms
// of stem.cuh. The TPU kernel walks a sequential grid down the pooled rows
// j, keeps three K-bands of input rows, fetches only the two new input rows
// a step and carries conv row 2j in scratch. Hopper has no sequential
// grid, so the walk is a loop inside the block:
//   * a block owns a strip of 8 pooled columns (17 conv columns, 55 input
//     columns) of 3 consecutive output frames (7 input frames), for all 64
//     channels, and loops over the pairs of conv rows (2m, 2m+1);
//   * a ring of 10 input rows a frame in shared memory holds what a pair
//     reads (rows 6m..6m+9); each step loads only the 6 new rows of each
//     input frame;
//   * after pair m, pooled row m-1 is the max of the carried row max of
//     pair m-1, conv row 2m and the 3-column window; the carry becomes the
//     row max of pair m. No conv row is computed twice, where the window
//     kernel recomputes one of every 9 rows and restages a 31-row patch for
//     every 4 pooled rows;
//   * the weights of one temporal tap (37.6 KB) are staged per tap and per
//     step, as in the window kernel; the finished pair's conv rows reuse
//     their space;
//   * each of the 256 threads accumulates 4 conv positions x 8 channels
//     (102 positions a step: 3 frames x 2 rows x 17 columns).
// Bound: operations, as the window kernel (190 GFLOP for a 5 s clip, 2.84
// ms at the 67 TFLOP/s float32 rate); 97 KB of shared memory, two blocks
// an SM.
#include "stem.cuh"

namespace jt {

constexpr int SB_F = 3;                  // output frames a block
constexpr int SB_NF = SB_F + ST_KT - 1;  // input frames a block (7)
constexpr int SB_PI = 8;                 // pooled columns a block
constexpr int SB_CC = 2 * SB_PI + 1;     // conv columns (17)
constexpr int SB_IROW = (ST_S * (SB_CC - 1) + ST_KW) * ST_CIN;  // 165
constexpr int SB_RING = 10;              // input rows a pair of conv rows reads
constexpr int SB_NEW = 2 * ST_S;         // new input rows a step (6)
constexpr int SB_NPOS = SB_F * 2 * SB_CC;   // 102 conv positions a step
constexpr int SB_THREADS = 256;
constexpr int SB_PPT = 4;                // conv positions per thread
constexpr int SB_CPT = 8;                // channels per thread
constexpr int SB_CS_LD = ST_C + 1;       // padded conv-row stride
constexpr int SB_XS = SB_NF * SB_RING * SB_IROW;     // 11550 floats
constexpr int SB_WS_OFF = (SB_XS + 3) / 4 * 4;
constexpr int SB_CARRY_OFF = SB_WS_OFF + ST_WS;
constexpr int SB_CARRY = SB_F * SB_CC * ST_C;        // 3264 floats
constexpr int SB_SMEM_FLOATS = SB_CARRY_OFF + SB_CARRY;
constexpr size_t SB_SMEM_BYTES = sizeof(float) * SB_SMEM_FLOATS;
static_assert(SB_PPT * 32 >= SB_NPOS, "positions must cover a step");
static_assert(SB_NPOS * SB_CS_LD <= ST_WS, "conv rows must fit the weights");
static_assert(ST_S + ST_KH <= SB_RING,
              "a pair of conv rows must read at most SB_RING input rows");

// Stage input rows [y0, y0 + n) of the block's input frames into the ring.
template <class Src>
__device__ void stage_rows(const Src& src, float* Xs, int t0, int t_in,
                           int x_in0, int y0, int n) {
  const int total = SB_NF * n * SB_IROW;
  for (int i = threadIdx.x; i < total; i += SB_THREADS) {
    const int q = i % SB_IROW;
    const int fr = i / SB_IROW;
    const int f = fr / n, y = y0 + fr % n;
    const int t = t0 + f, xq = x_in0 * ST_CIN + q;
    Xs[(f * SB_RING + y % SB_RING) * SB_IROW + q] =
        (t < t_in && y < src.H && xq < src.W * ST_CIN) ? src.at(t, y, xq)
                                                       : 0.f;
  }
}

// src: (t_in, H, W, 3) frames (stem.cuh); w: (5, 7, 7, 3, 64) DHWIO;
// out: (t_in - 4, J, Wp, 64). grid: (ceil(Wp / 8), ceil((t_in - 4) / 3))
template <class Src>
__global__ void __launch_bounds__(SB_THREADS)
stem_band_kernel(Src src, const float* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int t_in, int J, int Wp) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                   // [7][10][165] input row ring
  float* Ws = smem + SB_WS_OFF;       // [147][64] one tap's weights
  float* Cs = Ws;                     // [102][65] the finished pair
  float* Carry = smem + SB_CARRY_OFF; // [3][17][64] row max of the last pair

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * SB_PI;  // pooled col origin
  const int t0 = blockIdx.y * SB_F;   // first output frame
  const int t_out = t_in - (ST_KT - 1);
  const int cg = tid >> 5;            // channel group: one per warp
  const int pg = tid & 31;
  const int x_in0 = 2 * ST_S * i0;

  // position p = (frame f, row r of the pair, conv column col)
  int pf[SB_PPT], pr[SB_PPT], pcol[SB_PPT];
#pragma unroll
  for (int k = 0; k < SB_PPT; ++k) {
    const int p = min(pg + 32 * k, SB_NPOS - 1);
    pf[k] = p / (2 * SB_CC);
    pr[k] = (p / SB_CC) % 2;
    pcol[k] = p % SB_CC;
  }
  float sc[SB_CPT], bi[SB_CPT];
#pragma unroll
  for (int c = 0; c < SB_CPT; ++c) {
    sc[c] = scale[cg * SB_CPT + c];
    bi[c] = bias[cg * SB_CPT + c];
  }

  stage_rows(src, Xs, t0, t_in, x_in0, 0, SB_RING);
  for (int m = 0; m <= J; ++m) {      // pair m: conv rows 2m, 2m + 1
    float acc[SB_PPT][SB_CPT];
#pragma unroll
    for (int k = 0; k < SB_PPT; ++k)
#pragma unroll
      for (int c = 0; c < SB_CPT; ++c) acc[k][c] = 0.f;

    for (int dt = 0; dt < ST_KT; ++dt) {
      __syncthreads();  // ring rows staged; last weights / conv rows consumed
      const float4* wsrc =
          reinterpret_cast<const float4*>(w + (size_t)dt * ST_WS);
      float4* wdst = reinterpret_cast<float4*>(Ws);
      for (int i = tid; i < ST_WS / 4; i += SB_THREADS) wdst[i] = wsrc[i];
      __syncthreads();

      for (int dy = 0; dy < ST_KH; ++dy) {
        int xb[SB_PPT];
#pragma unroll
        for (int k = 0; k < SB_PPT; ++k) {
          const int y = 2 * ST_S * m + ST_S * pr[k] + dy;  // input row
          xb[k] = ((pf[k] + dt) * SB_RING + y % SB_RING) * SB_IROW
                  + ST_S * ST_CIN * pcol[k];
        }
#pragma unroll
        for (int dx = 0; dx < ST_KW; ++dx) {
#pragma unroll
          for (int c = 0; c < ST_CIN; ++c) {
            const int tap = (dy * ST_KW + dx) * ST_CIN + c;
            const float4 wa = *reinterpret_cast<const float4*>(
                &Ws[tap * ST_C + cg * SB_CPT]);
            const float4 wb = *reinterpret_cast<const float4*>(
                &Ws[tap * ST_C + cg * SB_CPT + 4]);
            const int o = dx * ST_CIN + c;
#pragma unroll
            for (int k = 0; k < SB_PPT; ++k) {
              const float xv = Xs[xb[k] + o];
              acc[k][0] = fmaf(xv, wa.x, acc[k][0]);
              acc[k][1] = fmaf(xv, wa.y, acc[k][1]);
              acc[k][2] = fmaf(xv, wa.z, acc[k][2]);
              acc[k][3] = fmaf(xv, wa.w, acc[k][3]);
              acc[k][4] = fmaf(xv, wb.x, acc[k][4]);
              acc[k][5] = fmaf(xv, wb.y, acc[k][5]);
              acc[k][6] = fmaf(xv, wb.z, acc[k][6]);
              acc[k][7] = fmaf(xv, wb.w, acc[k][7]);
            }
          }
        }
      }
    }

    // BN + ReLU into the pair's conv rows (over the weights)
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SB_PPT; ++k) {
      const int p = pg + 32 * k;
      if (p < SB_NPOS) {
#pragma unroll
        for (int c = 0; c < SB_CPT; ++c)
          Cs[p * SB_CS_LD + cg * SB_CPT + c] =
              fmaxf(fmaf(acc[k][c], sc[c], bi[c]), 0.f);
      }
    }
    __syncthreads();

    // pooled row m - 1: rows 2m-2, 2m-1 (carried) and 2m, 3 columns
    if (m > 0) {
      for (int q = tid; q < SB_F * SB_PI * ST_C; q += SB_THREADS) {
        const int o = q % ST_C;
        const int pos = q / ST_C;
        const int f = pos / SB_PI, pi = pos % SB_PI;
        const int t = t0 + f, i = i0 + pi;
        if (t >= t_out || i >= Wp) continue;
        float v = -INFINITY;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int col = 2 * pi + b;
          v = fmaxf(v, fmaxf(Carry[(f * SB_CC + col) * ST_C + o],
                             Cs[(f * 2 * SB_CC + col) * SB_CS_LD + o]));
        }
        out[(((size_t)t * J + (m - 1)) * Wp + i) * ST_C + o] = v;
      }
      __syncthreads();
    }
    if (m == J) break;
    for (int q = tid; q < SB_CARRY; q += SB_THREADS) {
      const int o = q % ST_C;
      const int fc = q / ST_C;
      const int f = fc / SB_CC, col = fc % SB_CC;
      Carry[q] = fmaxf(Cs[(f * 2 * SB_CC + col) * SB_CS_LD + o],
                       Cs[(f * 2 * SB_CC + SB_CC + col) * SB_CS_LD + o]);
    }
    // pair m + 1 reads rows 6m+6..6m+15: the 6 new ones take the ring
    // slots of rows 6m..6m+5, which no later pair reads
    stage_rows(src, Xs, t0, t_in, x_in0, 2 * ST_S * m + SB_RING, SB_NEW);
  }
}

}  // namespace jt

template <class Src>
static int launch_stem_band(Src src, const float* w, const float* scale,
                            const float* bias, float* out, int t_in,
                            cudaStream_t stream) {
  using namespace jt;
  const int J = stem_pooled(src.H), Wp = stem_pooled(src.W);
  if (t_in < ST_KT || J < 1 || Wp < 1) return JT_ERR_SHAPE;
  cudaError_t e = cudaFuncSetAttribute(
      stem_band_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SB_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int t_out = t_in - (ST_KT - 1);
  dim3 grid((Wp + SB_PI - 1) / SB_PI, (t_out + SB_F - 1) / SB_F);
  stem_band_kernel<Src><<<grid, SB_THREADS, SB_SMEM_BYTES, stream>>>(
      src, w, scale, bias, out, t_in, J, Wp);
  JT_CHECK_LAUNCH();
  return 0;
}

// frames (t_in, H, W, 3) float32 -> out (t_in - 4, J, Wp, 64), as
// jt_stem_pool.
extern "C" int jt_stem_band(const float* frames, const float* w,
                            const float* scale, const float* bias, float* out,
                            int t_in, int H, int W, void* stream) {
  return launch_stem_band(jt::FloatFrames{frames, H, W}, w, scale, bias, out,
                          t_in, (cudaStream_t)stream);
}

// planar (t_in, H3, 27, W3) uint8 -> out (t_in - 4, J, Wp, 64), as
// jt_stem_pool_planar (w pre-scaled by 1/255).
extern "C" int jt_stem_band_planar(const uint8_t* planar, const float* w,
                                   const float* scale, const float* bias,
                                   float* out, int t_in, int H3, int W3,
                                   void* stream) {
  return launch_stem_band(jt::PlanarU8{planar, 3 * H3, 3 * W3}, w, scale,
                          bias, out, t_in, (cudaStream_t)stream);
}
