// Fused GestSync stem for Hopper (sm_90a), float32:
//   conv3d k(5,7,7) s(1,3,3) 3->64, no padding -> BN folded into a
//   per-channel scale and bias -> ReLU -> maxpool (1,3,3)/(1,2,2)
//
// Replaces jegal_tpu/ops/pallas/stem.py:_stem_kernel, with its two entries:
// float frames (jt_stem_pool, for stem_mgrid_x) and host-repacked uint8
// planar frames (jt_stem_pool_planar, for stem_mgrid_planar: the bytes are
// converted while they are staged, the TPU kernel's u8_direct form, and the
// caller folds /255 into the weights). The TPU kernel's pair_dot flag
// schedules its dots and has no counterpart here. Like the TPU kernel, the
// conv output never reaches device memory: at 270x480 it is 88x158x64
// floats a frame (3.6 MB), four times the pooled output this kernel writes.
//
// What bounds it on the H100: operations. A 5 s clip's 148 output frames
// read 87x157 of the 88x158 conv positions a frame (the pool never reaches
// the last conv row and column): 148*87*157*64*735 = 95 G multiply-adds
// (190 GFLOP), against 0.24 GB of input frames (0.06 GB planar) and 0.13 GB
// of pooled output, so the 67 TFLOP/s float32 CUDA-core rate bounds it near
// 2.84 ms where memory bounds it near 0.1 ms.
// The design therefore spends its effort on keeping the FMA units fed from
// shared memory:
//   * a block computes one frame's tile of 4x8 pooled outputs for all 64
//     channels, i.e. a 9x17 tile of conv outputs (the pool windows overlap
//     by one conv row/column, so neighbouring tiles recompute one
//     row/column: 20% extra work in exchange for no inter-block traffic);
//   * for each of the 5 temporal taps it stages the 31x55x3 input patch and
//     the tap's 7x7x3x64 weights in shared memory (58 KB);
//   * each of the 256 threads accumulates 5 conv positions x 8 channels in
//     registers: per (dy, dx, c) tap it loads 5 inputs and two float4
//     weight vectors (broadcast across the warp) for 40 FMAs;
//   * BN scale/bias and ReLU are applied in registers, the conv tile goes
//     to shared memory, and the 3x3/2 max pool reads it there and writes
//     the pooled (t, J, W_pool, 64) rows coalesced over channels.
#include "stem.cuh"

namespace jt {

constexpr int ST_PJ = 4, ST_PI = 8;      // pooled tile (rows, cols)
constexpr int ST_CR = 2 * ST_PJ + 1;     // conv tile rows (9)
constexpr int ST_CC = 2 * ST_PI + 1;     // conv tile cols (17)
constexpr int ST_NPOS = ST_CR * ST_CC;   // 153 conv positions
constexpr int ST_IR = ST_S * (ST_CR - 1) + ST_KH;   // 31 input rows
constexpr int ST_IC = ST_S * (ST_CC - 1) + ST_KW;   // 55 input cols
constexpr int ST_IROW = ST_IC * ST_CIN;             // 165 floats a row
constexpr int ST_THREADS = 256;
constexpr int ST_PPT = 5;                // conv positions per thread
constexpr int ST_CPT = 8;                // channels per thread
constexpr int ST_XS = ST_IR * ST_IROW;   // 5115 floats
constexpr int ST_WS_OFF = (ST_XS + 3) / 4 * 4;   // 16-byte aligned weights
constexpr int ST_CS_LD = ST_C + 1;       // padded conv-tile row
constexpr int ST_SMEM_FLOATS = ST_WS_OFF + ST_WS;
constexpr size_t ST_SMEM_BYTES = sizeof(float) * ST_SMEM_FLOATS;
static_assert(ST_NPOS * ST_CS_LD <= ST_SMEM_FLOATS, "conv tile must fit");
static_assert(ST_PPT * 32 >= ST_NPOS, "positions must cover the tile");

// src: (T4, H, W, 3) frames in either input form (stem.cuh); w: (5, 7, 7,
// 3, 64) DHWIO; out: (T4-4, J, Wp, 64). grid: (ceil(Wp / 8), ceil(J / 4),
// T4 - 4)
template <class Src>
__global__ void __launch_bounds__(ST_THREADS)
stem_pool_kernel(Src src, const float* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int J, int Wp) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;            // [31][165] input patch of one frame
  float* Ws = smem + ST_WS_OFF;  // [147][64] weights of one temporal tap

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * ST_PI;   // pooled col origin
  const int j0 = blockIdx.y * ST_PJ;   // pooled row origin
  const int t = blockIdx.z;
  const int cg = tid >> 5;             // channel group: one per warp
  const int pg = tid & 31;
  const int y_in0 = 2 * ST_S * j0;     // first input row of the patch
  const int x_in0 = 2 * ST_S * i0;     // first input col

  int xoff[ST_PPT];
#pragma unroll
  for (int k = 0; k < ST_PPT; ++k) {
    const int p = min(pg + 32 * k, ST_NPOS - 1);
    xoff[k] = (ST_S * (p / ST_CC)) * ST_IROW + (ST_S * (p % ST_CC)) * ST_CIN;
  }

  float acc[ST_PPT][ST_CPT];
#pragma unroll
  for (int k = 0; k < ST_PPT; ++k)
#pragma unroll
    for (int c = 0; c < ST_CPT; ++c) acc[k][c] = 0.f;

  for (int dt = 0; dt < ST_KT; ++dt) {
    __syncthreads();  // previous tap's tiles fully consumed
    for (int i = tid; i < ST_XS; i += ST_THREADS) {
      const int rr = i / ST_IROW, q = i % ST_IROW;
      const int y = y_in0 + rr;
      const int xq = x_in0 * ST_CIN + q;   // (x, c) flattened
      Xs[i] = (y < src.H && xq < src.W * ST_CIN) ? src.at(t + dt, y, xq)
                                                 : 0.f;
    }
    const float4* wsrc =
        reinterpret_cast<const float4*>(w + (size_t)dt * ST_WS);
    float4* wdst = reinterpret_cast<float4*>(Ws);
    for (int i = tid; i < ST_WS / 4; i += ST_THREADS) wdst[i] = wsrc[i];
    __syncthreads();

    for (int dy = 0; dy < ST_KH; ++dy) {
#pragma unroll
      for (int dx = 0; dx < ST_KW; ++dx) {
#pragma unroll
        for (int c = 0; c < ST_CIN; ++c) {
          const int tap = (dy * ST_KW + dx) * ST_CIN + c;
          const float4 wa =
              *reinterpret_cast<const float4*>(&Ws[tap * ST_C + cg * ST_CPT]);
          const float4 wb = *reinterpret_cast<const float4*>(
              &Ws[tap * ST_C + cg * ST_CPT + 4]);
          const int o = dy * ST_IROW + dx * ST_CIN + c;
#pragma unroll
          for (int k = 0; k < ST_PPT; ++k) {
            const float xv = Xs[xoff[k] + o];
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

  // BN + ReLU into the conv tile (reuses the staging buffers)
  __syncthreads();
  float* Cs = smem;  // [153][65]
  float sc[ST_CPT], bi[ST_CPT];
#pragma unroll
  for (int c = 0; c < ST_CPT; ++c) {
    sc[c] = scale[cg * ST_CPT + c];
    bi[c] = bias[cg * ST_CPT + c];
  }
#pragma unroll
  for (int k = 0; k < ST_PPT; ++k) {
    const int p = pg + 32 * k;
    if (p < ST_NPOS) {
#pragma unroll
      for (int c = 0; c < ST_CPT; ++c)
        Cs[p * ST_CS_LD + cg * ST_CPT + c] =
            fmaxf(fmaf(acc[k][c], sc[c], bi[c]), 0.f);
    }
  }
  __syncthreads();

  // 3x3 stride-2 max pool, one (pooled position, channel) per step
  for (int q = tid; q < ST_PJ * ST_PI * ST_C; q += ST_THREADS) {
    const int o = q % ST_C;
    const int pos = q / ST_C;
    const int pj = pos / ST_PI, pi = pos % ST_PI;
    const int j = j0 + pj, i = i0 + pi;
    if (j >= J || i >= Wp) continue;
    float v = -INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        v = fmaxf(v, Cs[((2 * pj + a) * ST_CC + 2 * pi + b) * ST_CS_LD + o]);
    out[(((size_t)t * J + j) * Wp + i) * ST_C + o] = v;
  }
}

}  // namespace jt

template <class Src>
static int launch_stem_pool(Src src, const float* w, const float* scale,
                            const float* bias, float* out, int t_in,
                            cudaStream_t stream) {
  using namespace jt;
  const int J = stem_pooled(src.H), Wp = stem_pooled(src.W);
  if (t_in < ST_KT || J < 1 || Wp < 1) return JT_ERR_SHAPE;
  cudaError_t e = cudaFuncSetAttribute(
      stem_pool_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ST_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Wp + ST_PI - 1) / ST_PI, (J + ST_PJ - 1) / ST_PJ, t_in - 4);
  stem_pool_kernel<Src><<<grid, ST_THREADS, ST_SMEM_BYTES, stream>>>(
      src, w, scale, bias, out, J, Wp);
  JT_CHECK_LAUNCH();
  return 0;
}

// frames (t_in, H, W, 3) float32 -> out (t_in - 4, J, Wp, 64), with
// J = ((H - 7) / 3 + 1 - 3) / 2 + 1 and Wp likewise from W.
extern "C" int jt_stem_pool(const float* frames, const float* w,
                            const float* scale, const float* bias, float* out,
                            int t_in, int H, int W, void* stream) {
  return launch_stem_pool(jt::FloatFrames{frames, H, W}, w, scale, bias, out,
                          t_in, (cudaStream_t)stream);
}

// planar (t_in, H3, 27, W3) uint8 -> out (t_in - 4, J, Wp, 64) for the raw
// frame 3 H3 x 3 W3; w is pre-scaled by 1/255.
extern "C" int jt_stem_pool_planar(const uint8_t* planar, const float* w,
                                   const float* scale, const float* bias,
                                   float* out, int t_in, int H3, int W3,
                                   void* stream) {
  return launch_stem_pool(jt::PlanarU8{planar, 3 * H3, 3 * W3}, w, scale,
                          bias, out, t_in, (cudaStream_t)stream);
}
