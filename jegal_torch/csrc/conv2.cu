// GestSync block 2 for Hopper (sm_90a), float32: conv k(5,5) s(2,2)
// 64->128 without padding, conv bias and BatchNorm folded into a
// per-channel scale and bias, ReLU.
//
// Replaces jegal_tpu/ops/pallas/conv2.py:_conv2_kernel (reached through
// mgrid_conv2_fused). The TPU kernel's selection matmul and its even/odd
// phase split exist to undo the stem's m-grid, whose pooled columns sit at
// every other lane; the port's stem writes dense (T, J, Wp, 64), so what is
// left is an implicit-GEMM convolution:
//   M = output positions (T * J2 * W2: 740 a 270x480 frame),
//   N = 128 channels, K = 5 * 5 * 64 = 1600 in (kh, kw, c) order.
//
// Bound: operations. A 5 s clip (148 frames, J 43, Wp 78 -> J2 20, W2 37)
// is 2*148*740*128*1600 = 44.9 GFLOP. In 3xTF32 on the tensor cores (three
// TF32 products per float32 one at 495 TFLOP/s) that is 0.272 ms; all in
// float32 on the CUDA cores (67 TFLOP/s) 0.670 ms; its bytes (127 MB in,
// 56 MB out, 0.8 MB of weights) take 0.055 ms.
//
// The design runs the product on the shared GEMM's mainloop (gemm.cuh,
// tc_product) at its 128x128 tile, 8 warps, a ceil(M / 128) grid:
//  * 3xTF32 mma.sync fed by the 4-stage cp.async ring of BK = 32. A stage
//    lies inside one (kh, kw) tap and half of its 64 channels, so each
//    position's A row of a stage is 128 contiguous bytes of the stem
//    output at xpos + (kh * Wp + kw) * 64 + c0: the loader gathers it with
//    8 16-byte copies and the im2col matrix (700 MB for a 5 s clip) is
//    never written. Positions past M are zero-filled. B is the (1600, 128)
//    HWIO weight, the GEMM's own B operand.
//  * Each stage's products start from zero and are added to a float32 sum:
//    K = 1600 is 50 stages, the chain length at which the tensor cores'
//    truncation drifted in the encoder kernels (gemm.cuh).
//  * The epilogue writes NCHW (T, 128, J2, W2), the layout block 3's cuDNN
//    convolution reads, where neighbouring positions of one channel are
//    neighbouring addresses. The tile goes through shared memory as
//    (channel, position), and each warp stores a channel's 128 positions
//    as four coalesced 32-float runs; a tile that straddles two frames
//    splits a run at the frame's edge. Stored straight from the fragments,
//    neighbouring lanes would write 740 floats apart.
#include "gemm.cuh"

namespace jt {

constexpr int C2_CIN = 64, C2_COUT = 128, C2_K = 5, C2_S = 2;
constexpr int C2_KDIM = C2_K * C2_K * C2_CIN;   // 1600
constexpr int C2_BM = 128, C2_BN = 128;
constexpr int C2_TS = C2_BM + 4;   // transposed tile rows (bank-conflict free)
using C2Tile = Tile<C2_BM, C2_BN>;
static_assert(C2_COUT == C2_BN, "one tile spans all output channels");
static_assert(C2_CIN % TC_BK == 0, "a stage stays inside one tap");
static_assert(C2_KDIM % TC_BK == 0, "no ragged stage");
static_assert(C2_COUT * C2_TS * 4 <= tile_smem_bytes<C2_BM, C2_BN>(),
              "the transposed tile fits in the ring");

// x: (T, J, Wp, 64) NHWC; w: (5, 5, 64, 128) HWIO, i.e. (1600, 128);
// out: (T, 128, J2, W2) NCHW. grid: ceil(T * J2 * W2 / 128)
__global__ void __launch_bounds__(C2Tile::NT)
conv2_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             float* __restrict__ out, int T, int J, int Wp, int J2, int W2) {
  using TL = C2Tile;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / TL::WN) * TL::MF * 16;
  const int wn0 = (warp % TL::WN) * TL::NF * 8;
  const int plane = J2 * W2;
  const int M = T * plane;
  const int m0 = blockIdx.x * C2_BM;

  // the top-left input pixel of each position whose A row this thread
  // copies (null past M)
  const float* rows[TL::A_COPIES];
#pragma unroll
  for (int i = 0; i < TL::A_COPIES; ++i) {
    int r, kc;
    a_copy_slot<C2_BM, C2_BN>(i, r, kc);
    const int m = m0 + r;
    rows[i] = nullptr;
    if (m < M) {
      const int f = m / plane, p = m - f * plane;
      const int j2 = p / W2, w2 = p - j2 * W2;
      rows[i] = x + (((size_t)f * J + C2_S * j2) * Wp + C2_S * w2) * C2_CIN;
    }
  }
  auto load_a = [&](float* as, int i, int k0) {
    int r, kc;
    a_copy_slot<C2_BM, C2_BN>(i, r, kc);
    const int tap = k0 / C2_CIN, c0 = k0 % C2_CIN;
    const int off = ((tap / C2_K) * Wp + tap % C2_K) * C2_CIN + c0 + kc;
    const bool ok = rows[i] != nullptr;
    cp_async16(as + r * TL::AS + kc, ok ? rows[i] + off : x, ok);
  };
  float sum[TL::MF][TL::NF][4];
  tc_product<C2_BM, C2_BN>(smem, load_a, w, C2_COUT, 0, 0, C2_KDIM, sum);
  __syncthreads();   // every warp is done with the ring: it holds the tile

  float* ts = smem;  // [channel][position]
#pragma unroll
  for (int i = 0; i < TL::MF; ++i)
#pragma unroll
    for (int j = 0; j < TL::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ts[(wn0 + j * 8 + 2 * t + (e & 1)) * C2_TS + wm0 + i * 16 + g +
           8 * (e >> 1)] = sum[i][j][e];
  __syncthreads();

  // lane's positions m0 + lane + 32 u: their offsets in a channel's planes
  size_t at[C2_BM / 32];
  bool ok[C2_BM / 32];
#pragma unroll
  for (int u = 0; u < C2_BM / 32; ++u) {
    const int m = m0 + lane + 32 * u;
    const int f = m / plane;
    ok[u] = m < M;
    at[u] = (size_t)f * C2_COUT * plane + (m - f * plane);
  }
  for (int n = warp; n < C2_COUT; n += TL::NT / 32) {
    const float sc = scale[n], bi = bias[n];
#pragma unroll
    for (int u = 0; u < C2_BM / 32; ++u)
      if (ok[u])
        out[at[u] + (size_t)n * plane] =
            fmaxf(fmaf(ts[n * C2_TS + lane + 32 * u], sc, bi), 0.f);
  }
}

}  // namespace jt

namespace {

int conv2_launch(const float* x, const float* w, const float* scale,
                 const float* bias, float* out, int T, int J, int Wp, int J2,
                 int W2, cudaStream_t s) {
  using namespace jt;
  constexpr int SMEM = tile_smem_bytes<C2_BM, C2_BN>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const long long M = (long long)T * J2 * W2;
  const dim3 grid((unsigned)((M + C2_BM - 1) / C2_BM));
  conv2_kernel<<<grid, C2Tile::NT, SMEM, s>>>(x, w, scale, bias, out, T, J,
                                              Wp, J2, W2);
  return 0;
}

}  // namespace

// x (T, J, Wp, 64) float32 -> out (T, 128, J2, W2), J2 = (J - 5) / 2 + 1,
// W2 = (Wp - 5) / 2 + 1; x and w 16-byte aligned.
extern "C" int jt_conv2(const float* x, const float* w, const float* scale,
                        const float* bias, float* out, int T, int J, int Wp,
                        void* stream) {
  using namespace jt;
  if (T < 1 || J < C2_K || Wp < C2_K) return JT_ERR_SHAPE;
  if (!aligned16(x) || !aligned16(w)) return JT_ERR_SHAPE;
  const int J2 = (J - C2_K) / C2_S + 1, W2 = (Wp - C2_K) / C2_S + 1;
  const int rc = conv2_launch(x, w, scale, bias, out, T, J, Wp, J2, W2,
                              (cudaStream_t)stream);
  if (rc != 0) return rc;
  JT_CHECK_LAUNCH();
  return 0;
}
