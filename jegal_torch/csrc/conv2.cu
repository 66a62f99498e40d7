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
//   N = 128 channels, K = 5 * 5 * 64 = 1600 in (kh, kw, c) order,
// on the register-blocked 128x128 f32 tile of ffma_tile.cuh. A K-step of 8 lies
// inside one (kh, kw) tap, so each thread loads its A values as one float4
// of 4 channels straight from the stem output: the im2col matrix (700 MB
// for a 5 s clip) is never materialised. The epilogue applies the scale,
// the bias and ReLU, and writes NCHW (T, 128, J2, W2), the layout block 3's
// cuDNN convolution reads.
//
// Bound: operations. A 5 s clip (148 frames, J 43, Wp 78 -> J2 20, W2 37)
// is 2*148*740*128*1600 = 44.9 GFLOP, 0.67 ms at the 67 TFLOP/s float32
// rate; its bytes (127 MB in, 56 MB out, 0.8 MB of weights) take 0.055 ms.
#include "ffma_tile.cuh"

namespace jt {

constexpr int C2_CIN = 64, C2_COUT = 128, C2_K = 5, C2_S = 2;
constexpr int C2_KDIM = C2_K * C2_K * C2_CIN;   // 1600
static_assert(C2_COUT == GEMM_BN, "one tile spans all output channels");
static_assert(C2_CIN % GEMM_BK == 0, "a K-step stays inside one tap");

// x: (T, J, Wp, 64) NHWC; w: (5, 5, 64, 128) HWIO, i.e. (1600, 128);
// out: (T, 128, J2, W2) NCHW. grid: ceil(T * J2 * W2 / 128)
__global__ void __launch_bounds__(GEMM_THREADS)
conv2_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             float* __restrict__ out, int T, int J, int Wp, int J2, int W2) {
  __shared__ __align__(16) float As[GEMM_BK][GEMM_BM];
  __shared__ __align__(16) float Bs[GEMM_BK][GEMM_BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int plane = J2 * W2;
  const int M = T * plane;
  const int row0 = blockIdx.x * GEMM_BM;
  // loaders: A as 128 positions x 2 quads of channels, B as 8 rows x 32
  // quads of output channels
  const int a_r = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int b_k = tid >> 5;
  const int b_c = (tid & 31) * 4;
  const int m = row0 + a_r;
  const float* xpos = nullptr;   // the position's top-left input pixel
  if (m < M) {
    const int t = m / plane, j2 = (m % plane) / W2, w2 = m % W2;
    xpos = x + (((size_t)t * J + C2_S * j2) * Wp + C2_S * w2) * C2_CIN;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C2_KDIM; k0 += GEMM_BK) {
    const int tap = k0 / C2_CIN, c0 = k0 % C2_CIN;
    const int kh = tap / C2_K, kw = tap % C2_K;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (xpos != nullptr)
      a = *reinterpret_cast<const float4*>(
          xpos + ((size_t)kh * Wp + kw) * C2_CIN + c0 + a_k);
    As[a_k + 0][a_r] = a.x;
    As[a_k + 1][a_r] = a.y;
    As[a_k + 2][a_r] = a.z;
    As[a_k + 3][a_r] = a.w;
    *reinterpret_cast<float4*>(&Bs[b_k][b_c]) =
        *reinterpret_cast<const float4*>(w + (size_t)(k0 + b_k) * C2_COUT
                                         + b_c);
    __syncthreads();
    gemm_tile_step(As, Bs, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + gemm_tile_index(i, ty);
    if (r >= M) continue;
    const int t = r / plane, pos = r % plane;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = gemm_tile_index(j, tx);
      out[((size_t)t * C2_COUT + n) * plane + pos] =
          fmaxf(fmaf(acc[i][j], scale[n], bias[n]), 0.f);
    }
  }
}

}  // namespace jt

// x (T, J, Wp, 64) float32 -> out (T, 128, J2, W2), J2 = (J - 5) / 2 + 1,
// W2 = (Wp - 5) / 2 + 1; x and w 16-byte aligned.
extern "C" int jt_conv2(const float* x, const float* w, const float* scale,
                        const float* bias, float* out, int T, int J, int Wp,
                        void* stream) {
  using namespace jt;
  if (T < 1 || J < C2_K || Wp < C2_K) return JT_ERR_SHAPE;
  const int J2 = (J - C2_K) / C2_S + 1, W2 = (Wp - C2_K) / C2_S + 1;
  const long long M = (long long)T * J2 * W2;
  dim3 grid((unsigned)((M + GEMM_BM - 1) / GEMM_BM));
  conv2_kernel<<<grid, GEMM_THREADS, 0, (cudaStream_t)stream>>>(
      x, w, scale, bias, out, T, J, Wp, J2, W2);
  JT_CHECK_LAUNCH();
  return 0;
}
