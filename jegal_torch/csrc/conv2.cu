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
//
// conv2_bf16_kernel is its bf16 variant (kernel 7b), a Hopper design of
// its own; see the note above it below.
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

// ---------------------------------------------------------------------------
// Kernel 7b: the bf16 variant (the JAX engine's bf16 dtype; the Pallas
// kernel in bf16, conv2.py:115-140): x (T, J, Wp, 64) and w (1600, 128)
// bf16, the products summed in float32, the folded scale and bias and the
// ReLU in float32, out (T, 128, J2, W2) bf16, rounded once.
//
// Bound: operations, 44.9 GFLOP at 989 TFLOP/s, 0.045 ms, against 64 + 28
// MB of bytes (0.027 ms). What the card moves is larger: the gather reads
// each input pixel for ~6.25 positions (the im2col rows, 350 MB at the 5 s
// clip, from L2) and every tile reads the whole 400 KB weight (B) again.
//
// The design, on gemm.cuh's wgmma machinery:
//  * Product: wgmma m64n128k16 bf16 (N = 128 = every output channel),
//    CB_WGS consumer warpgroups each over 64 of a tile's CB_BM positions,
//    float32 sums in registers, one chain through K = 1600 (what the bf16
//    product of gemm.cuh does; it holds 1 bf16 ulp at K 3072).
//  * Stages: 64 deep, exactly one (kh, kw) tap, so a position's A row of a
//    stage is the stem output's 128 contiguous bytes at x + ((f J + 2 j2 +
//    kh) Wp + 2 w2 + kw) 64: one row of the 128-byte swizzle; K is 25
//    stages.
//  * A: a producer warpgroup gathers each stage with 16-byte cp.async into
//    the swizzled slots (chunk c of row r at c ^ (r % 8)), eight lanes a
//    row so each warp request reads 4 whole rows; rows past M zero-filled.
//    A producer thread keeps CB_LAG stages of copies in flight, then
//    waits for the oldest, fences it to the async proxy that wgmma reads
//    through (fence.proxy.async) and arrives on that stage's `full`
//    mbarrier.
//  * B: the (1600, 128) weight by TMA, two 64-column boxes a stage in the
//    128-byte swizzle (MN-major, transpose-B), onto the same `full`
//    barrier, as gemm_wg_kernel loads B.
//  * Each consumer warpgroup waits for `full`, issues the stage's four
//    wgmma, and releases the stage before (`empty`) once this one's are
//    issued and that one's done.
//  * Persistent: one block an SM walks tiles b, b + grid, ...; the
//    producer runs ahead into the next tile's stages while the consumers
//    run the epilogue. At the 5 s clip (M 109,520) that is 856 tiles, 6.5
//    an SM: 64 SMs take 7.
//  * Epilogue: scale, bias and ReLU on the sums in registers, bf16 into a
//    transposed tile in shared memory [channel][position], then each warp
//    stores whole channels as coalesced runs of positions into the NCHW
//    output (a run split at a frame's edge), as the float32 kernel does.
//  * No atomics: a relaunch gives the same bits.
// The built tile (probed on the H100 against 3 consumer warpgroups, 4
// stages, copies through L1 and a lag of 3, none faster): CB_WGS consumer
// warpgroups of 64 positions and one producer warpgroup; per stage A
// (CB_BM rows of 128 bytes) and B (two 64-column blocks of 64 k rows);
// the transposed output tile; the folded scale and bias; the barriers.
constexpr int CB_WGS = 2;
constexpr int CB_BM = 64 * CB_WGS;
constexpr int CB_NT = 128 * (CB_WGS + 1);
constexpr int CB_STAGES = 5;
constexpr int CB_LAG = 2;      // stages of copies a producer keeps in flight
constexpr int CB_A_STAGE = CB_BM * WG_ROW;
constexpr int CB_B_STAGE = (C2_COUT / 64) * WG_NBLK;
constexpr int CB_STAGE = CB_A_STAGE + CB_B_STAGE;
constexpr int CB_TS = CB_BM + 8;                // a channel's row of the tile
constexpr int CB_OUT = C2_COUT * CB_TS * 2;     // the transposed tile, bytes
constexpr int CB_SMEM = 1024 + CB_STAGES * CB_STAGE + CB_OUT +
                        2 * C2_COUT * 4 + 2 * CB_STAGES * 8;
constexpr int CB_COPIES = CB_BM * 8 / 128;      // a producer thread's a stage
constexpr int C2_TAPS = C2_K * C2_K;
static_assert(C2_CIN * 2 == WG_ROW, "a tap's channels are one 128-byte row");
// a stage is released once the next one's products are issued, so the
// producer must be able to mark that one full without waiting
static_assert(CB_STAGES >= CB_LAG + 2, "the ring holds the copies in flight");
static_assert(CB_SMEM <= 232448, "fits an SM");

// grid: min(tiles, SMs); tm_w: the weight as (1600, 128) in 64 x 64 boxes.
__global__ void __launch_bounds__(CB_NT, 1)
conv2_bf16_kernel(const __grid_constant__ CUtensorMap tm_w,
                  const uint16_t* __restrict__ x,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, uint16_t* __restrict__ out,
                  int T, int J, int Wp, int J2, int W2) {
  constexpr int BM = CB_BM, TS = CB_TS, STAGES = CB_STAGES, WGS = CB_WGS;
  extern __shared__ uint8_t c2_smem[];
  uint8_t* smem = c2_smem + ((1024 - (smem_u32(c2_smem) & 1023)) & 1023);
  uint16_t* ts = reinterpret_cast<uint16_t*>(smem + STAGES * CB_STAGE);
  float* sc = reinterpret_cast<float*>(smem + STAGES * CB_STAGE + CB_OUT);
  float* bi = sc + C2_COUT;
  uint64_t* full = reinterpret_cast<uint64_t*>(bi + C2_COUT);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int plane = J2 * W2;
  const int M = T * plane;
  const int tiles = (M + BM - 1) / BM;
  if (tid < C2_COUT) {
    sc[tid] = scale[tid];
    bi[tid] = bias[tid];
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 128 + 1);    // the producers, and B's bytes
      mbar_init(empty + s, 4 * WGS);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WGS) {   // the producer warpgroup
    const int pt = tid - 128 * WGS;
    const int r0 = pt >> 3, chunk = pt & 7;   // rows r0 + 16 i, one chunk
    const int sw = ((chunk ^ (r0 & 7)) << 4);  // its swizzled slot in a row
    const uint16_t* src[CB_COPIES];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
      for (int i = 0; i < CB_COPIES; ++i) {
        const int m = tile * BM + r0 + 16 * i;
        src[i] = nullptr;
        if (m < M) {
          const int f = m / plane, p = m - f * plane;
          const int j2 = p / W2, w2 = p - j2 * W2;
          src[i] = x + (((size_t)f * J + C2_S * j2) * Wp + C2_S * w2) * C2_CIN +
                   8 * chunk;
        }
      }
      for (int tap = 0; tap < C2_TAPS; ++tap, ++it) {
        const int stage = it % STAGES;
        mbar_wait(empty + stage, ((it / STAGES) & 1) ^ 1);
        uint8_t* as = smem + stage * CB_STAGE;
        if (pt == 0) {
          mbar_expect_tx(full + stage, CB_B_STAGE);
#pragma unroll
          for (int b = 0; b < C2_COUT / 64; ++b)
            tma_load(as + CB_A_STAGE + b * WG_NBLK, &tm_w, full + stage,
                     64 * b, tap * C2_CIN);
        }
        const int off = ((tap / C2_K) * Wp + tap % C2_K) * C2_CIN;
#pragma unroll
        for (int i = 0; i < CB_COPIES; ++i)
          cp_async16b(as + (r0 + 16 * i) * WG_ROW + sw,
                      src[i] != nullptr ? src[i] + off : x, src[i] != nullptr);
        cp_async_commit();
        if (it >= CB_LAG) {
          cp_async_wait<CB_LAG>();
          fence_proxy_async();
          mbar_arrive(full + (it - CB_LAG) % STAGES);
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int j = it > CB_LAG ? it - CB_LAG : 0; j < it; ++j)
      mbar_arrive(full + j % STAGES);
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    int prev = -1;
    for (int tap = 0; tap < C2_TAPS; ++tap, ++it) {
      const int stage = it % STAGES;
      mbar_wait(full + stage, (it / STAGES) & 1);
      const uint8_t* as = smem + stage * CB_STAGE;
      const uint64_t da = wgmma_desc_sw128(as + wg * 64 * WG_ROW, 0, 1024);
      const uint64_t db = wgmma_desc_sw128(as + CB_A_STAGE, WG_NBLK, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)   // A: 32 bytes on; B: 16 rows
        wgmma_ss_bf16(acc, da + 2 * kk, db + 128 * kk, true);
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's products are done
      if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
      prev = stage;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + prev);
#pragma unroll
    for (int e = 0; e < 64; ++e) wgmma_pin(acc[e]);

    // the previous tile's stores are done with the transposed tile
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WGS) : "memory");
    // element e of n8 tile j: position 64 wg + 16 (warp % 4) + g + 8 (e >>
    // 1), channel 8 j + 2 t + (e & 1)
    const int r = 64 * wg + 16 * (warp & 3) + g;
#pragma unroll
    for (int j = 0; j < C2_COUT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 8 * j + 2 * t + (e & 1);
        ts[n * TS + r + 8 * (e >> 1)] =
            f2bf(fmaxf(fmaf(acc[4 * j + e], sc[n], bi[n]), 0.f));
      }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WGS) : "memory");

    // lane's positions m0 + lane + 32 u: their offsets in a channel's plane
    const int m0 = tile * BM;
    size_t at[BM / 32];
    bool ok[BM / 32];
#pragma unroll
    for (int u = 0; u < BM / 32; ++u) {
      const int m = m0 + lane + 32 * u;
      const int f = m / plane;
      ok[u] = m < M;
      at[u] = (size_t)f * C2_COUT * plane + (m - f * plane);
    }
    for (int n = warp; n < C2_COUT; n += 4 * WGS)
#pragma unroll
      for (int u = 0; u < BM / 32; ++u)
        if (ok[u]) out[at[u] + (size_t)n * plane] = ts[n * TS + lane + 32 * u];
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

cudaError_t c2b_prepare() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      jt::conv2_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      jt::CB_SMEM);
  return attr;
}

int c2b_launch(const uint16_t* x, const uint16_t* w, const float* scale,
               const float* bias, uint16_t* out, int T, int J, int Wp,
               cudaStream_t s) {
  using namespace jt;
  cudaError_t e = c2b_prepare();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tm;
  if (!bf16_tensor_map(&tm, w, C2_KDIM, C2_COUT, WG_BK))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int J2 = (J - C2_K) / C2_S + 1, W2 = (Wp - C2_K) / C2_S + 1;
  const long long tiles = ((long long)T * J2 * W2 + CB_BM - 1) / CB_BM;
  const int grid = (int)(tiles < sms ? tiles : sms);
  conv2_bf16_kernel<<<grid, CB_NT, CB_SMEM, s>>>(tm, x, scale, bias, out, T,
                                                 J, Wp, J2, W2);
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

// x (T, J, Wp, 64) bf16 -> out (T, 128, J2, W2) bf16, as jt_conv2; w
// (5, 5, 64, 128) bf16, scale and bias float32.
extern "C" int jt_conv2_bf16(const uint16_t* x, const uint16_t* w,
                             const float* scale, const float* bias,
                             uint16_t* out, int T, int J, int Wp,
                             void* stream) {
  using namespace jt;
  if (T < 1 || J < C2_K || Wp < C2_K) return JT_ERR_SHAPE;
  if (!aligned16(x) || !aligned16(w)) return JT_ERR_SHAPE;
  const int rc =
      c2b_launch(x, w, scale, bias, out, T, J, Wp, (cudaStream_t)stream);
  if (rc != 0) return rc;
  JT_CHECK_LAUNCH();
  return 0;
}

// kernel 7b's {registers, spill bytes, shared memory, blocks an SM} on the
// current card
extern "C" int jt_conv2_bf16_info(int* info) {
  const void* fn = (const void*)jt::conv2_bf16_kernel;
  cudaError_t e = c2b_prepare();
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, jt::CB_NT,
                                                      jt::CB_SMEM);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = jt::CB_SMEM;
  info[3] = blocks;
  return 0;
}
