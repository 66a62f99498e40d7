// Blockwise (flash-style) multi-head attention for Hopper (sm_90a), float32
// in and out, its two products on the tensor cores in 3xTF32.
//
// Replaces jegal_tpu/ops/pallas/flash_attention.py:_make_kernel (called by
// `flash_attention`, :113-146). q, k, v and out are contiguous (B, H, T, D),
// 16-byte aligned; mask is a (B, T) key validity (0.0 = masked) or null.
// The TPU kernel's semantics are kept exactly:
//   * q is multiplied by `scale` (1/sqrt(D), rounded to float32 by the
//     caller) before the QK^T product;
//   * a masked key's score is FILLED with -1e9 (not -inf);
//   * the online softmax keeps its running max, sum and accumulator in
//     float32, the running max starting at -2e9. A row whose keys are all
//     masked then sees every score at -1e9 and averages V uniformly over
//     its T keys, as the dense softmax does.
// Keys past T (the ragged last tile) take no part at all: score -inf, p 0.
//
// What bounds it on the H100: 4*B*H*T^2*D operations of products against
// 16*B*H*T*D bytes. In 3xTF32 (three TF32 products per float32 one at 495
// TFLOP/s) the long clip's (1, 8, 1024, 64) is 0.013 ms of operations and
// 0.0025 of bytes; in float32 on the CUDA cores (67 TFLOP/s) 0.032 ms. Why
// 3xTF32 and not one TF32 pass: one pass keeps 10 mantissa bits and leaves
// ~1.5e-3 on products of these widths (tests/test_torch_gemm.py), over the
// port's 1e-4 bar; splitting each operand as hi = tf32(x), lo = tf32(x -
// hi) and summing lo*hi, hi*lo, hi*hi keeps float32 accuracy.
//
// The design:
//  * A block is 4 warps over 32 query rows of one (b, h): warps 0-1 own
//    rows 0-15 and 16-31 (the m16 of mma.sync.m16n8k8) for the first 16
//    keys of every 32-key tile, warps 2-3 the same rows for the other 16.
//    Each half keeps its own running max, sum and accumulator, and the two
//    merge once at the end; so (8, 8, 128, 64) and (1, 8, 1024, 64) are
//    256 blocks of 4 warps each, all resident at once.
//  * K, V and the tile's mask stream through a 2-stage cp.async ring (the
//    next tile's copies fly while the warps compute on this one). A third
//    stage bought nothing at T = 128 and 1024 and was slower at T = 256,
//    where the smaller ring (43 KB at D 64) keeps more blocks an SM.
//    Each key row is D / 4 16-byte copies, each mask value one 4-byte copy
//    (zero-filled past T), so no score reads global memory. K rows are
//    padded to D + 4 floats, so the B fragment of S = Q K^T (key g, column
//    t) hits 32 banks; V rows too (see P below). Q (32 rows, D + 4) is
//    copied once and split into hi and lo at each use.
//  * S = (q * scale) K^T in 3xTF32, each 32 columns of D started from zero
//    and added to a float32 sum. On the accumulator fragment, in
//    registers: the fill, the row max over the quad (shuffles over t),
//    expf, the correction factor and the row sum.
//  * P feeds O += P V without moving: an mma sums over its 8 k indices in
//    any order, so the A fragment's column t is taken as key 2t and column
//    t + 4 as key 2t + 1 -- exactly the accumulator's (g, 2t), (g, 2t+1) --
//    and the B fragment reads V rows 2t and 2t + 1 (with rows D + 4 apart
//    those hit 32 banks as well).
//  * The per-tile flush: each tile's P V starts from zero and is added in
//    float32 to the rescaled O * corr, as the TPU kernel adds its dot. A
//    1024-key clip chained through one mma accumulator would drift: the
//    tensor cores truncate as they accumulate (gemm.cuh).
//  * The end: the halves merge through shared memory, O is divided by l,
//    and each quad writes 32 contiguous bytes of a row (float2 stores).
//
// jt_flash_attention_bf16 is the bf16 variant (kernel 6b), a design of its
// own; see the note under "Kernel 6b" below.
#include <math.h>

#include "gemm.cuh"

namespace {

using jt::cp_async16;
using jt::cp_async16b;
using jt::cp_async4;
using jt::mma_bf16;
using jt::mma_tf32;
using jt::split_tf32;

constexpr int FA_QT = 32;                 // query rows per block
constexpr int FA_KT = 32;                 // keys per ring stage
constexpr int FA_KH = FA_KT / 2;          // keys per warp per stage
constexpr int FA_WARPS = 4;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_STAGES = 2;
constexpr float NEG_FILL = -1e9f;         // flash_attention.py:27

// Shared memory of one block, in floats: Q, then the ring's stages of K
// rows, V rows and the tile's mask.
template <int D>
struct FaSmem {
  static constexpr int RS = D + 4;                    // row stride
  static constexpr int Q = FA_QT * RS;
  static constexpr int KV = 2 * FA_KT * RS;            // K, V of a stage
  static constexpr int STAGE = KV + FA_KT;
  static constexpr int BYTES = (Q + FA_STAGES * STAGE) * 4;
};

// grid: (B * H, ceil(T / 32)).
template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_fwd(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int H, int T, float scale) {
  using SM = FaSmem<D>;
  constexpr int RS = SM::RS, NF = D / 8, KS = D / 8;
  constexpr int ROW_COPIES = D / 4;                  // 16-byte copies a row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + SM::Q;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qg = warp & 1, half = warp >> 1;         // query rows, key half
  const int bh = blockIdx.x;                         // b * H + h
  const int q0 = blockIdx.y * FA_QT;
  const size_t base = (size_t)bh * T * D;
  const float* mrow = mask != nullptr ? mask + (size_t)(bh / H) * T : nullptr;
  const int ntiles = (T + FA_KT - 1) / FA_KT;

  for (int c = tid; c < FA_QT * ROW_COPIES; c += FA_THREADS) {
    const int r = c / ROW_COPIES, cc = (c % ROW_COPIES) * 4;
    const bool ok = q0 + r < T;
    cp_async16(Qs + r * RS + cc,
               ok ? q + base + (size_t)(q0 + r) * D + cc : q, ok);
  }
  auto load_tile = [&](int stage, int tile) {
    float* ks = ring + stage * SM::STAGE;
    float* vs = ks + FA_KT * RS;
    const int k0 = tile * FA_KT;
    for (int c = tid; c < FA_KT * ROW_COPIES; c += FA_THREADS) {
      const int r = c / ROW_COPIES, cc = (c % ROW_COPIES) * 4;
      const bool ok = k0 + r < T;
      const size_t at = base + (size_t)(k0 + r) * D + cc;
      cp_async16(ks + r * RS + cc, ok ? k + at : k, ok);
      cp_async16(vs + r * RS + cc, ok ? v + at : v, ok);
    }
    if (mrow != nullptr && tid < FA_KT) {
      const bool ok = k0 + tid < T;
      cp_async4(ks + SM::KV + tid, ok ? mrow + k0 + tid : mrow, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < FA_STAGES - 1; ++s) {   // Q joins the first group
    if (s < ntiles) load_tile(s, s);
    jt::cp_async_commit();
  }

  // rows g and g + 8 of the warp's 16: running max and (this thread's
  // share of the) sum
  float m[2] = {2.f * NEG_FILL, 2.f * NEG_FILL}, l[2] = {0.f, 0.f};
  float o[NF][4];                             // flash_attention.py:68-70
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const float* qa = Qs + (qg * 16 + g) * RS + t;

  for (int tile = 0; tile < ntiles; ++tile) {
    jt::cp_async_wait<FA_STAGES - 2>();
    __syncthreads();   // the tile's copies visible; tile - 1's stage free
    const int next = tile + FA_STAGES - 1;
    if (next < ntiles) load_tile(next % FA_STAGES, next);
    jt::cp_async_commit();

    const float* stage = ring + (tile % FA_STAGES) * SM::STAGE;
    const float* ks = stage + half * FA_KH * RS;     // the warp's 16 keys
    const float* vs = ks + FA_KT * RS;
    const float* ms = stage + SM::KV + half * FA_KH;
    const int kbase = tile * FA_KT + half * FA_KH;

    // S = (q * scale) K^T over the warp's 16 keys (two n8 tiles)
    float s[2][4], part[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < KS; c0 += 4) {       // 32 columns of D a flush
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
      for (int kk = c0; kk < c0 + 4 && kk < KS; ++kk) {
        uint32_t ahi[4], alo[4], bhi[2][2], blo[2][2];
        const float* p = qa + kk * 8;
        split_tf32(p[0] * scale, ahi[0], alo[0]);
        split_tf32(p[8 * RS] * scale, ahi[1], alo[1]);
        split_tf32(p[4] * scale, ahi[2], alo[2]);
        split_tf32(p[8 * RS + 4] * scale, ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* b = ks + (j * 8 + g) * RS + kk * 8 + t;
          split_tf32(b[0], bhi[j][0], blo[j][0]);
          split_tf32(b[4], bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_tf32(part[j], alo, bhi[j]);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_tf32(part[j], ahi, blo[j]);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_tf32(part[j], ahi, bhi[j]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
    }

    // fill, row max, p, correction, row sum: element e of n-tile j is
    // row g + 8 (e >> 1), key kbase + 8 j + 2 t + (e & 1)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        float x = s[j][e];
        if (kbase + key >= T)
          x = -INFINITY;
        else if (mrow != nullptr && ms[key] == 0.f)
          x = NEG_FILL;
        s[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);   // finite: m starts finite
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);   // -inf -> 0
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // O = O * corr + P V; P's A fragment for keys 8 kk.. is s[kk] itself
    // (column t = key 2t, column t + 4 = key 2t + 1)
    uint32_t phi[2][4], plo[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      split_tf32(s[kk][0], phi[kk][0], plo[kk][0]);
      split_tf32(s[kk][2], phi[kk][1], plo[kk][1]);
      split_tf32(s[kk][1], phi[kk][2], plo[kk][2]);
      split_tf32(s[kk][3], phi[kk][3], plo[kk][3]);
    }
#pragma unroll
    for (int j0 = 0; j0 < NF; j0 += 4) {        // 4 n8 tiles of D at a time
      float pv[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* b = vs + (kk * 8 + 2 * t) * RS + (j0 + j) * 8 + g;
          split_tf32(b[0], bhi[j][0], blo[j][0]);
          split_tf32(b[RS], bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(pv[j], plo[kk], bhi[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(pv[j], phi[kk], blo[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(pv[j], phi[kk], bhi[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[j0 + j][e] = fmaf(o[j0 + j][e], corr[e >> 1], pv[j][e]);
    }
  }
  jt::cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring

#pragma unroll
  for (int h = 0; h < 2; ++h) {   // the row's sum over the quad
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // merge the key halves: warps 2-3 hand (m, l, o) to warps 0-1 in
  // fragment order, lane for lane (an odd stride: no bank conflicts)
  constexpr int XS = 4 * NF + 5;
  static_assert(64 * XS <= FA_STAGES * SM::STAGE,
                "the exchange fits in the ring");
  float* x = ring + (qg * 32 + lane) * XS;
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[4 * j + e] = o[j][e];
    x[4 * NF] = m[0];
    x[4 * NF + 1] = m[1];
    x[4 * NF + 2] = l[0];
    x[4 * NF + 3] = l[1];
  }
  __syncthreads();
  if (half == 1) return;
  float c_own[2], c_other[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mo = x[4 * NF + h], m_all = fmaxf(m[h], mo);
    c_own[h] = expf(m[h] - m_all);
    c_other[h] = expf(mo - m_all);
    inv[h] = 1.f / (l[h] * c_own[h] + x[4 * NF + 2 + h] * c_other[h]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + qg * 16 + g + 8 * h;
    if (row >= T) continue;
    float* dst = out + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const float a = fmaf(o[j][2 * h], c_own[h],
                           x[4 * j + 2 * h] * c_other[h]);
      const float b = fmaf(o[j][2 * h + 1], c_own[h],
                           x[4 * j + 2 * h + 1] * c_other[h]);
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(a * inv[h], b * inv[h]);
    }
  }
}

template <int D>
int fa_launch(const float* q, const float* k, const float* v,
              const float* mask, float* out, int B, int H, int T, float scale,
              cudaStream_t s) {
  constexpr int SMEM = FaSmem<D>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (T + FA_QT - 1) / FA_QT);
  flash_attention_fwd<D><<<grid, FA_THREADS, SMEM, s>>>(q, k, v, mask, out,
                                                        H, T, scale);
  return 0;
}

// ---------------------------------------------------------------------------
// Kernel 6b: the bf16 variant (the JAX engine's bf16 dtype). It computes
// what `_make_kernel` computes on a bf16 block (flash_attention.py:45-72):
// q, k and v upcast to float32 (exact), q * scale in float32, the scores,
// the online softmax and p in float32, the -1e9 fill and the -2e9 start as
// above, keys past T out, and the output rounded to bf16 once.
//
// Bound at (1, 8, 1024, 64): 2.15 GFLOP of products, 0.0022 ms at the
// dense bf16 rate (989 TFLOP/s); the bytes, 8 B H T D (4.2 MB), 0.0013 ms.
// Run as split-bf16 products (below) the products are 4.3 GFLOP.
//
// Precision, on both routes: a bf16 k or v is one exact piece. The float32
// operands, q * scale (1/sqrt(96) is no power of two) and p, are each
// split into two bf16 pieces, hi = bf16(x) and lo = bf16(x - hi), which
// keep ~16 mantissa bits (2^-17 relative, against the output's ulp of
// 2^-8; one piece leaves bf16 ulps of error: tests/
// test_torch_bf16_schedules.py), and each product is two bf16
// tensor-core passes, lo then hi, into float32 accumulators (the products
// of bf16 pieces are exact in float32). q * scale is split once, before
// the key loop, and a warp's A fragments (16 rows x D, hi and lo) stay in
// registers for the whole walk. Each 64-key tile's P V starts from zero
// and is added in float32 to the rescaled O (the float32 kernel's
// per-tile flush). A block is 64 query rows of one (b, h), so the long
// clip's 8 heads are 128 blocks, one wave.
//
// Two routes by head width. D 64 (the gesture encoder's heads, the long
// clip) runs on wgmma (flash_attention_bf16_wg, below): mma.sync at D 64,
// with its fragments through ldmatrix, stayed issue- and latency-bound at
// 8 warps an SM and did not beat the library's attention there. D 96 (the
// text encoder) runs this mma.sync kernel, whose 96-wide rows the 128-byte
// swizzle of wgmma does not tile; at the text shape it is at the
// library's time:
//  * KW warps for each 16-row group take the KW slices of each 64-key
//    tile and run their own online softmax, merged in slice order at the
//    end. K, V and the tile's mask stream through a FB_STAGES-deep
//    cp.async ring; rows padded to D + 8 halves (16 bytes), so each 8-lane
//    phase of an ldmatrix hits 32 distinct banks.
//  * S = (q * scale) K^T: m16n8k16 bf16, K's B fragments by ldmatrix (keys
//    are the fragments' n, stored k-contiguous), two n8 tiles an x4; the
//    lo and the hi pass in two accumulators, added at the end.
//  * P V: each k16 step's A fragment is the score accumulator itself
//    (tiles 2i, 2i + 1, as encoder.cuh's bf16 core packs it), p split into
//    hi and lo in registers; V's B fragments by ldmatrix.trans.
//  * exp(s - m) as 2^((s - m) log2 e): s - m in float32 first, so a fully
//    masked row (s = m = -1e9) gets p = 1 exactly.
constexpr int FB_QT = 64;        // query rows a block: 4 groups of 16
constexpr float LOG2E = 1.4426950408889634f;
constexpr int FB_D = 96;         // the head width this kernel is built for
constexpr int FB_KT = 64;        // keys a ring stage
constexpr int FB_KW = 2;         // warps sharing a row group's keys
constexpr int FB_STAGES = 3;

// Shared memory of one block: the ring's stages of K rows and V rows
// (bf16, D + 8 halves a row) and the tile's float32 mask; at the end the
// key slices' exchange (XS floats a lane) in the same bytes.
struct FbSmem {
  static constexpr int RS = FB_D + 8;
  static constexpr int KV = 2 * FB_KT * RS;             // halves
  static constexpr int STAGE_BYTES = KV * 2 + FB_KT * 4;
  static constexpr int XS = 4 * (FB_D / 8) + 5;         // odd: no conflicts
  static constexpr int BYTES = FB_STAGES * STAGE_BYTES;
  static_assert(STAGE_BYTES % 16 == 0, "stages stay 16-byte aligned");
  static_assert(4 * (FB_KW - 1) * 32 * XS * 4 <= BYTES,
                "the exchange fits in the ring");
};

// x, y (two floats of one row) -> bf16 hi and lo pieces, each pair packed
// (x in the low half) by one conversion
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(x - jt::bf2f(hi), y - jt::bf2f(hi >> 16));
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// 2^x (flushing results below 2^-126 to zero; -inf -> 0)
__device__ __forceinline__ float fb_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// grid: (B * H, ceil(T / 64)).
__global__ void __launch_bounds__(128 * FB_KW, 1)
flash_attention_bf16_fwd(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const float* __restrict__ mask,
                         uint16_t* __restrict__ out, int H, int T,
                         float scale) {
  using SM = FbSmem;
  constexpr int D = FB_D, S = FB_STAGES, KT = FB_KT, KW = FB_KW;
  constexpr int NT = 128 * KW;          // 4 row groups x KW warps
  constexpr int RS = SM::RS, NF = D / 8, KS = D / 16;
  constexpr int WK = KT / KW;           // a warp's keys of each tile
  constexpr int NKT = WK / 8;           // its n8 tiles
  constexpr int ROW_COPIES = D / 8;     // 16-byte copies a row
  constexpr int NCH = 4;                // n8 tiles of D a P V flush
  static_assert(NKT % 2 == 0 && NF % NCH == 0, "tiling");
  extern __shared__ __align__(16) uint8_t fb_smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qg = warp & 3, kq = warp >> 2;           // row group, key slice
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * FB_QT;
  const size_t base = (size_t)bh * T * D;
  const float* mrow = mask != nullptr ? mask + (size_t)(bh / H) * T : nullptr;
  const int ntiles = (T + KT - 1) / KT;

  auto stage_k = [&](int tile) {
    return reinterpret_cast<uint16_t*>(fb_smem +
                                       (tile % S) * SM::STAGE_BYTES);
  };
  auto load_tile = [&](int tile) {
    uint16_t* ks = stage_k(tile);
    uint16_t* vs = ks + KT * RS;
    const int k0 = tile * KT;
    for (int c = tid; c < KT * ROW_COPIES; c += NT) {
      const int r = c / ROW_COPIES, cc = (c % ROW_COPIES) * 8;
      const bool ok = k0 + r < T;
      const size_t at = base + (size_t)(k0 + r) * D + cc;
      cp_async16b(ks + r * RS + cc, ok ? k + at : k, ok);
      cp_async16b(vs + r * RS + cc, ok ? v + at : v, ok);
    }
    if (mrow != nullptr && tid < KT) {
      const bool ok = k0 + tid < T;
      cp_async4(reinterpret_cast<float*>(ks + SM::KV) + tid,
                ok ? mrow + k0 + tid : mrow, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < ntiles) load_tile(s);
    jt::cp_async_commit();
  }

  // q * scale as bf16 hi and lo A fragments, once: fragment f of k16 step
  // kk is row g + 8 (f & 1), columns 16 kk + 8 (f >> 1) + 2t, 2t + 1 (rows
  // past T zero)
  uint32_t qhi[KS][4], qlo[KS][4];
  {
    const int r0 = q0 + qg * 16 + g;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = r0 + 8 * (f & 1);
        uint32_t pair = 0;
        if (r < T)
          pair = __ldg(reinterpret_cast<const unsigned int*>(
              q + base + (size_t)r * D + 16 * kk + 8 * (f >> 1) + 2 * t));
        split_bf16x2(jt::bf2f(pair) * scale, jt::bf2f(pair >> 16) * scale,
                     qhi[kk][f], qlo[kk][f]);
      }
  }

  // rows g and g + 8 of the warp's 16: running max and (this thread's
  // share of the) sum
  float m[2] = {2.f * NEG_FILL, 2.f * NEG_FILL}, l[2] = {0.f, 0.f};
  float o[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // a lane's ldmatrix row: K (keys 8 (lane >> 4) + lane % 8, columns 8
  // (lane / 8 % 2)); V (keys 8 (lane / 8 % 2) + lane % 8, columns 8 (lane
  // >> 4))
  const int kl = kq * WK;
  const int krow = kl + 8 * (lane >> 4) + (lane & 7);
  const int kcol = 8 * ((lane >> 3) & 1);
  const int vrow = kl + 8 * ((lane >> 3) & 1) + (lane & 7);
  const int vcol = 8 * (lane >> 4);

  // S = (q * scale) K^T over the warp's WK keys of `tile`: the lo and the
  // hi pass in two accumulators, added at the end
  auto scores = [&](int tile, float (&sc)[NKT][4]) {
    const uint16_t* ks = stage_k(tile);
    float sh[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = sh[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NKT; j += 2) {
        uint32_t b[4];
        jt::ldmatrix_x4(b, ks + (krow + 8 * j) * RS + 16 * kk + kcol);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(sc[j], qlo[kk], b0);
        mma_bf16(sc[j + 1], qlo[kk], b1);
        mma_bf16(sh[j], qhi[kk], b0);
        mma_bf16(sh[j + 1], qhi[kk], b1);
      }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] += sh[j][e];
  };

  // the fill, the online softmax and O = O * corr + P V for `tile`
  auto softmax_pv = [&](int tile, float (&sc)[NKT][4]) {
    const uint16_t* ks = stage_k(tile);
    const uint16_t* vs = ks + KT * RS;
    const float* ms = reinterpret_cast<const float*>(ks + SM::KV) + kl;
    const int kbase = tile * KT + kl;
    // element e of n-tile j is row g + 8 (e >> 1), key kbase + 8 j + 2 t +
    // (e & 1)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      float2 mk = make_float2(1.f, 1.f);
      if (mrow != nullptr)
        mk = *reinterpret_cast<const float2*>(ms + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        float x = sc[j][e];
        if (kbase + key >= T)
          x = -INFINITY;
        else if (((e & 1) ? mk.y : mk.x) == 0.f)
          x = NEG_FILL;
        sc[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float corr[2], ml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);   // finite: m starts finite
      corr[h] = fb_exp2((m[h] - m_new) * LOG2E);
      m[h] = m_new;
      ml[h] = m_new;
      l[h] *= corr[h];
    }
    // p in hi and lo A fragments: k16 step i takes n-tiles 2i, 2i + 1,
    // fragment f = n-tile 2i + (f >> 1), row g + 8 (f & 1)
    uint32_t phi[NKT / 2][4], plo[NKT / 2][4];
#pragma unroll
    for (int i = 0; i < NKT / 2; ++i)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = 2 * i + (f >> 1), h = f & 1;
        const float p0 = fb_exp2((sc[j][2 * h] - ml[h]) * LOG2E);
        const float p1 = fb_exp2((sc[j][2 * h + 1] - ml[h]) * LOG2E);
        l[h] += p0 + p1;
        split_bf16x2(p0, p1, phi[i][f], plo[i][f]);
      }
    // NCH n8 tiles of D a flush: lo, then hi
#pragma unroll
    for (int j0 = 0; j0 < NF; j0 += NCH) {
      float pv[NCH][4];
#pragma unroll
      for (int j = 0; j < NCH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
      for (int i = 0; i < NKT / 2; ++i)
#pragma unroll
        for (int j = 0; j < NCH; j += 2) {
          uint32_t b[4];
          jt::ldmatrix_x4_trans(b, vs + (vrow + 16 * i) * RS + vcol +
                                       8 * (j0 + j));
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
          mma_bf16(pv[j], plo[i], b0);
          mma_bf16(pv[j + 1], plo[i], b1);
          mma_bf16(pv[j], phi[i], b0);
          mma_bf16(pv[j + 1], phi[i], b1);
        }
#pragma unroll
      for (int j = 0; j < NCH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[j0 + j][e] = fmaf(o[j0 + j][e], corr[e >> 1], pv[j][e]);
    }
  };

  for (int tile = 0; tile < ntiles; ++tile) {
    float s[NKT][4];
    jt::cp_async_wait<S - 2>();
    __syncthreads();   // the tile's copies visible; tile - 1's stage free
    if (tile + S - 1 < ntiles) load_tile(tile + S - 1);
    jt::cp_async_commit();
    scores(tile, s);
    softmax_pv(tile, s);
  }
  jt::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {   // the row's sum over the quad
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // merge the key slices in order: slices 1.. hand (o, m, l) to slice 0
  // through the ring, lane for lane
  constexpr int XS = SM::XS;
  float* xo = reinterpret_cast<float*>(fb_smem);
  if constexpr (KW > 1) {
    __syncthreads();   // every warp is done with the ring
    if (kq > 0) {
      float* x = xo + ((qg * (KW - 1) + kq - 1) * 32 + lane) * XS;
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 * j + e] = o[j][e];
      x[4 * NF] = m[0];
      x[4 * NF + 1] = m[1];
      x[4 * NF + 2] = l[0];
      x[4 * NF + 3] = l[1];
    }
    __syncthreads();
    if (kq > 0) return;
  }
  float m_all[2] = {m[0], m[1]};
#pragma unroll
  for (int w = 0; w < KW - 1; ++w) {
    const float* x = xo + ((qg * (KW - 1) + w) * 32 + lane) * XS;
#pragma unroll
    for (int h = 0; h < 2; ++h) m_all[h] = fmaxf(m_all[h], x[4 * NF + h]);
  }
  float c[2], lsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    c[h] = fb_exp2((m[h] - m_all[h]) * LOG2E);
    lsum[h] = l[h] * c[h];
  }
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= c[e >> 1];
#pragma unroll
  for (int w = 0; w < KW - 1; ++w) {
    const float* x = xo + ((qg * (KW - 1) + w) * 32 + lane) * XS;
    float cw[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cw[h] = fb_exp2((x[4 * NF + h] - m_all[h]) * LOG2E);
      lsum[h] = fmaf(x[4 * NF + 2 + h], cw[h], lsum[h]);
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[j][e] = fmaf(x[4 * j + e], cw[e >> 1], o[j][e]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + qg * 16 + g + 8 * h;
    if (row >= T) continue;
    const float inv = 1.f / lsum[h];
    uint16_t* dst = out + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NF; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          jt::pack_bf16(jt::f2bf(o[j][2 * h] * inv),
                        jt::f2bf(o[j][2 * h + 1] * inv));
  }
}

cudaError_t fb_prepare() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_bf16_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FbSmem::BYTES);
  return attr;
}

int fb_launch(const uint16_t* q, const uint16_t* k, const uint16_t* v,
              const float* mask, uint16_t* out, int B, int H, int T,
              float scale, cudaStream_t s) {
  const cudaError_t e = fb_prepare();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (T + FB_QT - 1) / FB_QT);
  flash_attention_bf16_fwd<<<grid, 128 * FB_KW, FbSmem::BYTES, s>>>(
      q, k, v, mask, out, H, T, scale);
  return 0;
}

// ---------------------------------------------------------------------------
// Kernel 6b at D 64 (the gesture encoder's heads: the long clip): wgmma.
// The same arithmetic (q * scale and p in two bf16 pieces, two passes, a
// per-tile flush), on m64n64k16 warpgroup products, FA3's shape:
//  * A block is 64 query rows of one (b, h) and two warpgroups, which take
//    the even and the odd 64-key tiles with their own online softmax and
//    merge at the end; each warp holds its 16 rows' q * scale pieces as
//    register A fragments, as the mma.sync kernel does.
//  * K and V tiles land by TMA (one thread a warpgroup) in the 128-byte
//    swizzle (a 64-key tile is 64 rows of 128 bytes), FW_STAGES tiles a
//    warpgroup in flight on `full` mbarriers; a warpgroup refills a stage
//    once its products on it are done. The maps cover the (B H T, 64)
//    rows: a tile's keys past T are the next head's (or zero past the
//    end), and take no part.
//  * S = (q * scale) K^T: eight wgmma, lo then hi, with K the K-major B;
//    P V: the S accumulator's p pieces as register A fragments (k16 step i
//    = n8 tiles 2i, 2i + 1) against V, the MN-major B, from zero, added to
//    the rescaled O in float32.
//  * The long clip's 8 heads x 16 query blocks are 128 blocks of 8 warps,
//    one wave; while one warpgroup runs its softmax the other's products
//    can run.
constexpr int FW_STAGES = 3;                 // a warpgroup's key tiles in flight
constexpr int FW_TILE = 64 * jt::WG_ROW;     // a 64-key tile of K or V, bytes
constexpr int FW_RING = 2 * FW_STAGES * 2 * FW_TILE;
constexpr int FW_SMEM = 1024 + FW_RING + 2 * FW_STAGES * 8;

// grid: (B * H, ceil(T / 64)); tm_k, tm_v: k and v as (B H T, 64) rows in
// 64-row boxes
__global__ void __launch_bounds__(256, 1)
flash_attention_bf16_wg(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const uint16_t* __restrict__ q,
                        const float* __restrict__ mask,
                        uint16_t* __restrict__ out, int H, int T,
                        float scale) {
  using namespace jt;
  constexpr int D = 64, NF = D / 8, KS = D / 16, NKT = 8;
  constexpr int XS = 4 * NF + 5;
  extern __shared__ uint8_t fw_smem[];
  uint8_t* smem = fw_smem + ((1024 - (smem_u32(fw_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + FW_RING);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wt = tid & 127;
  const int bh = blockIdx.x, q0 = blockIdx.y * FB_QT;
  const size_t base = (size_t)bh * T * D;
  const float* mrow = mask != nullptr ? mask + (size_t)(bh / H) * T : nullptr;
  const int ntiles = (T + 63) / 64;
  const int mine = (ntiles - wg + 1) / 2;    // tiles wg, wg + 2, ...
  uint8_t* ring = smem + wg * FW_STAGES * 2 * FW_TILE;
  uint64_t* wfull = full + wg * FW_STAGES;
  if (tid == 0) {
    for (int s = 0; s < 2 * FW_STAGES; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int i) {   // the warpgroup's i-th tile, K then V
    const int stage = i % FW_STAGES, row = bh * T + (wg + 2 * i) * 64;
    uint8_t* st = ring + stage * 2 * FW_TILE;
    mbar_expect_tx(wfull + stage, 2 * FW_TILE);
    tma_load(st, &tm_k, wfull + stage, 0, row);
    tma_load(st + FW_TILE, &tm_v, wfull + stage, 0, row);
  };
  if (wt == 0)
    for (int i = 0; i < FW_STAGES && i < mine; ++i) load(i);

  // q * scale as bf16 hi and lo A fragments of the warp's 16 rows
  const int rl = 16 * (warp & 3) + g;        // rows rl, rl + 8 of the block
  uint32_t qhi[KS][4], qlo[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = q0 + rl + 8 * (f & 1);
      uint32_t pair = 0;
      if (r < T)
        pair = __ldg(reinterpret_cast<const unsigned int*>(
            q + base + (size_t)r * D + 16 * kk + 8 * (f >> 1) + 2 * t));
      split_bf16x2(bf2f(pair) * scale, bf2f(pair >> 16) * scale, qhi[kk][f],
                   qlo[kk][f]);
    }

  float m[2] = {2.f * NEG_FILL, 2.f * NEG_FILL}, l[2] = {0.f, 0.f};
  float o[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int i = 0; i < mine; ++i) {
    const int stage = i % FW_STAGES, kbase = (wg + 2 * i) * 64;
    mbar_wait(wfull + stage, (i / FW_STAGES) & 1);
    const uint8_t* st = ring + stage * 2 * FW_TILE;
    const uint64_t dk = wgmma_desc_sw128(st, 0, 1024);
    const uint64_t dv = wgmma_desc_sw128(st + FW_TILE, WG_NBLK, 1024);

    // S = (q * scale) K^T: element e of n8 tile j is row rl + 8 (e >> 1),
    // key kbase + 8 j + 2 t + (e & 1)
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)   // K: 32 bytes on a k16 step
      wgmma_rs_bf16<0>(sc, qlo[kk], dk + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs_bf16<0>(sc, qhi[kk], dk + 2 * kk, true);
    wgmma_commit();

    // while the products run: each lane's keys kbase + lane and kbase + 32
    // + lane, 0 live, 1 masked (the fill), 2 past T; a tile whose keys are
    // all live (the warp votes) skips the fill
    auto code = [&](int key) {
      return key >= T ? 2 : (mrow != nullptr && __ldg(mrow + key) == 0.f);
    };
    const int c0 = code(kbase + lane), c1 = code(kbase + 32 + lane);
    const bool live = __all_sync(0xffffffffu, (c0 | c1) == 0);
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) wgmma_pin(sc[e]);
    if (!live) {
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int cd = __shfl_sync(0xffffffffu, j < 4 ? c0 : c1,
                                     (8 * j + 2 * t + c) & 31);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& x = sc[4 * j + 2 * h + c];
            if (cd == 2)
              x = -INFINITY;
            else if (cd == 1)
              x = NEG_FILL;
          }
        }
    }
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e)
      tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], sc[e]);
    // p = exp(s - m) = 2^(s log2 e - m log2 e): one FFMA. A fully masked
    // row (s = m = -1e9) then sees the same p at every key: still uniform.
    float corr[2], ml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);   // finite: m starts finite
      corr[h] = fb_exp2((m[h] - m_new) * LOG2E);
      m[h] = m_new;
      ml[h] = m_new * LOG2E;
      l[h] *= corr[h];
    }
    uint32_t phi[NKT / 2][4], plo[NKT / 2][4];
#pragma unroll
    for (int k2 = 0; k2 < NKT / 2; ++k2)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = 2 * k2 + (f >> 1), h = f & 1;
        const float p0 = fb_exp2(fmaf(sc[4 * j + 2 * h], LOG2E, -ml[h]));
        const float p1 = fb_exp2(fmaf(sc[4 * j + 2 * h + 1], LOG2E, -ml[h]));
        l[h] += p0 + p1;
        split_bf16x2(p0, p1, phi[k2][f], plo[k2][f]);
      }

    // this tile's P V from zero: lo, then hi; V: 16 rows on a k16 step
    float pv[32];
    wgmma_fence();
#pragma unroll
    for (int k2 = 0; k2 < NKT / 2; ++k2)
      wgmma_rs_bf16<1>(pv, plo[k2], dv + 128 * k2, k2 > 0);
#pragma unroll
    for (int k2 = 0; k2 < NKT / 2; ++k2)
      wgmma_rs_bf16<1>(pv, phi[k2], dv + 128 * k2, true);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) wgmma_pin(pv[e]);
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[j][e] = fmaf(o[j][e], corr[e >> 1], pv[4 * j + e]);

    wg_sync(wg);   // the warpgroup's products on this stage are done
    if (wt == 0 && i + FW_STAGES < mine) load(i + FW_STAGES);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {   // the row's sum over the quad
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // the odd tiles' warpgroup hands (o, m, l) to the even one, lane for lane
  __syncthreads();   // both warpgroups are done with the ring
  float* x = reinterpret_cast<float*>(smem) + wt * XS;
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[4 * j + e] = o[j][e];
    x[4 * NF] = m[0];
    x[4 * NF + 1] = m[1];
    x[4 * NF + 2] = l[0];
    x[4 * NF + 3] = l[1];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mo = x[4 * NF + h], m_all = fmaxf(m[h], mo);
    const float c_own = fb_exp2((m[h] - m_all) * LOG2E);
    const float c_other = fb_exp2((mo - m_all) * LOG2E);
    const float inv = 1.f / fmaf(x[4 * NF + 2 + h], c_other, l[h] * c_own);
    const int row = q0 + rl + 8 * h;
    if (row >= T) continue;
    uint16_t* dst = out + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const float a = fmaf(x[4 * j + 2 * h], c_other, o[j][2 * h] * c_own);
      const float b =
          fmaf(x[4 * j + 2 * h + 1], c_other, o[j][2 * h + 1] * c_own);
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_bf16(f2bf(a * inv), f2bf(b * inv));
    }
  }
}

cudaError_t fw_prepare() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_bf16_wg, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FW_SMEM);
  return attr;
}

int fw_launch(const uint16_t* q, const uint16_t* k, const uint16_t* v,
              const float* mask, uint16_t* out, int B, int H, int T,
              float scale, cudaStream_t s) {
  cudaError_t e = fw_prepare();
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * H * T;
  if (rows >= (1ll << 31)) return JT_ERR_SHAPE;   // TMA row coordinates
  CUtensorMap tk, tv;
  if (!jt::bf16_tensor_map(&tk, k, (int)rows, 64, 64) ||
      !jt::bf16_tensor_map(&tv, v, (int)rows, 64, 64))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (T + FB_QT - 1) / FB_QT);
  flash_attention_bf16_wg<<<grid, 256, FW_SMEM, s>>>(tk, tv, q, mask, out, H,
                                                     T, scale);
  return 0;
}

// {registers, spill bytes, shared memory, blocks an SM} of a kernel
int fa_info(const void* fn, cudaError_t prepared, int threads, int smem,
            int* info) {
  cudaError_t e = prepared;
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  return 0;
}

bool fa_shape_ok(const void* q, const void* k, const void* v,
                 const void* out, int B, int H, int T) {
  return B > 0 && H > 0 && T > 0 && jt::aligned16(q) && jt::aligned16(k) &&
         jt::aligned16(v) && jt::aligned16(out);
}

}  // namespace

// out = softmax(fill(q*scale @ k^T, mask, -1e9)) @ v over (B, H, T, D)
// float32, on the caller's stream. D must be 64 or 96; q, k, v and out
// 16-byte aligned.
extern "C" int jt_flash_attention(const float* q, const float* k,
                                  const float* v, const float* mask,
                                  float* out, int B, int H, int T, int D,
                                  float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!fa_shape_ok(q, k, v, out, B, H, T)) return JT_ERR_SHAPE;
  int rc = JT_ERR_SHAPE;
  if (D == 64) rc = fa_launch<64>(q, k, v, mask, out, B, H, T, scale, s);
  if (D == 96) rc = fa_launch<96>(q, k, v, mask, out, B, H, T, scale, s);
  if (rc != 0) return rc;
  JT_CHECK_LAUNCH();
  return 0;
}

// The same over bf16 q, k, v and out (uint16_t bit patterns); the mask
// float32; scale as above.
extern "C" int jt_flash_attention_bf16(const uint16_t* q, const uint16_t* k,
                                       const uint16_t* v, const float* mask,
                                       uint16_t* out, int B, int H, int T,
                                       int D, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!fa_shape_ok(q, k, v, out, B, H, T)) return JT_ERR_SHAPE;
  int rc = JT_ERR_SHAPE;
  if (D == 64) rc = fw_launch(q, k, v, mask, out, B, H, T, scale, s);
  if (D == 96) rc = fb_launch(q, k, v, mask, out, B, H, T, scale, s);
  if (rc != 0) return rc;
  JT_CHECK_LAUNCH();
  return 0;
}

// kernel 6b's {registers, spill bytes, shared memory, blocks an SM} at
// head width D (64 or 96) on the current card
extern "C" int jt_flash_attention_bf16_info(int D, int* info) {
  if (D == 64)
    return fa_info((const void*)flash_attention_bf16_wg, fw_prepare(), 256,
                   FW_SMEM, info);
  if (D == 96)
    return fa_info((const void*)flash_attention_bf16_fwd, fb_prepare(),
                   128 * FB_KW, FbSmem::BYTES, info);
  return JT_ERR_SHAPE;
}
