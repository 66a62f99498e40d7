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
// jt_flash_attention_bf16 is the bf16 variant (kernel 6b, the JAX engine's
// bf16 dtype): q, k, v and out bf16, the mask float32. It computes what
// `_make_kernel` computes on a bf16 block (flash_attention.py:45-72): q, k
// and v upcast to float32 (exact), q * scale in float32, the scores, the
// online softmax and p in float32 (p is never rounded), and the output
// rounded to bf16 once. The same schedule, template on the element type:
//  * Q, K and V are staged as bf16, rows padded to D + 8 halves (16 bytes:
//    the fragment loads of both products still hit distinct banks, two
//    lanes sharing each 32-bit word), so the ring is half the float one.
//  * A bf16 k or v is exact in TF32 (8 mantissa bits of 10): its hi part
//    is its own bits and its lo part zero. Only the float32 operands, q *
//    scale (1/sqrt(96) is no power of two, so q * scale is no bf16 value)
//    and p, are split, and each product takes two TF32 passes, lo*hi and
//    hi*hi, where 3xTF32 takes three.
//  * Each quad writes a row's 2 outputs of an n8 tile as one 32-bit pair.
// Bound at (1, 8, 1024, 64): 2.15 GFLOP of products, 0.0022 ms at the
// dense bf16 rate (989 TFLOP/s) and 0.0087 ms as two TF32 passes (495
// TFLOP/s); the bytes, 8 B H T D (4.2 MB), 0.0013 ms.
#include <math.h>

#include "gemm.cuh"

namespace {

using jt::cp_async16b;
using jt::cp_async4;
using jt::mma_tf32;
using jt::split_tf32;

constexpr int FA_QT = 32;                 // query rows per block
constexpr int FA_KT = 32;                 // keys per ring stage
constexpr int FA_KH = FA_KT / 2;          // keys per warp per stage
constexpr int FA_WARPS = 4;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_STAGES = 2;
constexpr float NEG_FILL = -1e9f;         // flash_attention.py:27

// Q, K and V rows as float32 or bf16 (uint16_t bit patterns): the value
// as a float, and its TF32 (hi, lo) split; a bf16 value is its own hi.
__device__ __forceinline__ float fa_value(float x) { return x; }
__device__ __forceinline__ float fa_value(uint16_t x) { return jt::bf2f(x); }

__device__ __forceinline__ void fa_split(float x, uint32_t& hi,
                                         uint32_t& lo) {
  split_tf32(x, hi, lo);
}
__device__ __forceinline__ void fa_split(uint16_t x, uint32_t& hi,
                                         uint32_t&) {
  hi = (uint32_t)x << 16;
}

// an output pair (row, columns c, c + 1), after the division by l
__device__ __forceinline__ void fa_store(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void fa_store(uint16_t* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = jt::pack_bf16(jt::f2bf(a), jt::f2bf(b));
}

// Shared memory of one block, in Elem units for the rows: Q, then the
// ring's stages of K rows, V rows and the tile's float32 mask.
template <int D, class Elem>
struct FaSmem {
  static constexpr int PAD = 16 / (int)sizeof(Elem);   // 16 bytes a row
  static constexpr int RS = D + PAD;                  // row stride
  static constexpr int Q = FA_QT * RS;
  static constexpr int KV = 2 * FA_KT * RS;            // K, V of a stage
  static constexpr int STAGE_BYTES = KV * (int)sizeof(Elem) + FA_KT * 4;
  static constexpr int BYTES = Q * (int)sizeof(Elem) + FA_STAGES * STAGE_BYTES;
  static_assert(STAGE_BYTES % 16 == 0 && (Q * sizeof(Elem)) % 16 == 0,
                "stages stay 16-byte aligned");
};

// grid: (B * H, ceil(T / 32)).
template <int D, class Elem>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_fwd(const Elem* __restrict__ q, const Elem* __restrict__ k,
                    const Elem* __restrict__ v,
                    const float* __restrict__ mask, Elem* __restrict__ out,
                    int H, int T, float scale) {
  using SM = FaSmem<D, Elem>;
  constexpr bool exact = sizeof(Elem) == 2;          // bf16 k, v: one piece
  constexpr int RS = SM::RS, NF = D / 8, KS = D / 8;
  constexpr int EPC = 16 / (int)sizeof(Elem);        // elements a copy
  constexpr int ROW_COPIES = D / EPC;                // 16-byte copies a row
  extern __shared__ __align__(16) float smem[];
  Elem* Qs = reinterpret_cast<Elem*>(smem);
  char* ring = reinterpret_cast<char*>(Qs + SM::Q);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qg = warp & 1, half = warp >> 1;         // query rows, key half
  const int bh = blockIdx.x;                         // b * H + h
  const int q0 = blockIdx.y * FA_QT;
  const size_t base = (size_t)bh * T * D;
  const float* mrow = mask != nullptr ? mask + (size_t)(bh / H) * T : nullptr;
  const int ntiles = (T + FA_KT - 1) / FA_KT;

  for (int c = tid; c < FA_QT * ROW_COPIES; c += FA_THREADS) {
    const int r = c / ROW_COPIES, cc = (c % ROW_COPIES) * EPC;
    const bool ok = q0 + r < T;
    cp_async16b(Qs + r * RS + cc,
                ok ? q + base + (size_t)(q0 + r) * D + cc : q, ok);
  }
  auto load_tile = [&](int stage, int tile) {
    Elem* ks = reinterpret_cast<Elem*>(ring + stage * SM::STAGE_BYTES);
    Elem* vs = ks + FA_KT * RS;
    const int k0 = tile * FA_KT;
    for (int c = tid; c < FA_KT * ROW_COPIES; c += FA_THREADS) {
      const int r = c / ROW_COPIES, cc = (c % ROW_COPIES) * EPC;
      const bool ok = k0 + r < T;
      const size_t at = base + (size_t)(k0 + r) * D + cc;
      cp_async16b(ks + r * RS + cc, ok ? k + at : k, ok);
      cp_async16b(vs + r * RS + cc, ok ? v + at : v, ok);
    }
    if (mrow != nullptr && tid < FA_KT) {
      const bool ok = k0 + tid < T;
      cp_async4(reinterpret_cast<float*>(ks + SM::KV) + tid,
                ok ? mrow + k0 + tid : mrow, ok);
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
  const Elem* qa = Qs + (qg * 16 + g) * RS + t;

  for (int tile = 0; tile < ntiles; ++tile) {
    jt::cp_async_wait<FA_STAGES - 2>();
    __syncthreads();   // the tile's copies visible; tile - 1's stage free
    const int next = tile + FA_STAGES - 1;
    if (next < ntiles) load_tile(next % FA_STAGES, next);
    jt::cp_async_commit();

    const Elem* stage = reinterpret_cast<const Elem*>(
        ring + (tile % FA_STAGES) * SM::STAGE_BYTES);
    const Elem* ks = stage + half * FA_KH * RS;      // the warp's 16 keys
    const Elem* vs = ks + FA_KT * RS;
    const float* ms =
        reinterpret_cast<const float*>(stage + SM::KV) + half * FA_KH;
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
        const Elem* p = qa + kk * 8;
        split_tf32(fa_value(p[0]) * scale, ahi[0], alo[0]);
        split_tf32(fa_value(p[8 * RS]) * scale, ahi[1], alo[1]);
        split_tf32(fa_value(p[4]) * scale, ahi[2], alo[2]);
        split_tf32(fa_value(p[8 * RS + 4]) * scale, ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const Elem* b = ks + (j * 8 + g) * RS + kk * 8 + t;
          fa_split(b[0], bhi[j][0], blo[j][0]);
          fa_split(b[4], bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_tf32(part[j], alo, bhi[j]);
        if constexpr (!exact) {
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_tf32(part[j], ahi, blo[j]);
        }
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
          const Elem* b = vs + (kk * 8 + 2 * t) * RS + (j0 + j) * 8 + g;
          fa_split(b[0], bhi[j][0], blo[j][0]);
          fa_split(b[RS], bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(pv[j], plo[kk], bhi[j]);
        if constexpr (!exact) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(pv[j], phi[kk], blo[j]);
        }
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
  static_assert(64 * XS * 4 <= FA_STAGES * SM::STAGE_BYTES,
                "the exchange fits in the ring");
  float* x = reinterpret_cast<float*>(ring) + (qg * 32 + lane) * XS;
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
    Elem* dst = out + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const float a = fmaf(o[j][2 * h], c_own[h],
                           x[4 * j + 2 * h] * c_other[h]);
      const float b = fmaf(o[j][2 * h + 1], c_own[h],
                           x[4 * j + 2 * h + 1] * c_other[h]);
      fa_store(dst + j * 8, a * inv[h], b * inv[h]);
    }
  }
}

template <int D, class Elem>
int fa_launch(const Elem* q, const Elem* k, const Elem* v, const float* mask,
              Elem* out, int B, int H, int T, float scale, cudaStream_t s) {
  constexpr int SMEM = FaSmem<D, Elem>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_fwd<D, Elem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (T + FA_QT - 1) / FA_QT);
  flash_attention_fwd<D, Elem><<<grid, FA_THREADS, SMEM, s>>>(
      q, k, v, mask, out, H, T, scale);
  return 0;
}

template <class Elem>
int fa_entry(const Elem* q, const Elem* k, const Elem* v, const float* mask,
             Elem* out, int B, int H, int T, int D, float scale,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || T <= 0) return JT_ERR_SHAPE;
  if (!jt::aligned16(q) || !jt::aligned16(k) || !jt::aligned16(v) ||
      !jt::aligned16(out))
    return JT_ERR_SHAPE;
  int rc = JT_ERR_SHAPE;
  if (D == 64) rc = fa_launch<64>(q, k, v, mask, out, B, H, T, scale, s);
  if (D == 96) rc = fa_launch<96>(q, k, v, mask, out, B, H, T, scale, s);
  if (rc != 0) return rc;
  JT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// out = softmax(fill(q*scale @ k^T, mask, -1e9)) @ v over (B, H, T, D)
// float32, on the caller's stream. D must be 64 or 96; q, k, v and out
// 16-byte aligned.
extern "C" int jt_flash_attention(const float* q, const float* k,
                                  const float* v, const float* mask,
                                  float* out, int B, int H, int T, int D,
                                  float scale, void* stream) {
  return fa_entry(q, k, v, mask, out, B, H, T, D, scale, stream);
}

// The same over bf16 q, k, v and out (uint16_t bit patterns); the mask
// float32; scale as above.
extern "C" int jt_flash_attention_bf16(const uint16_t* q, const uint16_t* k,
                                       const uint16_t* v, const float* mask,
                                       uint16_t* out, int B, int H, int T,
                                       int D, float scale, void* stream) {
  return fa_entry(q, k, v, mask, out, B, H, T, D, scale, stream);
}
