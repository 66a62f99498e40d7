// Device code shared by the encoder sources (fused_layer.cu: one sublayer a
// call; encoder_stack.cu: a whole stack a call): the attention core. The
// products and the row LayerNorm are in gemm.cuh.
//
// The core computes, per segment and head, softmax(fill(q * scale K^T)) V
// over the QKV product's rows: the attention of jegal_tpu/ops/pallas/
// fused_layer.py:_attn_kernel and :_stack_kernel. Attention never crosses
// a segment: where the TPU kernel filled another segment's scores with
// -1e9 in its block-diagonal (rows x rows) score matrix, a score between
// two segments here takes no part at all (-inf, probability 0), and only a
// masked key of the row's own segment is filled with -1e9. So a segment
// whose keys are all masked averages its own keys, as the plain twin
// (ops/kernels/fused_layer.py) does; the two agree on every other row.
//
// What bounds it on the H100: 4 seg^2 dk operations a segment and head
// against 16 seg dk bytes. In 3xTF32 (three TF32 products per float32 one
// at 495 TFLOP/s) the window head's 128 windows of 21 (8 heads of 64) are
// 0.7 us of operations and 6.6 us of bytes: the core is bound by its bytes
// and by the latency of a block's chain of loads and products. The design:
//
//  * Both products on the tensor cores in 3xTF32, as kernel 6
//    (flash_attention.cu): mma.sync.m16n8k8 on operands split as hi =
//    tf32(x), lo = tf32(x - hi), lo*hi + hi*lo + hi*hi. S = (q * scale)
//    K^T starts from zero each 32 columns of dk and is added to a float32
//    sum; each 32 keys' P V starts from zero and is added in float32 to
//    the rescaled O (the tensor cores truncate as they accumulate:
//    gemm.cuh). P feeds P V from the S accumulator without moving (the
//    mma sums its 8 k indices in any order: column t is key 2t, t + 4 key
//    2t + 1).
//  * Short segments packed (seg <= 64): a block of 8 warps owns a 64-row
//    tile of floor(64 / seg) whole segments, the tile's rows its keys;
//    each of 4 row groups (16 query rows) has 2 warps, one for each half
//    of the keys, each with its own softmax, the two merged at the end as
//    below. Scores across segments are -inf, and a warp skips the
//    products of the 8-key tiles that hold no key of its rows' segments
//    (at the window head 18 of 32 are left). A tile holds 3 windows
//    there, 63 of its 64 rows live. The last tile of a segment count that
//    is not a multiple is ragged: its rows past R are zero-filled and
//    never written.
//  * Long segments streamed (seg > 64): a block of 4 warps owns 16 query
//    rows of one segment and streams its keys in tiles of 64 through a
//    2-stage ring; each warp takes 16 keys of each tile with its own
//    online softmax (running max from -2e9 and sum in float32), and the
//    four merge at the end in a fixed order, the first quarter first. The
//    gesture encoder's 128-row segment over 8 heads is 64 blocks.
//  * Loads: each row's head slice of Q, K and V is dk / 4 16-byte
//    cp.async copies straight from the QKV product's rows (the fused
//    gate's d % 128 == 0 aligns every head's slice), each mask value a
//    4-byte copy, so no score reads device memory. Rows are padded to
//    dk + 4 floats: every fragment load of a warp hits 32 banks.
//  * A split QKV product is not reduced first: the core reads its split-K
//    partials and sums them as row_epilogue_kernel does (slice 0, then 1,
//    ..., then the bias), so the sublayer launches no reduction for it.
//    Those are plain 16-byte loads, 4 (packed) or 8 (streamed) pieces a
//    thread at a time with every slice's load issued before the sums need
//    it, summed in registers and stored to shared memory.
//  * No atomics: two launches give identical bits.
#pragma once

#include <math.h>

#include "gemm.cuh"

namespace jt {

constexpr int AC_KT = 64;          // keys a tile; the packed tile's rows
constexpr int AC_STAGES = 2;       // the streamed schedule's key ring
constexpr float AC_FILL = -1e9f;   // a masked key's score (fused_layer.py:141)

// Where the core reads Q, K and V: the QKV product's rows (R, 3d), or, when
// the product was split (splits > 1), its unreduced partials
// (splits, R, 3d) and its bias.
struct QkvSource {
  const float* rows;   // qkv (R, 3d), or the split-K workspace
  const float* bias;   // (3d,) when splits > 1
  int splits;
  size_t slice;        // floats a partial: R * 3d
};

// The source of a QKV product run under `plan` ({BM, BN, splits}) by
// gemm(..., reduce = false): the workspace when it split, else qkv.
inline QkvSource qkv_source(const int* plan, const float* qkv,
                            const float* ws, const float* bias, int R,
                            int d) {
  if (plan[2] > 1) return {ws, bias, plan[2], (size_t)R * 3 * d};
  return {qkv, nullptr, 1, 0};
}

// The shape of one schedule: which warps share the queries and the keys.
// Packed: 8 warps, 4 groups of 16 query rows, each group's 64 keys in 2
// halves of 32. Streamed: 4 warps, 16 query rows, their keys in 4
// quarters of 16. BATCH: the 16-byte pieces of the split partials a
// thread sums at once. MIN_BLOCKS 2 caps the packed dk 64 schedule at 128
// registers, so that two blocks an SM take the window head's 344 blocks
// in fewer waves; the others run small grids and keep their registers.
template <int DK, bool PACKED>
struct Core {
  static constexpr int WARPS = PACKED ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BATCH = PACKED ? 4 : 8;
  static constexpr int MIN_BLOCKS = PACKED && DK == 64 ? 2 : 1;
  static constexpr int NKT = PACKED ? 4 : 2;      // a warp's n8 key tiles
  static constexpr int KW = AC_KT / (8 * NKT);    // warps over the keys
  static constexpr int QW = WARPS / KW;           // warps over the queries
  static constexpr int QT = 16 * QW;              // query rows a block
  static constexpr int STAGES = PACKED ? 1 : AC_STAGES;
  static constexpr int RS = DK + 4;               // row stride (floats)
  static constexpr int Q = QT * RS;
  static constexpr int STAGE = 2 * AC_KT * RS + AC_KT;   // K, V, mask
  static constexpr int BYTES = (Q + STAGES * STAGE) * (int)sizeof(float);
  static_assert(KW * QW == WARPS, "warps split evenly");
  static_assert(DK % 32 == 0, "dk flushes in 32-column steps");
};

// grid: (tiles, heads). Packed: tile x is segments [x per_tile, (x + 1)
// per_tile). Streamed: tile x is query rows [(x % q) 16, +16) of segment
// x / q, q = ceil(seg / 16).
template <int DK, bool PACKED>
__global__ void __launch_bounds__(Core<DK, PACKED>::THREADS,
                                  Core<DK, PACKED>::MIN_BLOCKS)
attention_core(QkvSource src, const float* __restrict__ kmask,
               float* __restrict__ out, int R, int d, int seg, int per_tile,
               float scale) {
  using C = Core<DK, PACKED>;
  constexpr int RS = C::RS, NKT = C::NKT, NF = DK / 8, KS = DK / 8;
  constexpr int COPIES = DK / 4;        // 16-byte pieces of a head's slice
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = smem + C::Q;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qg = warp / C::KW, kq = warp % C::KW;
  const int head = blockIdx.y;
  const size_t ld = 3 * (size_t)d;

  // the block's query rows [q_row0, q_row0 + q_n) and key rows
  // [k_row0, k_row0 + k_n)
  int q_row0, q_n, k_row0, k_n;
  if (PACKED) {
    q_row0 = blockIdx.x * per_tile * seg;
    q_n = min(per_tile * seg, R - q_row0);
    k_row0 = q_row0;
    k_n = q_n;
  } else {
    const int q_tiles = (seg + C::QT - 1) / C::QT;
    const int q0 = (blockIdx.x % q_tiles) * C::QT;
    k_row0 = (blockIdx.x / q_tiles) * seg;
    k_n = seg;
    q_row0 = k_row0 + q0;
    q_n = min(C::QT, seg - q0);
  }
  const int ntiles = (k_n + AC_KT - 1) / AC_KT;

  // n rows from row0 (the first `live` of them real, the rest zeros) of
  // `parts` thirds of the QKV rows, from column col and then col + d, into
  // n rows of dst (stride RS) a part, part_stride floats apart
  auto load_rows = [&](float* dst, int part_stride, int row0, int n,
                       int live, int col, int parts) {
    const int items = parts * n * COPIES;
    if (src.splits == 1) {
      for (int c = tid; c < items; c += C::THREADS) {
        const int part = c / (n * COPIES), rc = c % (n * COPIES);
        const int r = rc / COPIES, cc = (rc % COPIES) * 4;
        const bool ok = r < live;
        cp_async16(dst + part * part_stride + r * RS + cc,
                   ok ? src.rows + (row0 + r) * ld + col + part * d + cc
                      : src.rows,
                   ok);
      }
      return;
    }
    // the partials: BATCH 16-byte pieces a thread at a time, every
    // slice's load issued before the sums need it (they are independent),
    // summed slice 0, 1, ... and then the bias, and stored
    const size_t slice = src.slice / 4;   // float4s
    for (int c0 = tid; c0 < items; c0 += C::THREADS * C::BATCH) {
      const float4* p[C::BATCH];
      float4 v[C::BATCH];
      float* at[C::BATCH];
#pragma unroll
      for (int b = 0; b < C::BATCH; ++b) {
        const int c = c0 + b * C::THREADS;
        const int part = c / (n * COPIES), rc = c % (n * COPIES);
        const int r = rc / COPIES, cc = (rc % COPIES) * 4;
        at[b] = c < items ? dst + part * part_stride + r * RS + cc : nullptr;
        const int gc = col + part * d + cc;
        p[b] = c < items && r < live
                   ? reinterpret_cast<const float4*>(
                         src.rows + (row0 + r) * ld + gc)
                   : nullptr;
        v[b] = p[b] != nullptr ? __ldg(p[b]) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll 2
      for (int k = 1; k < src.splits; ++k)
#pragma unroll
        for (int b = 0; b < C::BATCH; ++b)
          if (p[b] != nullptr) v[b] = add4(v[b], __ldg(p[b] + k * slice));
#pragma unroll
      for (int b = 0; b < C::BATCH; ++b) {
        if (at[b] == nullptr) continue;
        if (p[b] != nullptr) {
          const int c = c0 + b * C::THREADS;
          const int part = c / (n * COPIES), cc = (c % COPIES) * 4;
          v[b] = add4(v[b], __ldg(reinterpret_cast<const float4*>(
                                src.bias + col + part * d + cc)));
        }
        *reinterpret_cast<float4*>(at[b]) = v[b];
      }
    }
  };
  load_rows(Qs, 0, q_row0, C::QT, q_n, head * DK, 1);
  auto load_tile = [&](int stage, int tile) {
    float* ks = ring + stage * C::STAGE;
    float* vs = ks + AC_KT * RS;
    const int k0 = tile * AC_KT;
    load_rows(ks, AC_KT * RS, k_row0 + k0, AC_KT, min(AC_KT, k_n - k0),
              d + head * DK, 2);
    if (kmask != nullptr && tid < AC_KT) {
      const bool ok = k0 + tid < k_n;
      cp_async4(vs + AC_KT * RS + tid, ok ? kmask + k_row0 + k0 + tid : kmask,
                ok);
    }
  };
  load_tile(0, 0);   // Q joins the first group
  cp_async_commit();

  // the warp's rows g and g + 8 of its 16: running max and (this thread's
  // share of the) sum; packed, each row's segment within the tile
  float m[2] = {2.f * AC_FILL, 2.f * AC_FILL}, l[2] = {0.f, 0.f};
  float o[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const int row_seg[2] = {PACKED ? (qg * 16 + g) / seg : 0,
                          PACKED ? (qg * 16 + g + 8) / seg : 0};
  const float* qa = Qs + (qg * 16 + g) * RS + t;
  const int kl = kq * 8 * NKT;            // the warp's first key of a tile

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();   // the tile's copies visible; tile - 1's stage free
    if (tile + 1 < ntiles) load_tile((tile + 1) % C::STAGES, tile + 1);
    cp_async_commit();

    const float* stage = ring + (tile % C::STAGES) * C::STAGE;
    const float* ks = stage + kl * RS;
    const float* vs = stage + (AC_KT + kl) * RS;
    const float* ms = stage + 2 * AC_KT * RS + kl;

    // the warp's n8 key tiles [jlo, jhi) that hold a key its rows attend
    // to: packed, keys [klo, khi) of its rows' segments; streamed, those
    // before the segment's end. The others' scores are -inf and their P
    // zero, so their products are skipped (a warp-uniform branch).
    int klo = 0, khi = k_n - tile * AC_KT;
    if (PACKED) {
      const int r0 = qg * 16, r1 = min(r0 + 16, q_n) - 1;
      klo = r1 < r0 ? 0 : (r0 / seg) * seg;
      khi = r1 < r0 ? 0 : min((r1 / seg + 1) * seg, k_n);
    }
    const int jlo = min(NKT, max(0, (klo - kl) / 8));
    const int jhi = min(NKT, max(0, (khi - kl + 7) / 8));

    // S = (q * scale) K^T over the warp's 8 NKT keys, CH n8 tiles at a time
    constexpr int CH = NKT < 4 ? NKT : 4;
    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < NKT; j0 += CH) {
      if (j0 + CH <= jlo || j0 >= jhi) continue;
#pragma unroll
      for (int c0 = 0; c0 < KS; c0 += 4) {     // 32 columns of dk a flush
        float part[CH][4];
#pragma unroll
        for (int j = 0; j < CH; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
        for (int kk = c0; kk < c0 + 4; ++kk) {
          uint32_t ahi[4], alo[4];
          const float* p = qa + kk * 8;
          split_tf32(p[0] * scale, ahi[0], alo[0]);
          split_tf32(p[8 * RS] * scale, ahi[1], alo[1]);
          split_tf32(p[4] * scale, ahi[2], alo[2]);
          split_tf32(p[8 * RS + 4] * scale, ahi[3], alo[3]);
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            if (j0 + j < jlo || j0 + j >= jhi) continue;
            uint32_t bhi[2], blo[2];
            const float* b = ks + ((j0 + j) * 8 + g) * RS + kk * 8 + t;
            split_tf32(b[0], bhi[0], blo[0]);
            split_tf32(b[4], bhi[1], blo[1]);
            mma_tf32(part[j], alo, bhi);
            mma_tf32(part[j], ahi, blo);
            mma_tf32(part[j], ahi, bhi);
          }
        }
#pragma unroll
        for (int j = 0; j < CH; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j0 + j][e] += part[j][e];
      }
    }

    // -inf across segments and past the keys, the fill, row max, p,
    // correction, row sum: element e of n-tile j is row g + 8 (e >> 1),
    // key kl + 8 j + 2 t + (e & 1) of the tile
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        const bool live = PACKED ? (kl + key) / seg == row_seg[e >> 1]
                                 : tile * AC_KT + kl + key < k_n;
        float x = s[j][e];
        if (!live)
          x = -INFINITY;
        else if (kmask != nullptr && ms[key] == 0.f)
          x = AC_FILL;
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
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);   // -inf -> 0
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // O = O * corr + P V, each 32 keys' products from zero: P's A fragment
    // for keys 8 kk.. is s[kk] itself, split a 32-key chunk at a time
#pragma unroll
    for (int c0 = 0; c0 < NKT; c0 += CH) {
      uint32_t phi[CH][4], plo[CH][4];
#pragma unroll
      for (int kk = 0; kk < CH; ++kk) {
        split_tf32(s[c0 + kk][0], phi[kk][0], plo[kk][0]);
        split_tf32(s[c0 + kk][2], phi[kk][1], plo[kk][1]);
        split_tf32(s[c0 + kk][1], phi[kk][2], plo[kk][2]);
        split_tf32(s[c0 + kk][3], phi[kk][3], plo[kk][3]);
      }
#pragma unroll
      for (int j0 = 0; j0 < NF; j0 += 4) {      // 4 n8 tiles of dk at a time
        float pv[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < CH; ++kk) {
          if (c0 + kk < jlo || c0 + kk >= jhi) continue;
          uint32_t bhi[4][2], blo[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float* b =
                vs + ((c0 + kk) * 8 + 2 * t) * RS + (j0 + j) * 8 + g;
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
            o[j0 + j][e] = c0 == 0 ? fmaf(o[j0 + j][e], corr[e >> 1], pv[j][e])
                                   : o[j0 + j][e] + pv[j][e];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring

#pragma unroll
  for (int h = 0; h < 2; ++h) {   // the row's sum over the quad
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float inv[2];
  if constexpr (C::KW > 1) {
    // merge a row group's key slices: its other warps hand (o, m, l) to
    // the first in fragment order, lane for lane (an odd stride: no bank
    // conflicts), which adds them in key order
    constexpr int XS = 4 * NF + 5;
    if (kq > 0) {
      float* x = ring + ((qg * (C::KW - 1) + kq - 1) * 32 + lane) * XS;
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
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m_all = m[h];
#pragma unroll
      for (int w = 0; w < C::KW - 1; ++w)
        m_all = fmaxf(
            m_all, ring[((qg * (C::KW - 1) + w) * 32 + lane) * XS + 4 * NF + h]);
      const float c_own = expf(m[h] - m_all);
      float sum = l[h] * c_own;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        o[j][2 * h] *= c_own;
        o[j][2 * h + 1] *= c_own;
      }
#pragma unroll
      for (int w = 0; w < C::KW - 1; ++w) {
        const float* x = ring + ((qg * (C::KW - 1) + w) * 32 + lane) * XS;
        const float c = expf(x[4 * NF + h] - m_all);
        sum = fmaf(x[4 * NF + 2 + h], c, sum);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          o[j][2 * h] = fmaf(x[4 * j + 2 * h], c, o[j][2 * h]);
          o[j][2 * h + 1] = fmaf(x[4 * j + 2 * h + 1], c, o[j][2 * h + 1]);
        }
      }
      inv[h] = 1.f / sum;
    }
  } else {
    inv[0] = 1.f / l[0];
    inv[1] = 1.f / l[1];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qg * 16 + g + 8 * h;
    if (qi >= q_n) continue;
    float* dst = out + (size_t)(q_row0 + qi) * d + head * DK + 2 * t;
#pragma unroll
    for (int j = 0; j < NF; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(o[j][2 * h] * inv[h], o[j][2 * h + 1] * inv[h]);
  }
}

// Internal linkage: each library raises its own kernels' shared-memory
// limit (see gemm_launch in gemm.cuh).
namespace {

template <int DK, bool PACKED>
cudaError_t core_prepare() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_core<DK, PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Core<DK, PACKED>::BYTES);
  return attr;
}

template <int DK, bool PACKED>
int core_launch(const QkvSource& src, const float* kmask, float* out, int R,
                int d, int heads, int seg, float scale, cudaStream_t s) {
  using C = Core<DK, PACKED>;
  const cudaError_t e = core_prepare<DK, PACKED>();
  if (e != cudaSuccess) return (int)e;
  const int n_seg = R / seg;
  const int per_tile = PACKED ? AC_KT / seg : 0;
  const int tiles = PACKED ? (n_seg + per_tile - 1) / per_tile
                           : n_seg * ((seg + C::QT - 1) / C::QT);
  attention_core<DK, PACKED><<<dim3(tiles, heads), C::THREADS, C::BYTES, s>>>(
      src, kmask, out, R, d, seg, per_tile, scale);
  return 0;
}

// registers and spill bytes a thread, dynamic shared memory a block,
// resident blocks an SM
template <int DK, bool PACKED>
int core_info(int* info) {
  const void* fn = (const void*)attention_core<DK, PACKED>;
  cudaError_t e = core_prepare<DK, PACKED>();
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, Core<DK, PACKED>::THREADS, Core<DK, PACKED>::BYTES);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = Core<DK, PACKED>::BYTES;
  info[3] = blocks;
  return 0;
}

}  // namespace

// att (R, d) = per-segment attention of the QKV product's rows, heads of
// width d / heads (64 or 96) at columns h * dk of each third; kmask: (R,)
// key validity (0 = masked) or null. The schedule follows seg: packed up
// to 64, streamed past it.
inline int attention(const QkvSource& src, const float* kmask, float* att,
                     int R, int d, int heads, int seg, cudaStream_t s) {
  if (seg <= 0 || R % seg != 0 || heads <= 0 || d % heads != 0)
    return JT_ERR_SHAPE;
  if (!aligned16(src.rows) || !aligned16(att) ||
      (src.splits > 1 && !aligned16(src.bias)))
    return JT_ERR_SHAPE;
  const int dk = d / heads;
  const float scale = 1.f / sqrtf((float)dk);
  const bool packed = seg <= AC_KT;
  int rc = JT_ERR_SHAPE;
  if (dk == 64)
    rc = packed ? core_launch<64, true>(src, kmask, att, R, d, heads, seg,
                                        scale, s)
                : core_launch<64, false>(src, kmask, att, R, d, heads, seg,
                                         scale, s);
  if (dk == 96)
    rc = packed ? core_launch<96, true>(src, kmask, att, R, d, heads, seg,
                                        scale, s)
                : core_launch<96, false>(src, kmask, att, R, d, heads, seg,
                                         scale, s);
  if (rc != 0) return rc;
  JT_CHECK_LAUNCH();
  return 0;
}

// What the compiler and the occupancy calculator say of one schedule of
// the core: {registers, spill bytes, shared memory, blocks an SM}.
inline int attention_info(int dk, bool packed, int* info) {
  if (dk == 64) return packed ? core_info<64, true>(info)
                              : core_info<64, false>(info);
  if (dk == 96) return packed ? core_info<96, true>(info)
                              : core_info<96, false>(info);
  return JT_ERR_SHAPE;
}

}  // namespace jt
