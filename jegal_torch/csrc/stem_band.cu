// Band GestSync stem for Hopper (sm_90a): the function of stem.cu (conv3d
// k(5,7,7) s(1,3,3) 3->64 -> folded BN -> ReLU -> maxpool (1,3,3)/(1,2,2)),
// computed down each frame's rows instead of in tiles.
//
// Replaces jegal_tpu/ops/pallas/stem.py:_stem_kernel_band (reached through
// stem_mgrid_x / stem_mgrid_planar with impl="band"), on both input forms
// of stem.cuh. The TPU kernel walks a sequential grid down the pooled rows
// j, keeps three K-bands of input rows, fetches only the two new input rows
// a step and carries conv row 2j in scratch. Hopper has no sequential
// grid, so the walk is a loop inside the block:
//   * a block owns a strip of 8 pooled columns (17 conv columns, 55 input
//     columns) of 7 consecutive output frames (11 input frames), for all 64
//     channels, and a run of pooled rows [j_a, j_b); it loops over the
//     pairs of conv rows (2m, 2m+1), m = j_a .. j_b;
//   * a ring of 10 input rows a frame in shared memory holds what a pair
//     reads (rows 6m..6m+9, row y in slot y % 10); after a pair's products
//     only the 6 new rows of each input frame are copied in, over the
//     slots of rows 6m..6m+5, which no later pair reads;
//   * after pair m, pooled row m-1 is the max of the carried row max of
//     pair m-1, conv row 2m and the 3-column window; the carry becomes the
//     row max of pair m. No conv row is computed twice (the window
//     kernel's tiles overlap by a conv row and a column, and each restages
//     a 49-row patch a tap), and a run of pooled rows starts one pair early
//     for its carry.
//
// What bounds it: operations, as the window kernel (190 GFLOP for a 5 s
// clip): 1.153 ms in 3xTF32 at the 495 TFLOP/s of the tensor cores, 0.768
// ms for the planar entry, whose integer pixels are exact in TF32 and take
// two passes. The products run in the window kernel's arithmetic, on
// Hopper's warpgroup products (wgmma):
//   * an implicit GEMM, one temporal tap at a time: M = a pair's positions,
//     N = 64, K = the tap's 147 taps in (dy, dx, c) order padded to 152;
//   * 3xTF32 (lo*hi, hi*lo, hi*hi, small terms first), the products added
//     to a float32 sum every 32 columns of K (the tensor cores truncate as
//     they accumulate): wgmma m64n64k8 TF32, A from registers, B from
//     shared memory. On float frames each k8 step's products are a group,
//     waited for one step later, so that the A registers (hi and lo) of two
//     steps are live, not of all four (that spilled); the planar entry's
//     one plane of A waits once a flush;
//   * two warpgroups, each two m64 tiles x 64 channels. A warp's 16 rows
//     of a tile are 8 (frame, column) positions, rows g their conv row 2m
//     and rows g + 8 their row 2m + 1, so a thread holds both rows of its
//     positions and forms the pair's row max and the carry in registers.
//     The 4 tiles hold 128 positions, 119 used (7 frames x 17 columns);
//   * A is gathered from the raw ring as it loads: the element of position
//     q, column k is ring[xoff[q] + dt * frame + koff[rho][k]], with
//     rho = (6m + 3r) % 10 the ring slot of the row's first input row and
//     koff a table of the 10 rotations built once. Float pixels are split
//     into TF32 hi and lo there; the planar entry's bytes are converted,
//     exact, and take two passes (Src::exact, `if constexpr`);
//   * B is K-major, as TF32 wgmma takes it: a tap's weights arrive raw by
//     cp.async while the tap before runs, and are split once into hi and
//     lo planes of 8 x 4 core matrices (wgmma_desc) between two taps.
// The next pair's new rows arrive while this pair's epilogue runs. Planar
// frames stage bytes: at stride 3 an input row of the (T, H3, 27, W3) layout
// is 9 runs of W3 bytes (planes (y % 3, dw, c)), and the ring holds 32 bytes
// of each, so a column's offset splits into a per-position part (the column)
// and a per-tap part (plane, dx / 3, row slot). Rows that are not 16-byte
// aligned (a frame width not a multiple of 4, planar W3 not a multiple of
// 16) take plain loads into the same ring. Shared memory: 195.5 KB (float),
// 153.2 KB (planar); one block an SM. The launcher cuts the pooled rows into
// runs so that the blocks fill whole waves of the card's SMs.
//
// stem_band_bf16_kernel is its bf16 variant (kernel 2b); see the note
// above it below.
#include <type_traits>

#include "gemm.cuh"
#include "stem.cuh"

namespace jt {

constexpr int SB_PI = 8;                   // pooled columns a strip
constexpr int SB_CC = 2 * SB_PI + 1;       // conv columns (17)
constexpr int SB_F = 7;                    // output frames a block
constexpr int SB_FIN = SB_F + ST_KT - 1;   // input frames a block (11)
constexpr int SB_NPOS = SB_F * SB_CC;      // (frame, column) positions (119)
constexpr int SB_RING = 10;                // input rows a pair reads
constexpr int SB_NEW = 2 * ST_S;           // new input rows a pair (6)
constexpr int SB_WGS = 2, SB_THREADS = 128 * SB_WGS;   // warpgroups
constexpr int SB_MT = 2;                   // a warpgroup's m64 tiles
constexpr int SB_SLOTS = 32 * SB_WGS * SB_MT;    // 128 position slots
constexpr int SB_KG = ST_KP / 4;           // K's core-matrix columns (38)
constexpr int SB_PLANE = SB_KG * 4 * ST_C; // words of a TF32 weight plane
constexpr int SB_VLD = ST_C + 8;           // row of the pooling buffer
static_assert(SB_SLOTS >= SB_NPOS, "the tiles hold a pair's positions");
static_assert(SB_SLOTS * SB_VLD <= SB_PLANE,
              "the pooling buffer fits a weight plane");
static_assert(ST_S + ST_KH <= SB_RING, "a pair reads SB_RING input rows");

// The ring of each input form: elements a staged row, a frame, from one
// conv column to the next, and the per-tap offset of (row slot, dx, c).
template <class Src> struct BandRing;

template <> struct BandRing<FloatFrames> {
  using Elem = float;
  static constexpr int ROW = 168;          // 55 columns x 3, padded
  static constexpr int PIECES = ROW / 4;   // 16-byte copies a row
  static constexpr int FRAME = SB_RING * ROW;
  static constexpr int WORDS = SB_FIN * FRAME;
  static constexpr int COL = ST_S * ST_CIN;
  __device__ static int koff(int slot, int dx, int c) {
    return slot * ROW + dx * ST_CIN + c;
  }
};

template <> struct BandRing<PlanarU8> {
  using Elem = uint8_t;
  static constexpr int RUN = 32;           // bytes of a (dw, c) run: 19 used
  static constexpr int ROW = 9 * RUN;
  static constexpr int FRAME = SB_RING * ROW;
  static constexpr int WORDS = SB_FIN * FRAME / 4;
  static constexpr int COL = 1;            // a conv column is one w3 step
  __device__ static int koff(int slot, int dx, int c) {
    return slot * ROW + ((dx % 3) * ST_CIN + c) * RUN + dx / 3;
  }
};

// Shared memory (words): the hi and lo weight planes, the raw weights,
// the koff table, the ring.
template <class Src>
constexpr int SB_SMEM_WORDS =
    2 * SB_PLANE + ST_WS + SB_RING * ST_KP + BandRing<Src>::WORDS;

// Issue the copies of input rows [y0, y0 + n) of the block's input frames
// (from t0) into their ring slots: cp.async when `async` (16-byte aligned
// rows), else plain loads. Pixels past the clip or the frame are zero.
// Float frames: a staged row is 168 floats from column x0.
__device__ __forceinline__ void issue_rows(const FloatFrames& s, int t0,
                                           int t_in, int x0, int y0, int n,
                                           float* ring, bool async) {
  using R = BandRing<FloatFrames>;
  const int wq = s.W * ST_CIN;
  for (int i = threadIdx.x; i < SB_FIN * n * R::PIECES; i += SB_THREADS) {
    const int fr = i / R::PIECES, q = (i - fr * R::PIECES) * 4;
    const int f = fr / n, y = y0 + fr % n;
    const int t = t0 + f, xq = x0 * ST_CIN + q;
    float* dst = ring + (f * SB_RING + y % SB_RING) * R::ROW + q;
    const float* src = s.p + ((size_t)t * s.H + y) * wq + xq;
    const bool row_ok = t < t_in && y < s.H;
    if (async) {   // wq % 4 == 0: a piece is wholly inside or outside
      const bool ok = row_ok && xq < wq;
      cp_async16(dst, ok ? src : s.p, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = (row_ok && xq + e < wq) ? __ldg(src + e) : 0.f;
    }
  }
}

// Planar frames: input row y of frame t is the 9 runs (dw, c) of planar
// row (t, y / 3), planes (y % 3) * 9 + (dw * 3 + c), each along w3 from
// x0 / 3.
__device__ __forceinline__ void issue_rows(const PlanarU8& s, int t0,
                                           int t_in, int x0, int y0, int n,
                                           uint8_t* ring, bool async) {
  using R = BandRing<PlanarU8>;
  const int H3 = s.H / 3, W3 = s.W / 3, w30 = x0 / 3;   // x0 % 3 == 0
  for (int i = threadIdx.x; i < SB_FIN * n * 9 * 2; i += SB_THREADS) {
    const int half = i & 1, j = (i >> 1) % 9, fr = (i >> 1) / 9;
    const int f = fr / n, y = y0 + fr % n;
    const int t = t0 + f, h3 = y / 3, dh = y - 3 * h3;
    const int w3 = w30 + 16 * half;
    uint8_t* dst = ring + (f * SB_RING + y % SB_RING) * R::ROW + j * R::RUN +
                   16 * half;
    const uint8_t* src =
        s.p + (((size_t)t * H3 + h3) * 27 + dh * 9 + j) * W3 + w3;
    const bool row_ok = t < t_in && y < s.H;
    if (async) {   // W3 % 16 == 0: a piece is wholly inside or outside
      const bool ok = row_ok && w3 < W3;
      cp_async16(reinterpret_cast<float*>(dst),
                 reinterpret_cast<const float*>(ok ? src : s.p), ok);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (row_ok && w3 + e < W3) ? __ldg(src + e) : (uint8_t)0;
    }
  }
}

// Issue the cp.async copies of a tap's raw (147, 64) weights.
__device__ __forceinline__ void issue_weights_raw(const float* __restrict__ wt,
                                                  float* raw) {
  for (int i = threadIdx.x; i < ST_WS / 4; i += SB_THREADS)
    cp_async16(raw + 4 * i, wt + 4 * i, true);
}

// The landed raw weights into TF32 hi and lo planes, K-major: element
// (n, k) at word (k / 4) * 256 + (n / 8) * 32 + (n % 8) * 4 + k % 4, so
// that a core matrix (8 n x 4 k) is 128 contiguous bytes, the next along
// N 128 bytes on and the next along K 1024; zero past the 147 taps.
__device__ __forceinline__ void split_weights(const float* raw, uint32_t* hi,
                                              uint32_t* lo) {
  for (int i = threadIdx.x; i < SB_KG * ST_C; i += SB_THREADS) {
    const int kg = i / ST_C, n = i - kg * ST_C;
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * kg + e;
      split_tf32(k < ST_TAPS ? raw[k * ST_C + n] : 0.f, h[e], l[e]);
    }
    const int o = kg * 4 * ST_C + (n >> 3) * 32 + (n & 7) * 4;
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// A ring element as A fragment values: float pixels split into TF32 hi and
// lo; bytes converted, exact in TF32 (lo unused).
__device__ __forceinline__ void a_value(float v, uint32_t& hi, uint32_t& lo) {
  split_tf32(v, hi, lo);
}

__device__ __forceinline__ void a_value(uint8_t v, uint32_t& hi, uint32_t&) {
  hi = __float_as_uint((float)v);
}

// src: (t_in, H, W, 3) frames in either input form (stem.cuh); w: (5, 7, 7,
// 3, 64) DHWIO; out: (t_in - 4, J, Wp, 64). grid: (ceil(Wp / 8),
// ceil((t_in - 4) / 7), ceil(J / run)): block z walks pooled rows
// [z run, min(J, (z + 1) run)).
template <class Src>
__global__ void __launch_bounds__(SB_THREADS, 1)
stem_band_kernel(Src src, const float* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int t_in, int J, int Wp, int run, bool async) {
  using R = BandRing<Src>;
  using Elem = typename R::Elem;
  constexpr bool exact = Src::exact;
  extern __shared__ __align__(16) float smem[];
  uint32_t* Bhi = reinterpret_cast<uint32_t*>(smem);   // [38][8][8][4]
  uint32_t* Blo = Bhi + SB_PLANE;
  float* raw = reinterpret_cast<float*>(Blo + SB_PLANE);   // [147][64]
  int* koff = reinterpret_cast<int*>(raw + ST_WS);         // [10][152]
  Elem* ring = reinterpret_cast<Elem*>(koff + SB_RING * ST_KP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, its warp's rows
  const int i0 = blockIdx.x * SB_PI;        // pooled col origin
  const int t0 = blockIdx.y * SB_F;         // first output frame
  const int j_a = blockIdx.z * run;         // pooled rows [j_a, j_b)
  const int j_b = min(J, j_a + run);
  const int t_out = t_in - (ST_KT - 1);
  const int x_in0 = 2 * ST_S * i0;          // first input column

  issue_rows(src, t0, t_in, x_in0, 2 * ST_S * j_a, SB_RING, ring, async);
  issue_weights_raw(w, raw);
  cp_async_commit();
  // koff[rho][k]: tap column k's offset when the row's first input row
  // sits in ring slot rho
  for (int i = tid; i < SB_RING * ST_KP; i += SB_THREADS) {
    const int rho = i / ST_KP, k = i - rho * ST_KP;
    const int dy = k / (ST_KW * ST_CIN), r = k - dy * ST_KW * ST_CIN;
    koff[i] = k < ST_TAPS
                  ? R::koff((rho + dy) % SB_RING, r / ST_CIN, r % ST_CIN)
                  : 0;
  }

  // position slot and ring offset of this thread's rows of each tile
  int slot[SB_MT], xoff[SB_MT];
#pragma unroll
  for (int i = 0; i < SB_MT; ++i) {
    slot[i] = ((wg * SB_MT + i) * 4 + wq) * 8 + g;
    const int q = min(slot[i], SB_NPOS - 1);
    xoff[i] = (q / SB_CC) * R::FRAME + (q % SB_CC) * R::COL;
  }

  float acc[SB_MT][32];   // the wgmma sums of 32 columns of K
  float carry[SB_MT][2 * ST_NF];   // row max of the last pair
#pragma unroll
  for (int i = 0; i < SB_MT; ++i) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 2 * ST_NF; ++e) carry[i][e] = 0.f;
  }

  for (int m = j_a; m <= j_b; ++m) {      // pair m: conv rows 2m, 2m + 1
    const int* k0 = koff + (2 * ST_S * m) % SB_RING * ST_KP;
    const int* k1 = koff + (2 * ST_S * m + ST_S) % SB_RING * ST_KP;
    float sum[SB_MT][32];
#pragma unroll
    for (int i = 0; i < SB_MT; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) sum[i][e] = 0.f;

    for (int dt = 0; dt < ST_KT; ++dt) {
      cp_async_wait<0>();
      __syncthreads();   // the tap's raw weights (and the rows) landed; the
                         // last tap's products and the pooling are done
      split_weights(raw, Bhi, Blo);
      fence_proxy_async();
      __syncthreads();   // the planes ready for wgmma; the raw buffer free
      if (m < j_b || dt + 1 < ST_KT)
        issue_weights_raw(w + (size_t)((dt + 1) % ST_KT) * ST_WS, raw);
      cp_async_commit();
      const Elem* x = ring + dt * R::FRAME;

#pragma unroll
      for (int s0 = 0; s0 < ST_KSTEPS; s0 += ST_FLUSH) {
#pragma unroll
        for (int s = s0; s < min(s0 + ST_FLUSH, ST_KSTEPS); ++s) {
          const int k = 8 * s + t4;
          const int a0 = k0[k], a1 = k1[k], b0 = k0[k + 4], b1 = k1[k + 4];
          uint32_t ahi[SB_MT][4], alo[SB_MT][4];
#pragma unroll
          for (int i = 0; i < SB_MT; ++i) {
            const Elem* xp = x + xoff[i];
            a_value(xp[a0], ahi[i][0], alo[i][0]);   // row g: conv row 2m
            a_value(xp[a1], ahi[i][1], alo[i][1]);   // row g + 8: 2m + 1
            a_value(xp[b0], ahi[i][2], alo[i][2]);
            a_value(xp[b1], ahi[i][3], alo[i][3]);
          }
          // k8 step s: core-matrix columns 2s, 2s + 1 of the planes
          const uint64_t dhi = wgmma_desc(Bhi + s * 8 * ST_C, 4 * ST_C * 4,
                                          128);
          const uint64_t dlo = wgmma_desc(Blo + s * 8 * ST_C, 4 * ST_C * 4,
                                          128);
          const bool first = s == s0;   // the products start from zero
          wgmma_fence();
          if constexpr (!exact) {
#pragma unroll
            for (int i = 0; i < SB_MT; ++i)
              wgmma_tf32(acc[i], alo[i], dhi, !first);
          }
#pragma unroll
          for (int i = 0; i < SB_MT; ++i)
            wgmma_tf32(acc[i], ahi[i], dlo, !(first && exact));
#pragma unroll
          for (int i = 0; i < SB_MT; ++i)
            wgmma_tf32(acc[i], ahi[i], dhi, true);
          if constexpr (!exact) {
            wgmma_commit();
            wgmma_wait<1>();   // step s - 1's products done: its A
                               // registers free for step s + 1's gather
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < SB_MT; ++i)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            wgmma_pin(acc[i][e]);
            sum[i][e] += acc[i][e];
          }
      }
    }

    __syncthreads();   // every tap of the pair has read the ring
    if (m < j_b)       // pair m + 1 reads rows 6m+6..6m+15
      issue_rows(src, t0, t_in, x_in0, 2 * ST_S * m + SB_RING, SB_NEW, ring,
                 async);
    cp_async_commit();

    // BN + ReLU; V = max(carry, conv row 2m) into the hi plane (free: the
    // next tap's weights land raw); the carry becomes the pair's row max
    float* V = reinterpret_cast<float*>(Bhi);
#pragma unroll
    for (int j = 0; j < ST_NF; ++j) {
      const int c = j * 8 + 2 * t4;
      const float s0 = __ldg(scale + c), s1 = __ldg(scale + c + 1);
      const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
      for (int i = 0; i < SB_MT; ++i) {
        const float r0a = fmaxf(fmaf(sum[i][4 * j], s0, b0), 0.f);
        const float r0b = fmaxf(fmaf(sum[i][4 * j + 1], s1, b1), 0.f);
        const float r1a = fmaxf(fmaf(sum[i][4 * j + 2], s0, b0), 0.f);
        const float r1b = fmaxf(fmaf(sum[i][4 * j + 3], s1, b1), 0.f);
        if (m > j_a)
          *reinterpret_cast<float2*>(V + slot[i] * SB_VLD + c) =
              make_float2(fmaxf(carry[i][2 * j], r0a),
                          fmaxf(carry[i][2 * j + 1], r0b));
        carry[i][2 * j] = fmaxf(r0a, r1a);
        carry[i][2 * j + 1] = fmaxf(r0b, r1b);
      }
    }
    if (m == j_a) continue;
    __syncthreads();
    // pooled row m - 1: the 3-column window of V, coalesced over channels
    for (int q = tid; q < SB_F * SB_PI * ST_C; q += SB_THREADS) {
      const int o = q % ST_C;
      const int pos = q / ST_C;
      const int f = pos / SB_PI, pi = pos % SB_PI;
      const int t = t0 + f, i = i0 + pi;
      if (t >= t_out || i >= Wp) continue;
      const float* v = V + (f * SB_CC + 2 * pi) * SB_VLD + o;
      out[(((size_t)t * J + (m - 1)) * Wp + i) * ST_C + o] =
          fmaxf(fmaxf(v[0], v[SB_VLD]), v[2 * SB_VLD]);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 2b: the bf16 band stem
// ---------------------------------------------------------------------------
//
// The bf16 variant (the JAX engine's bf16 dtype) on bf16 float frames (the
// /255 rounded to bf16 by the mask) and on the planar bytes with a bf16
// weight (/255 folded in float32, then rounded). Arithmetic: products of
// bf16 values (exact in float32; uint8 pixels are exact in bf16) on wgmma
// m64n64k16 bf16, added to a float32 sum every 32 columns of K (two k16
// steps), tap by tap; the three taps of each row, BN and ReLU in float32;
// the pooled max rounded to bf16 once, which equals the max of the conv
// rows rounded to bf16 (`_stem_kernel_band` rounds each conv row,
// stem.py:305, and takes the max on bf16 values, :336): rounding is
// monotone.
//
// Bound: operations, 190 GFLOP at 989 TFLOP/s, 0.192 ms a 5 s clip. The
// first bf16 design (the float32 kernel's schedule in bf16) ran at 7.8x
// that: every pair of conv rows repacked each tap's raw weights into the
// wgmma plane behind two block barriers (10 barriers a pair, the weight
// repacked ~16 times a block), and its 8 warps gathered each A register
// pair through a koff[rotation][k] table with two 2-byte loads, waiting for
// their products at every flush. This design:
//  * K order: each tap's 147 columns in (dy, dx, c) order, each dy's 21
//    padded to 24 (zero weights), 168 padded to 176 = 11 k16 steps. Then
//    every A register (two neighbouring k of one row) is two neighbouring
//    pixels' values of one input row, and its k8 group q lies in row dy =
//    q / 3 at 8 (q % 3) + 2t of the position's 24-element window: every
//    offset but the ring slot of dy is known when the kernel is compiled.
//  * A ring of 10 input rows a frame (row y in slot y % 10, the band
//    schedule of the float32 kernel), in bf16 for both entries, twice: as
//    staged (copy 0) and shifted by one element (copy 1), so that a
//    position's window (9 elements a conv column on) starts on a 4-byte
//    boundary in one of them and each A register is one 32-bit load (4 a
//    k16 step, no table, no pack). Float frames land in copy 0 by
//    cp.async and a warp a row builds copy 1; planar bytes land as they
//    are (over copy 1's slots of the same rows) and a warp a row converts
//    them into both copies once, as they land.
//  * The weights packed once a block, at its start, into five resident
//    K-major planes of 8 n x 8 k core matrices (LBO 1024, SBO 128 bytes,
//    110 KB): no repack and no barrier between taps.
//  * 4 consumer warpgroups of one m64 tile each (16 warps: twice the
//    warps, half the registers a thread of the first design): a warp's 16
//    rows are 8 (frame, column) positions, rows g their conv row 2m and g
//    + 8 their row 2m + 1, so a thread holds both rows of its position and
//    forms the pair's row max in registers; 128 positions, 119 used. The
//    carry (the row max of the pair before) waits in shared memory as
//    bf16, which gives the same pooled value (rounding is monotone) and
//    keeps the 128 registers a thread of 512 from spilling. Each flush
//    group's A registers are loaded while the group before runs on the
//    tensor cores.
//  * Persistent: a block an SM walks the (strip, frame group, run of
//    pooled rows) units; a pair costs 4 block barriers (rows landed,
//    copies built, products done, pooling buffer written) and the next
//    pair's rows arrive while this pair's epilogue runs. The pooling
//    buffer holds the bf16 of max(carry, conv row 2m); the folded scale
//    and bias wait in shared memory.
// A warp-specialized shape (a producer warpgroup writing
// each (pair, tap) im2col tile into the swizzle for wgmma with A from
// shared memory) does not fit: 256 GEMM rows x 160 K is 80 KB a stage.
// Shared memory: 5 planes 110 KB, the two ring copies 72.2 KB, the pooling
// buffer 18 KB, the carry 16 KB, scale and bias 0.5 KB: 216.7 KB, one
// block an SM. The K layout, the planes' packing, the rows' staging,
// shift and conversion and the flush groups are stem.cuh's, shared with
// the bf16 window stem (stem.cu, kernel 1b).

constexpr int SBB_FRAME = SB_RING * S16_ROW;
constexpr int SBB_RING = SB_FIN * SBB_FRAME;   // halves of a ring copy
constexpr int SBB_VLD = ST_C + 8;           // a pooling buffer row (halves)
// the carry: a thread's bf16 channel pairs, [n8 tile][slot][t4] words
constexpr int SBB_CARRY = ST_NF * SB_SLOTS * 4;
constexpr int SBB_SMEM = 2 * (ST_KT * S16_PLANE + 2 * SBB_RING +
                              SB_SLOTS * SBB_VLD) + 4 * SBB_CARRY +
                         4 * 2 * ST_C;   // + the folded scale and bias
static_assert(SB_SLOTS == 32 * S16_WGS, "a warpgroup an m64 tile");
static_assert(ST_S * ST_CIN * (SB_CC - 1) + S16_DY <= S16_ROW,
              "a window lies in its staged row");
static_assert(SBB_SMEM <= 232448, "fits an SM");

// The ring slot of frame row fr of the rows [y0, y0 + n) of the block's
// input frames (from t0): {t, y, element offset of its slot}.
__device__ __forceinline__ int3 ring_row(int fr, int t0, int y0, int n) {
  const int f = fr / n, y = y0 + fr - f * n;
  return make_int3(t0 + f, y, f * SBB_FRAME + (y % SB_RING) * S16_ROW);
}

// Flush group G's A registers of a thread's position, whose window starts
// at x (copy and frame chosen), the ring slots of conv rows 2m and 2m + 1
// starting at rho0, rho1. a[s][0]: row g (2m), k 2t, 2t + 1 of the step;
// a[s][1]: row g + 8; a[s][2], a[s][3]: k + 8.
template <int G>
__device__ __forceinline__ void band_load(uint32_t (&a)[S16_FLUSH][4],
                                          const uint16_t* x, int rho0,
                                          int rho1, int t4) {
  using B = S16Group<G>;
#pragma unroll
  for (int s = 0; s < B::NS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * (B::S0 + s) + h;        // the k8 group
      const int dy = q / 3, j = 8 * (q % 3) + 2 * t4;
      const int r0 = rho0 + dy, r1 = rho1 + dy;
      a[s][2 * h] = *reinterpret_cast<const uint32_t*>(
          x + (r0 - (r0 >= SB_RING ? SB_RING : 0)) * S16_ROW + j);
      a[s][2 * h + 1] = *reinterpret_cast<const uint32_t*>(
          x + (r1 - (r1 >= SB_RING ? SB_RING : 0)) * S16_ROW + j);
    }
}

// src: (t_in, H, W, 3) frames, bf16 or planar bytes; w: (5, 7, 7, 3, 64)
// DHWIO bf16; out: (t_in - 4, J, Wp, 64) bf16. A persistent grid over the
// units (strip, frame group, run of `run` pooled rows), strip fastest.
template <class Src>
__global__ void __launch_bounds__(S16_THREADS, 1)
stem_band_bf16_kernel(Src src, const uint16_t* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      uint16_t* __restrict__ out, int t_in, int J, int Wp,
                      int run, bool async) {
  extern __shared__ __align__(16) uint16_t smem_sbb[];
  uint16_t* planes = smem_sbb;                       // [5][22][8][8][8]
  uint16_t* ring0 = planes + ST_KT * S16_PLANE;      // [11][10][168]
  uint16_t* ring1 = ring0 + SBB_RING;
  uint16_t* V = ring1 + SBB_RING;                    // [128][72]
  uint32_t* carry = reinterpret_cast<uint32_t*>(V + SB_SLOTS * SBB_VLD);
  float* sc = reinterpret_cast<float*>(carry + SBB_CARRY);   // [64] x 2
  float* bi = sc + ST_C;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int t_out = t_in - (ST_KT - 1);
  const int strips = (Wp + SB_PI - 1) / SB_PI;
  const int groups = (t_out + SB_F - 1) / SB_F;
  const int units = strips * groups * ((J + run - 1) / run);

  pack_planes_bf16(w, planes);
  fence_proxy_async();   // the planes, written by threads, read by wgmma
  if (tid < ST_C) {
    sc[tid] = scale[tid];
    bi[tid] = bias[tid];
  }

  // this thread's position (slot) and its window in the ring: copy 1 for an
  // odd conv column, so that the window starts on a 4-byte boundary
  const int slot = warp * 8 + g;
  const int q = min(slot, SB_NPOS - 1);
  const int col = q % SB_CC;
  const uint16_t* xw = ((col & 1) ? ring1 + ST_S * ST_CIN * col - 1
                                  : ring0 + ST_S * ST_CIN * col) +
                       (q / SB_CC) * SBB_FRAME;

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int i0 = (u % strips) * SB_PI;             // pooled col origin
    const int t0 = (u / strips % groups) * SB_F;     // first output frame
    const int j_a = u / (strips * groups) * run;     // pooled rows [j_a, j_b)
    const int j_b = min(J, j_a + run);
    const int x_in0 = 2 * ST_S * i0;                 // first input column

    int y_new = 2 * ST_S * j_a, n_new = SB_RING;   // the rows staged last
    const auto landed = [&](int fr) {
      return ring_row(fr, t0, y_new, n_new);
    };
    __syncthreads();   // the unit before is done with the ring and V
    stage_rows(src, SB_FIN * n_new, landed, t_in, x_in0, ring0, ring1, async);
    cp_async_commit();

    for (int m = j_a; m <= j_b; ++m) {      // pair m: conv rows 2m, 2m + 1
      cp_async_wait<0>();
      __syncthreads();   // the rows landed
      if constexpr (std::is_same<Src, PlanarU8>::value)
        convert_rows(SB_FIN * n_new, landed, ring0, ring1);
      else
        shift_rows(SB_FIN * n_new, landed, ring0, ring1);
      __syncthreads();   // both copies written

      const int rho0 = (2 * ST_S * m) % SB_RING;
      const int rho1 = (2 * ST_S * m + ST_S) % SB_RING;
      float sum[32], acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sum[e] = 0.f;
      uint32_t a0[S16_FLUSH][4], a1[S16_FLUSH][4];
      band_load<0>(a0, xw, rho0, rho1, t4);
      for (int dt = 0; dt < ST_KT; ++dt) {
        const uint16_t* pl = planes + dt * S16_PLANE;
        const uint16_t* x = xw + dt * SBB_FRAME;
        // each group's A loads overlap the group before on the tensor
        // cores; the last group's, the next tap's first
        group_issue<0>(acc, a0, pl);
        band_load<1>(a1, x, rho0, rho1, t4);
        group_flush(sum, acc);
        group_issue<1>(acc, a1, pl);
        band_load<2>(a0, x, rho0, rho1, t4);
        group_flush(sum, acc);
        group_issue<2>(acc, a0, pl);
        band_load<3>(a1, x, rho0, rho1, t4);
        group_flush(sum, acc);
        group_issue<3>(acc, a1, pl);
        band_load<4>(a0, x, rho0, rho1, t4);
        group_flush(sum, acc);
        group_issue<4>(acc, a0, pl);
        band_load<5>(a1, x, rho0, rho1, t4);
        group_flush(sum, acc);
        group_issue<5>(acc, a1, pl);
        if (dt + 1 < ST_KT)
          band_load<0>(a0, x + SBB_FRAME, rho0, rho1, t4);
        group_flush(sum, acc);
      }

      __syncthreads();   // every warp has read the ring
      if (m < j_b) {     // pair m + 1 reads rows 6m+6..6m+15
        y_new = 2 * ST_S * m + SB_RING;
        n_new = SB_NEW;
        stage_rows(src, SB_FIN * n_new, landed, t_in, x_in0, ring0, ring1,
                   async);
      }
      cp_async_commit();

      // BN + ReLU; V = bf16(max(carry, conv row 2m)); the carry becomes the
      // bf16 of the pair's row max (rounding is monotone: the same V)
#pragma unroll
      for (int j = 0; j < ST_NF; ++j) {
        uint32_t& cw = carry[(j * SB_SLOTS + slot) * 4 + t4];
        const int c = j * 8 + 2 * t4;
        const float s0 = sc[c], s1 = sc[c + 1], b0 = bi[c], b1 = bi[c + 1];
        const float r0a = fmaxf(fmaf(sum[4 * j], s0, b0), 0.f);
        const float r0b = fmaxf(fmaf(sum[4 * j + 1], s1, b1), 0.f);
        const float r1a = fmaxf(fmaf(sum[4 * j + 2], s0, b0), 0.f);
        const float r1b = fmaxf(fmaf(sum[4 * j + 3], s1, b1), 0.f);
        if (m > j_a)
          *reinterpret_cast<uint32_t*>(V + slot * SBB_VLD + c) =
              pack_bf16(f2bf(fmaxf(bf2f(cw), r0a)),
                        f2bf(fmaxf(bf2f(cw >> 16), r0b)));
        cw = pack_bf16(f2bf(fmaxf(r0a, r1a)), f2bf(fmaxf(r0b, r1b)));
      }
      if (m == j_a) continue;
      __syncthreads();   // V written
      // pooled row m - 1: the 3-column window of V, 8 channels a thread
      for (int i = tid; i < SB_F * SB_PI * (ST_C / 8); i += S16_THREADS) {
        const int cg = i % (ST_C / 8), pos = i / (ST_C / 8);
        const int f = pos / SB_PI, pi = pos % SB_PI;
        const int t = t0 + f, ii = i0 + pi;
        if (t >= t_out || ii >= Wp) continue;
        const uint16_t* v = V + (f * SB_CC + 2 * pi) * SBB_VLD + 8 * cg;
        const uint4 p0 = *reinterpret_cast<const uint4*>(v);
        const uint4 p1 = *reinterpret_cast<const uint4*>(v + SBB_VLD);
        const uint4 p2 = *reinterpret_cast<const uint4*>(v + 2 * SBB_VLD);
        const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&p0);
        const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&p1);
        const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&p2);
        uint32_t r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)   // bf16 >= 0 (after ReLU): max as floats
          r[e] = pack_bf16(
              f2bf(fmaxf(fmaxf(bf2f(w0[e]), bf2f(w1[e])), bf2f(w2[e]))),
              f2bf(fmaxf(fmaxf(bf2f(w0[e] >> 16), bf2f(w1[e] >> 16)),
                         bf2f(w2[e] >> 16))));
        *reinterpret_cast<uint4*>(
            out + (((size_t)t * J + (m - 1)) * Wp + ii) * ST_C + 8 * cg) =
            make_uint4(r[0], r[1], r[2], r[3]);
      }
    }
  }
}

}  // namespace jt

// Pooled rows a block walks: the run that fills whole waves of the card's
// SMs best, counting a run of n rows as n + 1 pairs (its carry's pair),
// from 1 to 4 runs a strip.
static int band_run(int units, int J, int slots) {
  int best = J, best_cost = -1;
  for (int runs = 1; runs <= 4; ++runs) {
    const int run = (J + runs - 1) / runs;
    const int blocks = units * ((J + run - 1) / run);
    const int cost = (blocks + slots - 1) / slots * (run + 1);
    if (best_cost < 0 || cost < best_cost) best = run, best_cost = cost;
  }
  return best;
}

template <class Src>
static int launch_stem_band(Src src, const float* w, const float* scale,
                            const float* bias, float* out, int t_in,
                            bool async, cudaStream_t stream) {
  using namespace jt;
  constexpr int smem = (int)sizeof(float) * SB_SMEM_WORDS<Src>;
  const int J = stem_pooled(src.H), Wp = stem_pooled(src.W);
  if (t_in < ST_KT || J < 1 || Wp < 1) return JT_ERR_SHAPE;
  // once per entry, not at every launch (a launcher's static has internal
  // linkage here, so it is this library's own)
  static const Resident setup =
      resident_blocks(stem_band_kernel<Src>, SB_THREADS, smem);
  if (setup.err != cudaSuccess) return (int)setup.err;
  const int t_out = t_in - (ST_KT - 1);
  const int strips = (Wp + SB_PI - 1) / SB_PI;
  const int groups = (t_out + SB_F - 1) / SB_F;
  const int run = band_run(strips * groups, J, setup.slots);
  dim3 grid(strips, groups, (J + run - 1) / run);
  stem_band_kernel<Src><<<grid, SB_THREADS, smem, stream>>>(
      src, w, scale, bias, out, t_in, J, Wp, run, async);
  JT_CHECK_LAUNCH();
  return 0;
}

// frames (t_in, H, W, 3) float32 -> out (t_in - 4, J, Wp, 64), as
// jt_stem_pool.
extern "C" int jt_stem_band(const float* frames, const float* w,
                            const float* scale, const float* bias, float* out,
                            int t_in, int H, int W, void* stream) {
  const bool async = (uintptr_t)frames % 16 == 0 && W % 4 == 0;
  return launch_stem_band(jt::FloatFrames{frames, H, W}, w, scale, bias, out,
                          t_in, async, (cudaStream_t)stream);
}

// planar (t_in, H3, 27, W3) uint8 -> out (t_in - 4, J, Wp, 64), as
// jt_stem_pool_planar (w pre-scaled by 1/255).
extern "C" int jt_stem_band_planar(const uint8_t* planar, const float* w,
                                   const float* scale, const float* bias,
                                   float* out, int t_in, int H3, int W3,
                                   void* stream) {
  const bool async = (uintptr_t)planar % 16 == 0 && W3 % 16 == 0;
  return launch_stem_band(jt::PlanarU8{planar, 3 * H3, 3 * W3}, w, scale,
                          bias, out, t_in, async, (cudaStream_t)stream);
}

// What the compiler and the occupancy calculator say of one entry's
// kernel (planar: 0 float frames, 1 planar): info = {registers a thread,
// local (spill) bytes a thread, dynamic shared bytes a block, blocks an SM}.
extern "C" int jt_stem_band_info(int planar, int* info) {
  using namespace jt;
  return planar ? stem_kernel_info((const void*)stem_band_kernel<PlanarU8>,
                                   SB_THREADS,
                                   4 * SB_SMEM_WORDS<PlanarU8>, info)
                : stem_kernel_info((const void*)stem_band_kernel<FloatFrames>,
                                   SB_THREADS,
                                   4 * SB_SMEM_WORDS<FloatFrames>, info);
}

// ---------------------------------------------------------------------------
// bf16 entries
// ---------------------------------------------------------------------------

template <class Src>
static int launch_stem_band_bf16(Src src, const uint16_t* w,
                                 const float* scale, const float* bias,
                                 uint16_t* out, int t_in, bool async,
                                 cudaStream_t stream) {
  using namespace jt;
  const int J = stem_pooled(src.H), Wp = stem_pooled(src.W);
  if (t_in < ST_KT || J < 1 || Wp < 1) return JT_ERR_SHAPE;
  if ((uintptr_t)out % 16 != 0) return JT_ERR_SHAPE;
  static const Resident setup =
      resident_blocks(stem_band_bf16_kernel<Src>, S16_THREADS, SBB_SMEM);
  if (setup.err != cudaSuccess) return (int)setup.err;
  const int t_out = t_in - (ST_KT - 1);
  const int strips = (Wp + SB_PI - 1) / SB_PI;
  const int groups = (t_out + SB_F - 1) / SB_F;
  const int run = band_run(strips * groups, J, setup.slots);
  const int units = strips * groups * ((J + run - 1) / run);
  stem_band_bf16_kernel<Src>
      <<<units < setup.slots ? units : setup.slots, S16_THREADS, SBB_SMEM,
         stream>>>(src, w, scale, bias, out, t_in, J, Wp, run, async);
  JT_CHECK_LAUNCH();
  return 0;
}

// frames (t_in, H, W, 3) bf16 -> out (t_in - 4, J, Wp, 64) bf16; w bf16,
// scale and bias float32.
extern "C" int jt_stem_band_bf16(const uint16_t* frames, const uint16_t* w,
                                 const float* scale, const float* bias,
                                 uint16_t* out, int t_in, int H, int W,
                                 void* stream) {
  const bool async = (uintptr_t)frames % 16 == 0 && (W * 3) % 8 == 0;
  return launch_stem_band_bf16(jt::Bf16Frames{frames, H, W}, w, scale, bias,
                               out, t_in, async, (cudaStream_t)stream);
}

// planar (t_in, H3, 27, W3) uint8 -> out (t_in - 4, J, Wp, 64) bf16; w the
// bf16 weight with /255 folded in.
extern "C" int jt_stem_band_planar_bf16(const uint8_t* planar,
                                        const uint16_t* w, const float* scale,
                                        const float* bias, uint16_t* out,
                                        int t_in, int H3, int W3,
                                        void* stream) {
  const bool async = (uintptr_t)planar % 16 == 0 && W3 % 16 == 0;
  return launch_stem_band_bf16(jt::PlanarU8{planar, 3 * H3, 3 * W3}, w,
                               scale, bias, out, t_in, async,
                               (cudaStream_t)stream);
}

// jt_stem_band_info of the bf16 kernel's entries.
extern "C" int jt_stem_band_bf16_info(int planar, int* info) {
  using namespace jt;
  return stem_kernel_info(
      planar ? (const void*)stem_band_bf16_kernel<PlanarU8>
             : (const void*)stem_band_bf16_kernel<Bf16Frames>,
      S16_THREADS, SBB_SMEM, info);
}
