// What the two GestSync stem kernels (stem.cu: window, stem_band.cu: band)
// share: the block-1 geometry and the two input forms a kernel reads its
// raw (t, y, x, c) pixels from.
//
//   FloatFrames: (T, H, W, 3) float32 frames in [0, 1], masked;
//   Bf16Frames:  the same in bf16 (uint16_t bit patterns), for the bf16
//                variants;
//   PlanarU8:    (T, H/3, 27, W/3) uint8 host-repacked frames (the JAX
//                package's host.media.s2d_repack; jegal_torch.ops.video
//                .s2d_repack), raw 0..255 bytes, the /255 folded into the
//                weights by the caller.
//
// A kernel is a template on its source, so one body serves both forms; the
// planar form is staged as bytes and converted in the kernel (the float32
// stem.cu a tap's patch at once, stem_band.cu each value as it gathers its
// A fragments, the bf16 kernels a staged row at a time). `exact` says every pixel is exact in TF32 (10
// mantissa bits): the integers 0..255 of the planar form are, so a
// tensor-core kernel needs no low TF32 part of them. Both kernels read the
// planar form in the raw frame's order, (y, x, c) -> [t, y/3,
// ((y%3)*3 + x%3)*3 + c, x/3], and do the same 7x7x3 taps either way: read
// as its s2d form, a 3x3 kernel over 27 channels, the 9x9 padded window
// would multiply 243 taps where 147 are nonzero.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "gemm.cuh"

namespace jt {

constexpr int ST_C = 64;                 // output channels
constexpr int ST_KT = 5, ST_KH = 7, ST_KW = 7, ST_CIN = 3, ST_S = 3;
constexpr int ST_TAPS = ST_KH * ST_KW * ST_CIN;     // 147 taps a frame
constexpr int ST_WS = ST_TAPS * ST_C;    // 9408 floats: one temporal tap
// The implicit GEMM of both kernels: K one temporal tap at a time, its 147
// taps in (dy, dx, c) order padded to 152 (k8 steps), the tensor cores'
// products added to a float32 sum every 32 columns.
constexpr int ST_KP = 152;               // 147 taps padded to k8 steps
constexpr int ST_KSTEPS = ST_KP / 8;     // 19
constexpr int ST_FLUSH = 4;              // k8 steps a float32 flush
constexpr int ST_NF = ST_C / 8;          // n8 tiles of the 64 channels

// Pooled geometry of an (H, W) frame: conv k7 s3, then pool k3 s2.
__host__ __device__ inline int stem_pooled(int n) {
  return ((n - ST_KH) / ST_S + 1 - 3) / 2 + 1;
}

struct FloatFrames {
  static constexpr bool exact = false;
  const float* p;
  int H, W;
};

struct Bf16Frames {
  const uint16_t* p;
  int H, W;
};

struct PlanarU8 {
  static constexpr bool exact = true;
  const uint8_t* p;
  int H, W;  // raw frame size: 3 H3 x 3 W3
};

// ---------------------------------------------------------------------------
// The bf16 stems, stem.cu's window kernel 1b and stem_band.cu's band kernel
// 2b: one K layout, one product schedule, one staging of the pixels
// ---------------------------------------------------------------------------
//
// Each temporal tap's K in (dy, dx, c) order with each dy row's 21 columns
// padded to 24 (zero weights) and 168 padded to 176 = 11 k16 steps. Then
// every A register (two neighbouring k of one row) is two neighbouring
// pixel values of one input row, and its k8 group q lies in row dy = q / 3
// at 8 (q % 3) + 2t of the position's 24-element window: every offset but
// the row of the position's window is known when the kernel is compiled.
// Products on wgmma m64n64k16 bf16 (exact products, float32 sums), A from
// registers, B from five K-major weight planes packed once a block; each
// flush group of 2 k16 steps (32 columns of K) from zero, added to a
// float32 sum; the taps in order. A staged input row is 168 halves (56
// pixels) from the block's first input column, kept twice: as staged (copy
// 0) and shifted by one element (copy 1), so that a position's window (9
// elements a conv column on) starts on a 4-byte boundary in one of them
// and each A register is one aligned 32-bit load. bf16 frames land in copy
// 0 by cp.async and a warp a row builds copy 1; planar bytes land as they
// are over copy 1's row and a warp a row converts them into both copies.
// A position's float32 sums are the same in both kernels, so are the bits
// of their pooled output.

constexpr int S16_WGS = 4, S16_THREADS = 128 * S16_WGS;   // warpgroups
constexpr int S16_DY = 24;                  // K columns of a dy row
constexpr int S16_KP = 176;                 // 7 x 24 padded to k16 steps
constexpr int S16_KSTEPS = S16_KP / 16;     // 11
constexpr int S16_FLUSH = 2;                // k16 steps a float32 flush
constexpr int S16_GROUPS = (S16_KSTEPS + S16_FLUSH - 1) / S16_FLUSH;   // 6
constexpr int S16_PLANE = S16_KP * ST_C;    // halves of a tap's plane
constexpr int S16_ROW = 168;                // halves of a staged row (56 px)
constexpr int S16_WORDS = S16_ROW / 2;      // 32-bit words of a row
static_assert(S16_DY >= ST_KW * ST_CIN && S16_DY % 8 == 0,
              "a k8 group lies in one dy row");
static_assert(9 * 32 <= 2 * S16_ROW, "a row's planar runs fit its slot");

// The raw (5, 7, 7, 3, 64) weight into the five K-major planes (8 n x 8 k
// core matrices, LBO 1024, SBO 128 bytes): element (n, k) of tap dt at half
// dt * S16_PLANE + (k / 8) * 512 + (n / 8) * 64 + (n % 8) * 8 + k % 8,
// k = 24 dy + 3 dx + c, zero at the padding.
__device__ __forceinline__ void pack_planes_bf16(
    const uint16_t* __restrict__ w, uint16_t* planes) {
  constexpr int KG = S16_KP / 8;
  for (int i = threadIdx.x; i < ST_KT * KG * ST_C; i += S16_THREADS) {
    const int n = i % ST_C, kg = (i / ST_C) % KG, dt = i / (ST_C * KG);
    uint16_t h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = 8 * kg + e, dy = k / S16_DY, r = k - dy * S16_DY;
      h[e] = dy < ST_KH && r < ST_KW * ST_CIN
                 ? __ldg(w + ((size_t)dt * ST_TAPS + dy * ST_KW * ST_CIN +
                              r) * ST_C + n)
                 : (uint16_t)0;
    }
    *reinterpret_cast<uint4*>(planes + dt * S16_PLANE + kg * 8 * ST_C +
                              (n >> 3) * 64 + (n & 7) * 8) =
        make_uint4(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]),
                   pack_bf16(h[4], h[5]), pack_bf16(h[6], h[7]));
  }
}

// Stage n input rows: row fr is frame row at(fr).y of frame at(fr).x, at
// element at(fr).z of the copies. bf16 frames land in copy 0, 168 halves
// from column x0 (cp.async when `async`: 16-byte aligned rows); planar
// bytes as they are, the 9 runs (dw, c) of 32 bytes from w3 = x0 / 3 of
// planar row (t, y / 3), planes (y % 3) * 9 + dw * 3 + c, over copy 1's
// row. Pixels past the clip or the frame are zero.
template <class At>
__device__ __forceinline__ void stage_rows(const Bf16Frames& s, int n, At at,
                                           int t_in, int x0, uint16_t* c0,
                                           uint16_t*, bool async) {
  constexpr int PIECES = S16_ROW / 8;   // 16-byte copies a row
  const int wq = s.W * ST_CIN;
  for (int i = threadIdx.x; i < n * PIECES; i += S16_THREADS) {
    const int fr = i / PIECES, q = (i - fr * PIECES) * 8;
    const int3 r = at(fr);
    const int xq = x0 * ST_CIN + q;
    uint16_t* dst = c0 + r.z + q;
    const uint16_t* src = s.p + ((size_t)r.x * s.H + r.y) * wq + xq;
    const bool row_ok = r.x < t_in && r.y < s.H;
    if (async) {   // wq % 8 == 0: a piece is wholly inside or outside
      const bool ok = row_ok && xq < wq;
      cp_async16b(dst, ok ? src : s.p, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (row_ok && xq + e < wq) ? __ldg(src + e) : (uint16_t)0;
    }
  }
}

template <class At>
__device__ __forceinline__ void stage_rows(const PlanarU8& s, int n, At at,
                                           int t_in, int x0, uint16_t*,
                                           uint16_t* c1, bool async) {
  const int H3 = s.H / 3, W3 = s.W / 3, w30 = x0 / 3;   // x0 % 3 == 0
  for (int i = threadIdx.x; i < n * 9 * 2; i += S16_THREADS) {
    const int half = i & 1, j = (i >> 1) % 9, fr = (i >> 1) / 9;
    const int3 r = at(fr);
    const int h3 = r.y / 3, dh = r.y - 3 * h3;
    const int w3 = w30 + 16 * half;
    uint8_t* dst = reinterpret_cast<uint8_t*>(c1 + r.z) + j * 32 + 16 * half;
    const uint8_t* src =
        s.p + (((size_t)r.x * H3 + h3) * 27 + dh * 9 + j) * W3 + w3;
    const bool row_ok = r.x < t_in && r.y < s.H;
    if (async) {   // W3 % 16 == 0: a piece is wholly inside or outside
      const bool ok = row_ok && w3 < W3;
      cp_async16b(dst, ok ? src : s.p, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (row_ok && w3 + e < W3) ? __ldg(src + e) : (uint8_t)0;
    }
  }
}

// Landed planar bytes of the n rows at(fr).z into both bf16 copies, a warp
// a row: element (x, c) of a row is the byte at run (x % 3) * 3 + c, offset
// x / 3, staged over the row's copy 1, so a warp reads its row's bytes
// before any lane writes copy 1.
template <class At>
__device__ __forceinline__ void convert_rows(int n, At at, uint16_t* c0,
                                             uint16_t* c1) {
  constexpr int K = (S16_WORDS + 31) / 32;   // words a lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int fr = warp; fr < n; fr += S16_THREADS / 32) {
    const int row = at(fr).z;
    const uint8_t* b = reinterpret_cast<const uint8_t*>(c1 + row);
    uint16_t e[K][3];   // elements 2 wd .. 2 wd + 2 of the lane's words
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int el = 2 * (lane + 32 * k) + j, x = el / 3, c = el - 3 * x;
        e[k][j] = el < S16_ROW
                      ? f2bf((float)b[((x % 3) * 3 + c) * 32 + x / 3])
                      : (uint16_t)0;
      }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int wd = lane + 32 * k;
      if (wd >= S16_WORDS) continue;
      reinterpret_cast<uint32_t*>(c0 + row)[wd] = pack_bf16(e[k][0], e[k][1]);
      reinterpret_cast<uint32_t*>(c1 + row)[wd] = pack_bf16(e[k][1], e[k][2]);
    }
  }
}

// Copy 1 of the n rows at(fr).z: copy 0 shifted by one element (zero past
// the row), a warp a row.
template <class At>
__device__ __forceinline__ void shift_rows(int n, At at, const uint16_t* c0,
                                           uint16_t* c1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int fr = warp; fr < n; fr += S16_THREADS / 32) {
    const int row = at(fr).z;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(c0 + row);
    uint32_t* dst = reinterpret_cast<uint32_t*>(c1 + row);
    for (int wd = lane; wd < S16_WORDS; wd += 32) {
      const uint32_t lo = src[wd], hi = wd + 1 < S16_WORDS ? src[wd + 1] : 0u;
      dst[wd] = __funnelshift_r(lo, hi, 16);
    }
  }
}

// k16 steps of flush group G of a tap: from S0, NS of them (the last
// group is short).
template <int G>
struct S16Group {
  static constexpr int S0 = G * S16_FLUSH;
  static constexpr int NS =
      S0 + S16_FLUSH <= S16_KSTEPS ? S16_FLUSH : S16_KSTEPS - S0;
};

// Issue flush group G of a tap (plane `pl`) on a: its steps' products from
// zero into acc.
template <int G>
__device__ __forceinline__ void group_issue(float (&acc)[32],
                                            const uint32_t (&a)[S16_FLUSH][4],
                                            const uint16_t* pl) {
  using B = S16Group<G>;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < B::NS; ++s)
    wgmma_bf16(acc, a[s], wgmma_desc(pl + (B::S0 + s) * 2 * 8 * ST_C,
                                     8 * ST_C * 2, 128),
               s > 0);
  wgmma_commit();
}

// sum += the finished group's products
__device__ __forceinline__ void group_flush(float (&sum)[32],
                                            float (&acc)[32]) {
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    wgmma_pin(acc[e]);
    sum[e] += acc[e];
  }
}

}  // namespace jt

// Host helpers of the stem entries, each source's own (internal linkage).
namespace {

// The blocks of a persistent kernel the card holds at once (its SMs x its
// resident blocks an SM at `threads` and `smem`), the kernel's shared-memory
// limit raised first.
struct Resident {
  cudaError_t err;
  int slots;
};

template <class Kernel>
Resident resident_blocks(Kernel* kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem)) != cudaSuccess ||
      (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return {e, 0};
  if (per_sm < 1) return {cudaErrorInvalidConfiguration, 0};
  return {cudaSuccess, sms * per_sm};
}

// What the compiler and the occupancy calculator say of a kernel of
// `threads` threads with `smem` bytes of dynamic shared memory a block:
// info = {registers a thread, local (spill) bytes a thread, dynamic shared
// bytes a block, blocks an SM}.
int stem_kernel_info(const void* fn, int threads, int smem, int* info) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  return 0;
}

}  // namespace
