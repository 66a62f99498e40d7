// Fused GestSync stem for Hopper (sm_90a), float32 in and out:
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
// (190.2 GFLOP), against 0.24 GB of input frames (0.06 GB planar) and
// 0.13 GB of pooled output (0.1 ms at 3.35 TB/s). The products run on the
// tensor cores in 3xTF32: 3 * 190.2 GFLOP / 495 TFLOP/s = 1.153 ms for float
// frames; the planar entry's pixels are integers, exact in TF32, so its
// products take two passes, 0.769 ms. (On the CUDA cores, the first
// version's FFMA loop, the bound is 2.84 ms at 67 TFLOP/s.) One TF32 pass
// (10 mantissa bits) leaves ~1e-3 of error on such products, ten times the
// port's 1e-4 bar (tests/test_torch_gemm.py); the split passes keep
// float32 accuracy. Two things keep the kernel well above that bound:
// mma.sync appears to issue at about half of the 495 TFLOP/s that the
// card's wgmma path is rated at (time falls about linearly with the passes
// run), and this tile computes 1.31 conv positions for each one the pool
// reads, over 152 of K for 147 (recompute, padding, ragged edges): at
// half rate the passes alone would take ~3.1 ms (float), ~2.1 ms (planar).
//
// Design:
//   * A block computes one frame's tile of 7x8 pooled outputs for all 64
//     channels: a 15x17 tile of 255 conv positions (the pool windows
//     overlap by one conv row/column, so neighbouring tiles recompute one
//     row/column: 13% extra work in exchange for no inter-block traffic).
//   * Implicit GEMM, one temporal tap at a time: M = the 255 positions
//     padded to 256 (the pad row reads the last position and is never
//     stored), N = 64, K = the tap's 7x7x3 = 147 taps in (dy, dx, c) order
//     padded to 152 (19 k8 steps; the pad rows of the weights are zero).
//     The tap's 49x55x3 input patch is staged once (each pixel is read from
//     device memory once a tap, where an im2col would read it ~5 times),
//     and the A fragment of position m, column k reads X[xoff[m] +
//     koff[k]] with koff[k] = dy * 168 + dx * 3 + c from a table in shared
//     memory: no im2col buffer.
//   * Pixels are split into TF32 hi and lo once, as they are staged, into
//     two uint32 planes (a pixel enters the A rows of ~5 positions and each
//     A fragment meets all 8 n8 tiles). The planar form stages one plane:
//     its lo is zero (Src::exact), and `if constexpr` drops that pass. The
//     weights stay raw in shared memory, (152, 64) floats a tap with each
//     row's 8-float groups swizzled so that fragment loads hit 32 banks,
//     and are split as their fragments load (2 values a k8 step an n8
//     tile). Split once into (hi, lo) pairs they doubled the weights' share
//     of shared-memory traffic and ran slower.
//   * 8 warps, each 32 positions x 64 channels (2 x 8 mma tiles), 255
//     registers a thread, one block an SM (two warps on each of its four
//     schedulers); passes small terms first (lo*hi, hi*lo, hi*hi, as
//     gemm.cuh). The tensor cores truncate as they accumulate, so the mma
//     accumulators start from zero every 4 k8 steps (32 columns of K,
//     gemm.cuh's stage depth) and are added to a float32 sum: a chain of
//     at most 12 mma.
//   * Tap dt + 1's raw patch and weights arrive by cp.async (16-byte
//     pieces, zero-filled past the frame; a second weight buffer) while
//     tap dt's products run; only the split of the landed patch into the
//     planes sits between two taps. 177 KB of shared memory (125 KB
//     planar). Rows that are not 16-byte aligned (a frame width not a
//     multiple of 4, planar W/3 not a multiple of 16) take plain loads into
//     the same buffer.
//   * BN scale/bias and ReLU are applied to the sums, the conv tile goes to
//     shared memory over the staging buffers, and the 3x3/2 max pool reads
//     it there and writes the pooled (t, J, W_pool, 64) rows coalesced over
//     channels.
//   * What the passes do not hide (~1.1 ms) is each block's serial part:
//     the split of each tap's patch, the first tap's load and the epilogue,
//     with one block an SM. Two blocks an SM (4 warps of 32 x 64 each, a
//     4x6 pooled tile) and 16 warps of 32 x 32 both ran slower, as did
//     positions ordered so that the A loads hit 32 banks.
//
// jt_stem_pool_bf16 and jt_stem_pool_planar_bf16 are the bf16 variant,
// kernel 1b (the JAX engine's bf16 dtype), a design of its own on Hopper's
// warpgroup products: see its note below.
#include <type_traits>

#include "gemm.cuh"
#include "stem.cuh"

namespace jt {

constexpr int ST_PJ = 7, ST_PI = 8;      // pooled tile (rows, cols)
constexpr int ST_CR = 2 * ST_PJ + 1;     // conv tile rows (15)
constexpr int ST_CC = 2 * ST_PI + 1;     // conv tile cols (17)
constexpr int ST_NPOS = ST_CR * ST_CC;   // 255 conv positions
constexpr int ST_IR = ST_S * (ST_CR - 1) + ST_KH;   // 49 input rows
constexpr int ST_IC = ST_S * (ST_CC - 1) + ST_KW;   // 55 input cols
constexpr int ST_ROW = 168;              // staged row: 55 x 3, padded
constexpr int ST_XS = ST_IR * ST_ROW;    // 8232 words a plane
constexpr int ST_WBUF = ST_KP * ST_C;    // floats of a tap's weights
constexpr int ST_WARPS = 8, ST_THREADS = 32 * ST_WARPS;
constexpr int ST_MF = 2;                 // a warp's m16 tiles
constexpr int ST_CS_LD = ST_C + 1;       // padded conv-tile row
constexpr int ST_RUN = 32;               // bytes staged of a planar run
static_assert(ST_WARPS * ST_MF * 16 >= ST_NPOS, "warps cover the tile");
static_assert(ST_IC * ST_CIN <= ST_ROW, "staged row holds the patch row");
static_assert((ST_IC + 2) / 3 <= ST_RUN, "a planar run holds 19 w3");

// Words of the raw staging buffer of each input form: float frames stage
// the patch rows as they are; planar frames the 9 (dw, c) runs of each
// patch row, 32 bytes each.
template <class Src>
constexpr int ST_RAW_WORDS = Src::exact ? ST_IR * 9 * ST_RUN / 4 : ST_XS;

// Shared memory (words): the split planes, the raw patch, two taps'
// weights, the koff table.
template <class Src>
constexpr int ST_SMEM_WORDS =
    (Src::exact ? 1 : 2) * ST_XS + ST_RAW_WORDS<Src> + 2 * ST_WBUF + ST_KP;
static_assert(ST_NPOS * ST_CS_LD <= ST_XS + ST_IR * 9 * ST_RUN / 4 +
                                        2 * ST_WBUF,
              "the conv tile fits over the staging buffers");

// Issue the copies of frame t's patch from (y0, x0) into the raw buffer:
// cp.async when `async` (16-byte aligned rows), else plain loads. Pixels
// past the frame's edge are zero. Float frames: patch row rr is 168
// floats of frame row y0 + rr from column x0 (the last 3 unused).
__device__ __forceinline__ void issue_patch(const FloatFrames& s, int t,
                                            int y0, int x0, uint32_t* raw,
                                            bool async) {
  constexpr int CH = ST_ROW / 4;         // 16-byte pieces a row
  const int wq = s.W * ST_CIN;
  for (int i = threadIdx.x; i < ST_IR * CH; i += ST_THREADS) {
    const int rr = i / CH, q = (i - rr * CH) * 4;
    const int y = y0 + rr, xq = x0 * ST_CIN + q;
    float* dst = reinterpret_cast<float*>(raw) + rr * ST_ROW + q;
    const float* src = s.p + ((size_t)t * s.H + y) * wq + xq;
    if (async) {   // wq % 4 == 0: a piece is wholly inside or outside
      const bool ok = y < s.H && xq < wq;
      cp_async16(dst, ok ? src : s.p, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = (y < s.H && xq + e < wq) ? __ldg(src + e) : 0.f;
    }
  }
}

// Planar frames: patch row rr (raw row y = y0 + rr) is 9 runs (dw, c) of
// planar row (y / 3, plane (y % 3, dw, c)) along w3 from x0 / 3; 19 bytes
// of each run are used, 32 are staged.
__device__ __forceinline__ void issue_patch(const PlanarU8& s, int t, int y0,
                                            int x0, uint32_t* raw,
                                            bool async) {
  const int H3 = s.H / 3, W3 = s.W / 3, w30 = x0 / 3;   // x0 % 3 == 0
  for (int i = threadIdx.x; i < ST_IR * 9 * 2; i += ST_THREADS) {
    const int half = i & 1, j = (i >> 1) % 9, rr = (i >> 1) / 9;
    const int y = y0 + rr, h3 = y / 3, dh = y - 3 * h3;
    const int w3 = w30 + 16 * half;
    uint8_t* dst = reinterpret_cast<uint8_t*>(raw) + (rr * 9 + j) * ST_RUN +
                   16 * half;
    const uint8_t* src =
        s.p + (((size_t)t * H3 + h3) * 27 + dh * 9 + j) * W3 + w3;
    if (async) {   // W3 % 16 == 0: a piece is wholly inside or outside
      const bool ok = y < s.H && w3 < W3;
      cp_async16(reinterpret_cast<float*>(dst),
                 reinterpret_cast<const float*>(ok ? src : s.p), ok);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (y < s.H && w3 + e < W3) ? __ldg(src + e) : (uint8_t)0;
    }
  }
}

// The landed raw patch into the TF32 planes: float frames split into hi
// and lo; planar bytes become floats, exact in TF32, one plane.
__device__ __forceinline__ void convert_patch(const FloatFrames&,
                                              const uint32_t* raw,
                                              uint32_t* hi, uint32_t* lo) {
  for (int i = threadIdx.x; i < ST_XS / 4; i += ST_THREADS) {
    const float4 v = reinterpret_cast<const float4*>(raw)[i];
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

__device__ __forceinline__ void convert_patch(const PlanarU8&,
                                              const uint32_t* raw,
                                              uint32_t* hi, uint32_t*) {
  constexpr int ROW = ST_IC * ST_CIN;    // 165
  const uint8_t* b = reinterpret_cast<const uint8_t*>(raw);
  for (int i = threadIdx.x; i < ST_IR * ROW; i += ST_THREADS) {
    const int rr = i / ROW, q = i - rr * ROW;
    const int xl = q / 3, c = q - 3 * xl;
    const int w3i = xl / 3, dw = xl - 3 * w3i;
    hi[rr * ST_ROW + q] =
        __float_as_uint((float)b[(rr * 9 + dw * 3 + c) * ST_RUN + w3i]);
  }
}

// A tap's (147, 64) weights into a buffer of (152, 64) floats, row k's
// 8-float groups swizzled by k % 4 (group n / 8 ^ k % 4), so that the B
// fragment loads of a warp (rows t and t + 4, columns g) hit 32 banks.
__device__ __forceinline__ void issue_weights(const float* __restrict__ wt,
                                              float* wb) {
  for (int i = threadIdx.x; i < ST_TAPS * ST_C / 4; i += ST_THREADS) {
    const int k = i / (ST_C / 4), n = (i % (ST_C / 4)) * 4;
    cp_async16(wb + k * ST_C + (n ^ ((k & 3) << 3)), wt + k * ST_C + n, true);
  }
}

// A pooled value into the output.
__device__ __forceinline__ void store_pooled(float* p, float v) { *p = v; }

// The end of a block, after its last tap (no copy in flight): BN + ReLU of
// its float32 sums into the conv tile over the staging buffers, then the
// 3x3 stride-2 max pool of the tile, in float32, into out.
template <class Out>
__device__ __forceinline__ void stem_epilogue(
    const float (&sum)[ST_MF][ST_NF][4], float* smem,
    const float* __restrict__ scale, const float* __restrict__ bias,
    Out* __restrict__ out, int t, int j0, int i0, int J, int Wp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  __syncthreads();
  float* Cs = smem;  // [255][65]
#pragma unroll
  for (int j = 0; j < ST_NF; ++j) {
    const int c = j * 8 + 2 * t4;
    const float s0 = scale[c], s1 = scale[c + 1];
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int i = 0; i < ST_MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (warp * ST_MF + i) * 16 + g + 8 * h;
        if (p < ST_NPOS) {
          Cs[p * ST_CS_LD + c] = fmaxf(fmaf(sum[i][j][2 * h], s0, b0), 0.f);
          Cs[p * ST_CS_LD + c + 1] =
              fmaxf(fmaf(sum[i][j][2 * h + 1], s1, b1), 0.f);
        }
      }
  }
  __syncthreads();

  // one (pooled position, channel) per step
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
    store_pooled(out + (((size_t)t * J + j) * Wp + i) * ST_C + o, v);
  }
}

// The patch offset of the position of each A row a thread holds (rows g
// and g + 8 of its warp's two m16 tiles).
__device__ __forceinline__ void position_offsets(int (&xoff)[ST_MF][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < ST_MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = min((warp * ST_MF + i) * 16 + (lane >> 2) + 8 * h,
                        ST_NPOS - 1);
      xoff[i][h] = ST_S * (p / ST_CC) * ST_ROW + ST_S * ST_CIN * (p % ST_CC);
    }
}

// src: (T4, H, W, 3) frames in either input form (stem.cuh); w: (5, 7, 7,
// 3, 64) DHWIO; out: (T4-4, J, Wp, 64). grid: (ceil(Wp / 8), ceil(J / 7),
// T4 - 4). async: the input rows are 16-byte aligned (issue_patch).
template <class Src>
__global__ void __launch_bounds__(ST_THREADS, 1)
stem_pool_kernel(Src src, const float* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int J, int Wp, bool async) {
  constexpr bool exact = Src::exact;
  constexpr int planes = exact ? 1 : 2;
  extern __shared__ __align__(16) float smem[];
  uint32_t* Xhi = reinterpret_cast<uint32_t*>(smem);   // [49][168]
  uint32_t* Xlo = Xhi + ST_XS;                         // float frames only
  uint32_t* raw = Xhi + planes * ST_XS;
  float* Wb = smem + planes * ST_XS + ST_RAW_WORDS<Src>;   // [2][152][64]
  int* koff = reinterpret_cast<int*>(Wb + 2 * ST_WBUF);      // [152]

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int i0 = blockIdx.x * ST_PI;   // pooled col origin
  const int j0 = blockIdx.y * ST_PJ;   // pooled row origin
  const int t = blockIdx.z;
  const int y_in0 = 2 * ST_S * j0;     // first input row of the patch
  const int x_in0 = 2 * ST_S * i0;     // first input col

  issue_patch(src, t, y_in0, x_in0, raw, async);
  issue_weights(w, Wb);
  cp_async_commit();
  for (int k = tid; k < ST_KP; k += ST_THREADS) {
    const int dy = k / (ST_KW * ST_CIN);
    koff[k] = k < ST_TAPS ? dy * ST_ROW + (k - dy * ST_KW * ST_CIN) : 0;
  }
  for (int i = tid; i < 2 * (ST_KP - ST_TAPS) * ST_C; i += ST_THREADS) {
    const int b = i / ((ST_KP - ST_TAPS) * ST_C);
    Wb[b * ST_WBUF + ST_TAPS * ST_C + i % ((ST_KP - ST_TAPS) * ST_C)] = 0.f;
  }

  int xoff[ST_MF][2];
  position_offsets(xoff);

  float sum[ST_MF][ST_NF][4];
#pragma unroll
  for (int i = 0; i < ST_MF; ++i)
#pragma unroll
    for (int j = 0; j < ST_NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;

  for (int dt = 0; dt < ST_KT; ++dt) {
    cp_async_wait<0>();
    __syncthreads();  // tap dt's patch and weights landed; tap dt-1 done
    convert_patch(src, raw, Xhi, Xlo);
    __syncthreads();  // the planes ready, the raw buffer free
    if (dt + 1 < ST_KT) {   // the next tap's copies fly during this one's
      issue_patch(src, t + dt + 1, y_in0, x_in0, raw, async);
      issue_weights(w + (size_t)(dt + 1) * ST_WS,
                    Wb + ((dt + 1) & 1) * ST_WBUF);
    }
    cp_async_commit();
    const float* wb = Wb + (dt & 1) * ST_WBUF;

#pragma unroll
    for (int s0 = 0; s0 < ST_KSTEPS; s0 += ST_FLUSH) {
      float acc[ST_MF][ST_NF][4];   // the mma accumulators of 32 columns
#pragma unroll
      for (int i = 0; i < ST_MF; ++i)
#pragma unroll
        for (int j = 0; j < ST_NF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
      for (int s = s0; s < min(s0 + ST_FLUSH, ST_KSTEPS); ++s) {
        const int k = 8 * s + t4;
        const int ka = koff[k], kb = koff[k + 4];
        uint32_t ahi[ST_MF][4], alo[ST_MF][4];
#pragma unroll
        for (int i = 0; i < ST_MF; ++i) {
          ahi[i][0] = Xhi[xoff[i][0] + ka];
          ahi[i][1] = Xhi[xoff[i][1] + ka];
          ahi[i][2] = Xhi[xoff[i][0] + kb];
          ahi[i][3] = Xhi[xoff[i][1] + kb];
          if constexpr (!exact) {
            alo[i][0] = Xlo[xoff[i][0] + ka];
            alo[i][1] = Xlo[xoff[i][1] + ka];
            alo[i][2] = Xlo[xoff[i][0] + kb];
            alo[i][3] = Xlo[xoff[i][1] + kb];
          }
        }
        uint32_t bhi[ST_NF][2], blo[ST_NF][2];
#pragma unroll
        for (int j = 0; j < ST_NF; ++j) {
          const int n = ((j ^ t4) << 3) + g;   // the swizzled column
          split_tf32(wb[k * ST_C + n], bhi[j][0], blo[j][0]);
          split_tf32(wb[(k + 4) * ST_C + n], bhi[j][1], blo[j][1]);
        }
        // small terms first, each pass over all tiles
        if constexpr (!exact) {
#pragma unroll
          for (int i = 0; i < ST_MF; ++i)
#pragma unroll
            for (int j = 0; j < ST_NF; ++j)
              mma_tf32(acc[i][j], alo[i], bhi[j]);
        }
#pragma unroll
        for (int i = 0; i < ST_MF; ++i)
#pragma unroll
          for (int j = 0; j < ST_NF; ++j) mma_tf32(acc[i][j], ahi[i], blo[j]);
#pragma unroll
        for (int i = 0; i < ST_MF; ++i)
#pragma unroll
          for (int j = 0; j < ST_NF; ++j) mma_tf32(acc[i][j], ahi[i], bhi[j]);
      }
#pragma unroll
      for (int i = 0; i < ST_MF; ++i)
#pragma unroll
        for (int j = 0; j < ST_NF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[i][j][e] += acc[i][j][e];
    }
  }

  stem_epilogue(sum, smem, scale, bias, out, t, j0, i0, J, Wp);
}

// ---------------------------------------------------------------------------
// Kernel 1b: the bf16 window stem
// ---------------------------------------------------------------------------
//
// stem_pool_bf16_kernel replaces `_stem_kernel` (stem.py:80-213) on bf16
// blocks, reached through stem_mgrid_x and stem_mgrid_planar with the
// JAX package's default impl "window": bf16 frames in [0, 1], or the
// planar bytes with a bf16 weight (/255 folded in float32, then rounded);
// bf16 out. Arithmetic: exact bf16 products summed in float32 (a byte is
// exact in bf16), BN and ReLU in float32, the 3x3/2 max pool, the pooled
// value rounded to bf16 once (stem.py:213); the conv tile is kept in bf16
// for the pool, which gives the same value (rounding is monotone). Its K
// layout, products, flushes and staging are kernel 2b's (stem.cuh), so a
// position's float32 sums, and the pooled bits, equal 2b's.
//
// Bound: operations, 190.2 GFLOP at 989 TFLOP/s dense bf16, 0.192 ms a 5 s
// clip; the window tile puts ~298 GFLOP through the tensor cores (1.31
// conv positions computed for each one the pool reads, K 176 for 147).
// The first bf16 design (the float32 kernel's schedule on mma.sync
// m16n8k16; its times on the H100 are in PERF.md §6, row 1b) gathered
// each A and B register with two 16-bit loads through a koff table,
// launched 10,360 blocks a clip that each landed all five taps' weights
// again (~1 GB of L2 reads), and stopped every block at two barriers
// between taps to convert its patch (bytes one at a time on the planar
// entry). This design:
//  * The window decomposition kept: a unit is a tile of 7x8 pooled outputs
//    of one output frame, all 64 channels; its 15x17 = 255 conv positions
//    (neighbouring tiles recompute a shared conv row or column, as
//    `_stem_kernel` does) and one pad row, which is never stored, are the
//    256 GEMM rows: 4 consumer warpgroups of one m64 tile each (16 warps,
//    512 threads, at most 128 registers). A warp's rows g and g + 8 are
//    two positions, each read through its own window. GEMM row m is conv
//    position (m % 15, m / 15): the 8 rows of one A load are then mostly
//    one column's consecutive rows, whose windows lie in distinct banks
//    (in row order two positions shared a bank in most loads).
//  * A tap's patch, 49 input rows of 168 halves, in bf16 twice (copy 0 as
//    staged, copy 1 shifted by one element, 24 halves further on for the
//    banks), so that a conv column x, whose window starts at element 9x,
//    reads copy 1 when x is odd and every A register is one aligned
//    32-bit load at an offset known when the kernel is compiled plus its
//    window's: no koff table.
//  * Three taps' buffers and one barrier a tap: at tap k's barrier, tap
//    k + 1's rows have landed and tap k's copies are built; tap k + 2's
//    rows are issued (cp.async, or plain loads where a row is not 16-byte
//    aligned), and each warp builds its rows of tap k + 1's copies between
//    tap k's product groups, while the tensor cores run (the patch's
//    shift, or the planar bytes' conversion). Two buffers, with a barrier
//    for the rows and one for the copies between taps, ran slower on float
//    frames.
//  * The five weight planes packed once a block, at its start (110 KB):
//    no weight traffic and no barrier for weights between taps.
//  * Each flush group's A registers are loaded while the group before
//    runs on the tensor cores.
//  * Persistent: one block an SM (grid min(units, SMs)) walks the units
//    (column strip, row tile, frame), frame fastest. The blocks in flight
//    together then take consecutive frames of one tile, so each input
//    frame's patch is read by up to five of them close together, from L2;
//    the next unit's first two taps land while this unit's last taps run.
//  * Epilogue: BN + ReLU into the bf16 conv tile, over the buffer of the
//    unit's last tap (each row's 16-byte channel chunk c at chunk c ^ (row
//    % 8), so that a warp's stores hit distinct banks), then the pool, 8
//    channels a thread in 16-byte loads and stores.
// Shared memory: planes 110 KB, 3 taps x 2 copies x 16.1 KB, scale and bias
// 0.5 KB: 207.3 KB, one block an SM. A ring of all five frames' patches in
// two copies (161 KB) does not fit beside the planes, nor a producer
// warpgroup writing im2col A tiles (256 x 176 bf16, 88 KB a stage). What
// the design leaves: a flush every 2 k16 steps (the arithmetic 2b shares)
// keeps one product group in flight a warpgroup, and the A loads, the
// planes' reads by wgmma and the copies' building share the SM's shared
// memory; the planar entry's conversion reads its bytes with bank
// conflicts (its bytes land in runs of 32).

constexpr int SW_COPY = ST_IR * S16_ROW + 24;   // halves of a patch copy
constexpr int SW_BUF = 2 * SW_COPY;             // a tap's two copies
constexpr int SW_BUFS = 3;                      // taps in shared memory
constexpr int SW_SMEM = 2 * (ST_KT * S16_PLANE + SW_BUFS * SW_BUF) +
                        4 * 2 * ST_C;     // + the folded scale and bias
static_assert(S16_WGS * 64 >= ST_NPOS, "a warpgroup an m64 tile");
static_assert(ST_S * ST_CIN * (ST_CC - 1) + S16_DY <= S16_ROW,
              "a window lies in its staged row");
static_assert(ST_NPOS * ST_C <= SW_BUF, "the conv tile fits a tap buffer");
static_assert(SW_SMEM <= 232448, "fits an SM");

// Flush group G's A registers of a thread's two positions (rows g and
// g + 8 of its warp), whose windows start at x0 and x1 (copy chosen):
// a[s][0] row g, k 2t, 2t + 1 of the step; a[s][1] row g + 8; a[s][2],
// a[s][3] k + 8.
template <int G>
__device__ __forceinline__ void window_load(uint32_t (&a)[S16_FLUSH][4],
                                            const uint16_t* x0,
                                            const uint16_t* x1, int t4) {
  using B = S16Group<G>;
#pragma unroll
  for (int s = 0; s < B::NS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * (B::S0 + s) + h;   // the k8 group
      // group 21 is padding (dy 7, zero weights): it reads row 6
      const int dy = min(q / 3, ST_KH - 1);
      const int j = dy * S16_ROW + 8 * (q % 3) + 2 * t4;
      a[s][2 * h] = *reinterpret_cast<const uint32_t*>(x0 + j);
      a[s][2 * h + 1] = *reinterpret_cast<const uint32_t*>(x1 + j);
    }
}

// Piece i of building a landed tap's two copies (buffer xb): rows
// warp + 16 i, a warp a row (the shift of copy 0 into copy 1, or the
// planar bytes converted into both).
template <class Src>
__device__ __forceinline__ void window_build(int i, uint16_t* xb) {
  const int n = min(S16_THREADS / 32, ST_IR - S16_THREADS / 32 * i);
  const auto row = [=](int r) {
    return make_int3(0, 0, (r + S16_THREADS / 32 * i) * S16_ROW);
  };
  if constexpr (std::is_same<Src, PlanarU8>::value)
    convert_rows(n, row, xb, xb + SW_COPY);
  else
    shift_rows(n, row, xb, xb + SW_COPY);
}

// src: (t_in, H, W, 3) frames, bf16 or planar bytes; w: (5, 7, 7, 3, 64)
// DHWIO bf16; out: (t_in - 4, J, Wp, 64) bf16. A persistent grid over the
// units (strip, row tile, frame), frame fastest.
template <class Src>
__global__ void __launch_bounds__(S16_THREADS, 1)
stem_pool_bf16_kernel(Src src, const uint16_t* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      uint16_t* __restrict__ out, int t_in, int J, int Wp,
                      bool async) {
  extern __shared__ __align__(16) uint16_t smem_sw[];
  uint16_t* planes = smem_sw;                    // [5][22][8][8][8]
  uint16_t* X = planes + ST_KT * S16_PLANE;      // [3 taps][2 copies]
  float* sc = reinterpret_cast<float*>(X + SW_BUFS * SW_BUF);   // [64] x 2
  float* bi = sc + ST_C;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int t_out = t_in - (ST_KT - 1);
  const int strips = (Wp + ST_PI - 1) / ST_PI;
  const int units = strips * ((J + ST_PJ - 1) / ST_PJ) * t_out;

  pack_planes_bf16(w, planes);
  fence_proxy_async();   // the planes, written by threads, read by wgmma
  if (tid < ST_C) {
    sc[tid] = scale[tid];
    bi[tid] = bias[tid];
  }

  // GEMM row m (rows g and g + 8 of this thread's warp) is conv position
  // (m % 15, m / 15): a warp's 8 rows of one A load are mostly 8
  // consecutive rows of one column, whose windows (3 input rows apart)
  // fall in distinct banks. pos: the position (-1: the pad row, which
  // reads position (14, 15)); xo: its window's offset in a tap's buffer,
  // in copy 1 for an odd conv column
  int pos[2], xo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = warp * 16 + g + 8 * h;
    const int r = m < ST_NPOS ? m % ST_CR : ST_CR - 1;
    const int col = m < ST_NPOS ? m / ST_CR : ST_CC - 2;
    pos[h] = m < ST_NPOS ? r * ST_CC + col : -1;
    xo[h] = ST_S * r * S16_ROW + ST_S * ST_CIN * col +
            ((col & 1) ? SW_COPY - 1 : 0);
  }

  // this block's tap k: tap k % 5 of its unit k / 5, in buffer k % 3
  const auto unit_of = [&](int tap) {
    return (int)blockIdx.x + tap / ST_KT * (int)gridDim.x;
  };
  const auto buffer = [&](int tap) { return X + tap % SW_BUFS * SW_BUF; };
  const auto stage = [&](int tap) {   // its 49 input rows, if it exists
    const int u = unit_of(tap);
    if (u >= units) return;
    const int tile = u / t_out, t = u - tile * t_out + tap % ST_KT;
    const int y0 = 2 * ST_S * ST_PJ * (tile / strips);
    uint16_t* xb = buffer(tap);
    stage_rows(src, ST_IR,
               [=](int r) { return make_int3(t, y0 + r, r * S16_ROW); },
               t_in, 2 * ST_S * ST_PI * (tile % strips), xb, xb + SW_COPY,
               async);
  };

  // taps 0 and 1 staged, tap 0's copies built
  stage(0);
  stage(1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) window_build<Src>(i, buffer(0));

  int k = 0;   // the tap at hand
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u / t_out, t = u - tile * t_out;
    const int j0 = ST_PJ * (tile / strips), i0 = ST_PI * (tile % strips);
    float sum[32], acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sum[e] = 0.f;

    for (int dt = 0; dt < ST_KT; ++dt, ++k) {
      __syncthreads();   // tap k's copies built and tap k + 1's rows
                         // landed; tap k - 1 is done with buffer k + 2
      stage(k + 2);
      cp_async_commit();
      const uint16_t* xb = buffer(k);
      uint16_t* nb = unit_of(k + 1) < units ? buffer(k + 1) : nullptr;
      const uint16_t* pl = planes + dt * S16_PLANE;
      const uint16_t* x0 = xb + xo[0];
      const uint16_t* x1 = xb + xo[1];
      uint32_t a0[S16_FLUSH][4], a1[S16_FLUSH][4];
      // each group's A loads, and a piece of tap k + 1's copies, overlap
      // the group before on the tensor cores
      window_load<0>(a0, x0, x1, t4);
      group_issue<0>(acc, a0, pl);
      if (nb) window_build<Src>(0, nb);
      window_load<1>(a1, x0, x1, t4);
      group_flush(sum, acc);
      group_issue<1>(acc, a1, pl);
      if (nb) window_build<Src>(1, nb);
      window_load<2>(a0, x0, x1, t4);
      group_flush(sum, acc);
      group_issue<2>(acc, a0, pl);
      if (nb) window_build<Src>(2, nb);
      window_load<3>(a1, x0, x1, t4);
      group_flush(sum, acc);
      group_issue<3>(acc, a1, pl);
      if (nb) window_build<Src>(3, nb);
      window_load<4>(a0, x0, x1, t4);
      group_flush(sum, acc);
      group_issue<4>(acc, a0, pl);
      window_load<5>(a1, x0, x1, t4);
      group_flush(sum, acc);
      group_issue<5>(acc, a1, pl);
      group_flush(sum, acc);
      cp_async_wait<0>();   // tap k + 2's rows (this thread's copies)
    }

    // BN + ReLU in float32 into the conv tile, over the buffer of the
    // unit's last tap, rounded to bf16 (the pooled max rounds the same:
    // rounding is monotone); row p's 16-byte channel chunk c at chunk
    // c ^ (p % 8); the pad row is not stored
    uint16_t* Cs = buffer(k - 1);
    __syncthreads();   // every warp is done with that buffer
#pragma unroll
    for (int j = 0; j < ST_NF; ++j) {
      const int c = j * 8 + 2 * t4;
      const float s0 = sc[c], s1 = sc[c + 1], b0 = bi[c], b1 = bi[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (pos[h] >= 0)
          *reinterpret_cast<uint32_t*>(
              Cs + pos[h] * ST_C + ((j ^ (pos[h] & 7)) << 3) + 2 * t4) =
              pack_bf16(f2bf(fmaxf(fmaf(sum[4 * j + 2 * h], s0, b0), 0.f)),
                        f2bf(fmaxf(fmaf(sum[4 * j + 2 * h + 1], s1, b1),
                                   0.f)));
    }
    __syncthreads();   // the conv tile written
    // the 3x3 stride-2 max pool, 8 channels a thread; the next tap's
    // barrier keeps the tile until every thread has pooled
    for (int i = tid; i < ST_PJ * ST_PI * (ST_C / 8); i += S16_THREADS) {
      const int cg = i % (ST_C / 8), p = i / (ST_C / 8);
      const int pj = p / ST_PI, pi = p % ST_PI;
      const int jj = j0 + pj, ii = i0 + pi;
      if (jj >= J || ii >= Wp) continue;
      float m[8];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) {
          const int q = (2 * pj + a) * ST_CC + 2 * pi + bb;
          const uint4 v = *reinterpret_cast<const uint4*>(
              Cs + q * ST_C + ((cg ^ (q & 7)) << 3));
          const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float x = bf2f(wd[e / 2] >> (16 * (e % 2)));
            m[e] = a + bb == 0 ? x : fmaxf(m[e], x);
          }
        }
      *reinterpret_cast<uint4*>(
          out + (((size_t)t * J + jj) * Wp + ii) * ST_C + 8 * cg) =
          make_uint4(pack_bf16(f2bf(m[0]), f2bf(m[1])),
                     pack_bf16(f2bf(m[2]), f2bf(m[3])),
                     pack_bf16(f2bf(m[4]), f2bf(m[5])),
                     pack_bf16(f2bf(m[6]), f2bf(m[7])));
    }
  }
}

}  // namespace jt

template <class Src>
static int launch_stem_pool(Src src, const float* w, const float* scale,
                            const float* bias, float* out, int t_in,
                            bool async, cudaStream_t stream) {
  using namespace jt;
  constexpr int smem = (int)sizeof(float) * ST_SMEM_WORDS<Src>;
  const int J = stem_pooled(src.H), Wp = stem_pooled(src.W);
  if (t_in < ST_KT || J < 1 || Wp < 1) return JT_ERR_SHAPE;
  // once per entry, not at every launch (a launcher's static has internal
  // linkage here, so it is this library's own)
  static const cudaError_t attr = cudaFuncSetAttribute(
      stem_pool_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Wp + ST_PI - 1) / ST_PI, (J + ST_PJ - 1) / ST_PJ, t_in - 4);
  stem_pool_kernel<Src><<<grid, ST_THREADS, smem, stream>>>(
      src, w, scale, bias, out, J, Wp, async);
  JT_CHECK_LAUNCH();
  return 0;
}

// frames (t_in, H, W, 3) float32 -> out (t_in - 4, J, Wp, 64), with
// J = ((H - 7) / 3 + 1 - 3) / 2 + 1 and Wp likewise from W.
extern "C" int jt_stem_pool(const float* frames, const float* w,
                            const float* scale, const float* bias, float* out,
                            int t_in, int H, int W, void* stream) {
  const bool async = (uintptr_t)frames % 16 == 0 && W % 4 == 0;
  return launch_stem_pool(jt::FloatFrames{frames, H, W}, w, scale, bias, out,
                          t_in, async, (cudaStream_t)stream);
}

// planar (t_in, H3, 27, W3) uint8 -> out (t_in - 4, J, Wp, 64) for the raw
// frame 3 H3 x 3 W3; w is pre-scaled by 1/255.
extern "C" int jt_stem_pool_planar(const uint8_t* planar, const float* w,
                                   const float* scale, const float* bias,
                                   float* out, int t_in, int H3, int W3,
                                   void* stream) {
  const bool async = (uintptr_t)planar % 16 == 0 && W3 % 16 == 0;
  return launch_stem_pool(jt::PlanarU8{planar, 3 * H3, 3 * W3}, w, scale,
                          bias, out, t_in, async, (cudaStream_t)stream);
}

template <class Src>
static int launch_stem_pool_bf16(Src src, const uint16_t* w,
                                 const float* scale, const float* bias,
                                 uint16_t* out, int t_in, bool async,
                                 cudaStream_t stream) {
  using namespace jt;
  const int J = stem_pooled(src.H), Wp = stem_pooled(src.W);
  if (t_in < ST_KT || J < 1 || Wp < 1) return JT_ERR_SHAPE;
  if ((uintptr_t)out % 16 != 0) return JT_ERR_SHAPE;
  static const Resident setup =
      resident_blocks(stem_pool_bf16_kernel<Src>, S16_THREADS, SW_SMEM);
  if (setup.err != cudaSuccess) return (int)setup.err;
  const int units = (Wp + ST_PI - 1) / ST_PI * ((J + ST_PJ - 1) / ST_PJ) *
                    (t_in - (ST_KT - 1));
  stem_pool_bf16_kernel<Src>
      <<<units < setup.slots ? units : setup.slots, S16_THREADS, SW_SMEM,
         stream>>>(src, w, scale, bias, out, t_in, J, Wp, async);
  JT_CHECK_LAUNCH();
  return 0;
}

// frames (t_in, H, W, 3) bf16 -> out (t_in - 4, J, Wp, 64) bf16; w bf16,
// scale and bias float32.
extern "C" int jt_stem_pool_bf16(const uint16_t* frames, const uint16_t* w,
                                 const float* scale, const float* bias,
                                 uint16_t* out, int t_in, int H, int W,
                                 void* stream) {
  const bool async = (uintptr_t)frames % 16 == 0 && (W * 3) % 8 == 0;
  return launch_stem_pool_bf16(jt::Bf16Frames{frames, H, W}, w, scale, bias,
                               out, t_in, async, (cudaStream_t)stream);
}

// planar (t_in, H3, 27, W3) uint8 -> out (t_in - 4, J, Wp, 64) bf16; w the
// bf16 weight with /255 folded in.
extern "C" int jt_stem_pool_planar_bf16(const uint8_t* planar,
                                        const uint16_t* w, const float* scale,
                                        const float* bias, uint16_t* out,
                                        int t_in, int H3, int W3,
                                        void* stream) {
  const bool async = (uintptr_t)planar % 16 == 0 && W3 % 16 == 0;
  return launch_stem_pool_bf16(jt::PlanarU8{planar, 3 * H3, 3 * W3}, w,
                               scale, bias, out, t_in, async,
                               (cudaStream_t)stream);
}

// What the compiler and the occupancy calculator say of one entry's kernel
// (planar: 0 float frames, 1 planar): info = {registers a thread, local
// (spill) bytes a thread, dynamic shared bytes a block, blocks an SM}.
extern "C" int jt_stem_pool_info(int planar, int* info) {
  using namespace jt;
  return planar ? stem_kernel_info((const void*)stem_pool_kernel<PlanarU8>,
                                   ST_THREADS, 4 * ST_SMEM_WORDS<PlanarU8>,
                                   info)
                : stem_kernel_info((const void*)stem_pool_kernel<FloatFrames>,
                                   ST_THREADS, 4 * ST_SMEM_WORDS<FloatFrames>,
                                   info);
}

// The same of the bf16 variant's entries.
extern "C" int jt_stem_pool_bf16_info(int planar, int* info) {
  using namespace jt;
  return stem_kernel_info(
      planar ? (const void*)stem_pool_bf16_kernel<PlanarU8>
             : (const void*)stem_pool_bf16_kernel<Bf16Frames>,
      S16_THREADS, SW_SMEM, info);
}
