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

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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

  // patch offset of the position of each A row this thread holds
  int xoff[ST_MF][2];
#pragma unroll
  for (int i = 0; i < ST_MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = min((warp * ST_MF + i) * 16 + g + 8 * h, ST_NPOS - 1);
      xoff[i][h] = ST_S * (p / ST_CC) * ST_ROW + ST_S * ST_CIN * (p % ST_CC);
    }

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

  // BN + ReLU into the conv tile, over the staging buffers (no copy is in
  // flight: the last tap issued none)
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

// What the compiler and the occupancy calculator say of one entry's
// kernel (planar: 0 float frames, 1 planar): info = {registers a thread,
// local (spill) bytes a thread, dynamic shared bytes a block, blocks an SM}.
extern "C" int jt_stem_pool_info(int planar, int* info) {
  using namespace jt;
  const void* fn = planar ? (const void*)stem_pool_kernel<PlanarU8>
                          : (const void*)stem_pool_kernel<FloatFrames>;
  const int smem = (int)sizeof(float) *
                   (planar ? ST_SMEM_WORDS<PlanarU8>
                           : ST_SMEM_WORDS<FloatFrames>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, ST_THREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  return 0;
}
