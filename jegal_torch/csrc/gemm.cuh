// Float32 matrix product with a fused epilogue, on Hopper's tensor cores in
// 3xTF32, for the encoder kernels (fused_layer.cu, encoder_stack.cu):
//
//   C[M,N] = LN?( act(A[M,K] @ B[K,N] + bias[N]) + res[M,N] )
//
// All operands row-major and contiguous, 16-byte aligned, K and N multiples
// of 4; bias, res and the row LayerNorm (g, b) are optional. Its mainloop
// (`tc_product`) takes the A rows from a loader, so the block-2 convolution
// (conv2.cu) runs on it with an im2col gather; flash_attention.cu uses its
// 3xTF32 and cp.async helpers.
//
// What bounds it: the encoders' products run at R = 1..2688 rows against
// weights of 0.8-9.4 MB. At the text rows (R = 32..256) the weights are
// read once per call and the product is bound by their bytes; at the
// window head's 2688 rows by its operations. The first version (one
// 128x128 tile, the whole K serial in each block, FFMA) launched 6-24
// blocks at R = 32 and read the weights at under 1 % of the card's rate.
// This design:
//
//  * Row-sized tiles: a (BM, BN) template, BM in {32, 64, 128} (the
//    smallest that covers M), BN in {64, 128}; no work on rows past M
//    beyond one tile's ragged edge. The planner
//    (ops/kernels/gemm_plan.py) picks the pair and the split.
//  * Split-K: when the tiles do not fill the card, blockIdx.z takes one K
//    slice (every slice but the last a whole number of BK steps) and
//    writes its partial tile to the workspace (splits, M, N). A second
//    kernel, one block per row, sums the slices in a fixed order and
//    applies bias, activation, residual and the post-LayerNorm: no
//    atomics, so two runs give identical bits. Unsplit, the epilogue stays
//    in the product kernel, and a LayerNorm (which needs whole rows) runs
//    in the row kernel alone, which is also the encoders' pre-LayerNorm.
//  * A ring of TC_STAGES shared-memory stages of BK = 32, filled by 16-byte
//    cp.async.cg copies, one __syncthreads per stage: while the block
//    computes on one stage the next stages' copies are in flight. A rows
//    are padded to 36 floats and B rows to BN + 8, so every fragment load
//    of a warp hits 32 distinct banks.
//  * 3xTF32 on mma.sync.m16n8k8: each operand is split as hi =
//    to_tf32(x), lo = to_tf32(x - hi) (cvt.rna.tf32's rounding), and
//    lo*hi, hi*lo, hi*hi accumulate (small terms first) into float32.
//    One TF32 pass leaves ~1.5e-3 of error on these products, over the
//    port's 1e-4 bars; three keep float32 accuracy
//    (tests/test_torch_gemm.py). The tensor cores truncate as they
//    accumulate, so one accumulator chained through a K of 2048 (768
//    mma) drifts toward zero by far more than float32 rounding: the
//    window head's FFN came 2.4e-5 off its twin that way. Each stage's
//    products therefore start from zero and are added to a float32 sum
//    (rounded to nearest) when the stage is done: a chain of 12 mma.
//
// Next step: wgmma with TMA-fed operands. TF32 wgmma takes B K-major from
// shared memory, and the weights are (K, N) row-major, so it needs the
// weights stored transposed at load time (or a transposing TMA layout).
//
// The bf16 variant (the JAX engine's bf16 dtype; the `*_bf16` functions at
// the end): A and B bf16 in device and shared memory, one pass of
// mma.sync.m16n8k16 bf16 with float32 accumulators (a product of two bf16
// values is exact in float32: no hi/lo split), the same tiles, split-K,
// ring and per-stage float32 sums. Its stage is BK = 32 bf16 (A rows
// padded to 40 halves, 80 bytes, so that a warp's 32-bit A fragment loads
// hit 32 banks; B rows BN + 8). B's fragments pair two k of one column,
// which the (K, N) row-major stage keeps 2 (BN + 8) bytes apart: each is
// built from two 16-bit loads (ldmatrix.trans would take one; a later
// step). The split-K workspace stays float32; the row epilogue reads
// float32 partials (or float32 / bf16 rows), applies bias, activation,
// residual (float32 or bf16) and the LayerNorm in float32, and writes
// bf16, float32 or both. Bound: the weights' bytes halve, so at the text
// rows the product's bound halves too.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace jt {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;
}

constexpr int TC_BK = 32;       // K depth of a stage
constexpr int TC_STAGES = 4;    // shared-memory ring
constexpr int TC_APAD = 4;      // A rows: BK + 4 floats (bank-conflict free)
constexpr int TC_BPAD = 8;      // B rows: BN + 8 floats
constexpr int ROW_THREADS = 128;

// Warp grid (WM x WN) of each built tile; a warp owns (BM/WM) x (BN/WN).
template <int BM, int BN> struct TileWarps;
template <> struct TileWarps<32, 64> { static constexpr int WM = 1, WN = 4; };
template <> struct TileWarps<32, 128> { static constexpr int WM = 1, WN = 4; };
template <> struct TileWarps<64, 64> { static constexpr int WM = 2, WN = 2; };
template <> struct TileWarps<64, 128> { static constexpr int WM = 2, WN = 4; };
template <> struct TileWarps<128, 64> { static constexpr int WM = 4, WN = 2; };
template <> struct TileWarps<128, 128> { static constexpr int WM = 4, WN = 2; };

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero: add half
// of the 13 dropped bits' range to the magnitude, then clear them), as two
// integer operations: the same bits for every finite x, and cheaper in the
// inner loop than the cvt instruction.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a @ b on one m16n8k8 TF32 tile. Fragments (g = lane >> 2,
// t = lane & 3): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// b0 (k t, n g), b1 (k t+4, n g); c0, c1 (g, 2t), (g, 2t+1); c2, c3
// (g+8, 2t), (g+8, 2t+1). Not volatile: the compiler may interleave
// independent tiles' products to hide the mma latency.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Hopper's warpgroup products (wgmma, sm_90a): four warps together issue
// an asynchronous m64nNk8 TF32 product, A from registers, B from shared
// memory through a matrix descriptor, the sum in registers. A warp's A
// fragment of its 16 rows and its 16 rows of the sum are laid out as
// mma_tf32's (a0..a3; d[4j..4j+3] the c0..c3 of n8 tile j).
//
// Descriptor of a K-major operand without swizzle: core matrices of 8 rows
// x 16 bytes (4 TF32), each 128 contiguous bytes; `lbo` the bytes from one
// core matrix to the next along K, `sbo` along the 8-row groups of N.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((a & 0x3ffffu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (the warpgroup's 64 x 64 float32 tile) = a @ B (+ d when accumulate).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"((int)accumulate));
}

// d = a @ B (+ d) on one warpgroup's 64 x 64 tile in bf16: m64n64k16, A
// (two bf16 a register, mma_bf16's fragment layout) from registers, B
// K-major from shared memory (core matrices 8 n x 8 k, 16 bytes a row; no
// transpose), the sum float32.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"((int)accumulate));
}

// Before a wgmma whose A (or sum) registers other instructions wrote.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of v across a wgmma wait.
__device__ __forceinline__ void wgmma_pin(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// Shared memory written by threads (st.shared, cp.async), made visible to
// the async proxy that wgmma reads B through; before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shape of one built (BM, BN) tile: its warps, each warp's mma tiles,
// its shared-memory stage, and each thread's 16-byte copies a stage.
template <int BM, int BN>
struct Tile {
  static constexpr int WM = TileWarps<BM, BN>::WM, WN = TileWarps<BM, BN>::WN;
  static constexpr int NT = WM * WN * 32;
  static constexpr int MF = BM / WM / 16, NF = BN / WN / 8;   // a warp's mma
  static constexpr int AS = TC_BK + TC_APAD, BS = BN + TC_BPAD;
  static constexpr int A_STAGE = BM * AS, B_STAGE = TC_BK * BS;
  static constexpr int A_COPIES = BM * TC_BK / 4 / NT;
  static constexpr int B_COPIES = TC_BK * BN / 4 / NT;
  static_assert(A_COPIES * NT * 4 == BM * TC_BK, "A stage split evenly");
  static_assert(B_COPIES * NT * 4 == TC_BK * BN, "B stage split evenly");
};

template <int BM, int BN>
constexpr int tile_smem_bytes() {
  return TC_STAGES * (BM * (TC_BK + TC_APAD) + TC_BK * (BN + TC_BPAD)) *
         (int)sizeof(float);
}

// A thread's A copy i of a stage: tile row r and the 4 columns from kc.
template <int BM, int BN>
__device__ __forceinline__ void a_copy_slot(int i, int& r, int& kc) {
  const int c = threadIdx.x + i * Tile<BM, BN>::NT;
  r = c / (TC_BK / 4);
  kc = (c % (TC_BK / 4)) * 4;
}

// The block's (BM, BN) tile of A[:, k_begin:k_end] @ B[k_begin:k_end,
// n0:n0+BN] into sum (the warp's mma fragments), through the cp.async ring
// in `smem` (tile_smem_bytes). load_a(as, i, k0) issues the thread's A copy
// i (a_copy_slot) of the stage at column k0 into `as`: the dense rows of
// gemm_tc_kernel, or the im2col rows that conv2.cu gathers. B is row-major
// (K, N). On return every copy has landed; the ring may be reused after a
// __syncthreads.
template <int BM, int BN, class LoadA>
__device__ __forceinline__ void tc_product(
    float* smem, const LoadA& load_a, const float* __restrict__ B, int N,
    int n0, int k_begin, int k_end,
    float (&sum)[Tile<BM, BN>::MF][Tile<BM, BN>::NF][4]) {
  using TL = Tile<BM, BN>;
  constexpr int WN = TL::WN, NT = TL::NT, MF = TL::MF, NF = TL::NF;
  constexpr int AS = TL::AS, BS = TL::BS;
  constexpr int A_STAGE = TL::A_STAGE, B_STAGE = TL::B_STAGE;
  float* As = smem;                           // [stage][BM][AS]
  float* Bs = smem + TC_STAGES * A_STAGE;     // [stage][BK][BS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WN) * MF * 16, wn0 = (warp % WN) * NF * 8;
  const int nsteps = (k_end - k_begin + TC_BK - 1) / TC_BK;

  auto load_stage = [&](int stage, int step) {
    const int k0 = k_begin + step * TC_BK;
    float* as = As + stage * A_STAGE;
    float* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < TL::A_COPIES; ++i) load_a(as, i, k0);
#pragma unroll
    for (int i = 0; i < TL::B_COPIES; ++i) {
      const int c = tid + i * NT;
      const int r = c / (BN / 4), nc = (c % (BN / 4)) * 4;
      const bool ok = k0 + r < k_end && n0 + nc < N;
      cp_async16(bs + r * BS + nc,
                 ok ? B + (size_t)(k0 + r) * N + n0 + nc : B, ok);
    }
  };

  float acc[MF][NF][4];   // this stage's products (mma accumulators)
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;   // float32 adds

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<TC_STAGES - 2>();   // this thread's copies of `step` done
    __syncthreads();   // everyone's copies visible; step - 1's stage free
    const int next = step + TC_STAGES - 1;
    if (next < nsteps) load_stage(next % TC_STAGES, next);
    cp_async_commit();

    const float* as = As + (step % TC_STAGES) * A_STAGE;
    const float* bs = Bs + (step % TC_STAGES) * B_STAGE;
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 8) {
      uint32_t ahi[MF][4], alo[MF][4], bhi[NF][2], blo[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const float* p = as + (wm0 + i * 16 + g) * AS + kk + t;
        split_tf32(p[0], ahi[i][0], alo[i][0]);
        split_tf32(p[8 * AS], ahi[i][1], alo[i][1]);
        split_tf32(p[4], ahi[i][2], alo[i][2]);
        split_tf32(p[8 * AS + 4], ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const float* q = bs + (kk + t) * BS + wn0 + j * 8 + g;
        split_tf32(q[0], bhi[j][0], blo[j][0]);
        split_tf32(q[4 * BS], bhi[j][1], blo[j][1]);
      }
      // small terms first; each pass over all tiles, so that an
      // accumulator's three products are MF * NF products apart
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], alo[i], bhi[j]);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], ahi[i], blo[j]);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], ahi[i], bhi[j]);
    }
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] += acc[i][j][e];
  }
  cp_async_wait<0>();
}

// grid (ceil(N/BN), ceil(M/BM), splits). Block (n, m, s) computes the
// product of K slice s, [s*per*BK, min(K, (s+1)*per*BK)), for its tile.
// ws == null: the full epilogue, into C. Otherwise: the raw partial tile,
// into ws[s].
template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::NT)
gemm_tc_kernel(const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ bias, const float* __restrict__ res,
               float* __restrict__ C, float* __restrict__ ws, int M, int N,
               int K, int per, int act) {
  using TL = Tile<BM, BN>;
  constexpr int WN = TL::WN, MF = TL::MF, NF = TL::NF, AS = TL::AS;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WN) * MF * 16, wn0 = (warp % WN) * NF * 8;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * per * TC_BK;
  const int k_end = min(K, k_begin + per * TC_BK);

  auto load_a = [&](float* as, int i, int k0) {
    int r, kc;
    a_copy_slot<BM, BN>(i, r, kc);
    const bool ok = m0 + r < M && k0 + kc < k_end;
    cp_async16(as + r * AS + kc, ok ? A + (size_t)(m0 + r) * K + k0 + kc : A,
               ok);
  };
  float sum[MF][NF][4];   // the slice's sum
  tc_product<BM, BN>(smem, load_a, B, N, n0, k_begin, k_end, sum);

  float* dst = ws != nullptr ? ws + (size_t)blockIdx.z * M * N : C;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm0 + i * 16 + g + 8 * h;
        const int c = n0 + wn0 + j * 8 + 2 * t;
        if (r >= M || c >= N) continue;   // N % 4 == 0: c + 1 < N too
        float v0 = sum[i][j][2 * h], v1 = sum[i][j][2 * h + 1];
        if (ws == nullptr) {
          if (bias != nullptr) {
            v0 += bias[c];
            v1 += bias[c + 1];
          }
          v0 = apply_act(v0, act);
          v1 = apply_act(v1, act);
          if (res != nullptr) {
            const float2 q = *reinterpret_cast<const float2*>(
                res + (size_t)r * N + c);
            v0 += q.x;
            v1 += q.y;
          }
        }
        *reinterpret_cast<float2*>(dst + (size_t)r * N + c) =
            make_float2(v0, v1);
      }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < ROW_THREADS / 32; ++w) s += red[w];
  __syncthreads();   // red is reused by the next sum
  return s;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 act4(float4 v, int act) {
  return make_float4(apply_act(v.x, act), apply_act(v.y, act),
                     apply_act(v.z, act), apply_act(v.w, act));
}

// One block per row of C (N / 4 float4 columns). splits > 0: the row is
// the sum of ws[0..splits) in that order, + bias, act, + res (a split
// product's epilogue). splits == 0: the row is x's (which may be C). Then,
// with g, the row LayerNorm (kind 0, torch nn.LayerNorm: biased variance,
// rsqrt(var + 1e-5); kind 1, the reference LayerNorm: Bessel variance,
// 1 / (sqrt(var) + 1e-6)), the one LayerNorm of the encoder kernels, pre
// and post. Each element is read back only by the thread that wrote it.
__global__ void __launch_bounds__(ROW_THREADS)
row_epilogue_kernel(const float* __restrict__ ws, int splits,
                    const float* __restrict__ bias, int act,
                    const float* __restrict__ res,
                    const float* __restrict__ g,
                    const float* __restrict__ b, int kind, const float* x,
                    float* C, int M, int N) {
  __shared__ float red[ROW_THREADS / 32];
  const size_t row = blockIdx.x;
  float* cr = C + row * N;
  const int n4 = N / 4;
  float s = 0.f;
  for (int c4 = threadIdx.x; c4 < n4; c4 += ROW_THREADS) {
    float4 v;
    if (splits > 0) {
      const float4* p = reinterpret_cast<const float4*>(ws + row * N) + c4;
      const size_t slice = (size_t)M * N / 4;   // float4s
      v = p[0];
      int k = 1;
      for (; k + 4 <= splits; k += 4) {   // 4 loads in flight, same order
        const float4 p0 = p[k * slice], p1 = p[(k + 1) * slice],
                     p2 = p[(k + 2) * slice], p3 = p[(k + 3) * slice];
        v = add4(add4(add4(add4(v, p0), p1), p2), p3);
      }
      for (; k < splits; ++k) v = add4(v, p[k * slice]);
      if (bias != nullptr)
        v = add4(v, reinterpret_cast<const float4*>(bias)[c4]);
      v = act4(v, act);
      if (res != nullptr)
        v = add4(v, reinterpret_cast<const float4*>(res + row * N)[c4]);
    } else {
      v = reinterpret_cast<const float4*>(x + row * N)[c4];
    }
    reinterpret_cast<float4*>(cr)[c4] = v;
    s += (v.x + v.y) + (v.z + v.w);
  }
  if (g == nullptr) return;   // uniform across the block
  const float mean = block_sum(s, red) / (float)N;
  float ss = 0.f;
  for (int c4 = threadIdx.x; c4 < n4; c4 += ROW_THREADS) {
    const float4 v = reinterpret_cast<const float4*>(cr)[c4];
    const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean,
                d3 = v.w - mean;
    ss = fmaf(d0, d0, ss);
    ss = fmaf(d1, d1, ss);
    ss = fmaf(d2, d2, ss);
    ss = fmaf(d3, d3, ss);
  }
  ss = block_sum(ss, red);
  const float inv = (kind == 1) ? 1.f / (sqrtf(ss / (float)(N - 1)) + 1e-6f)
                                : rsqrtf(ss / (float)N + 1e-5f);
  for (int c4 = threadIdx.x; c4 < n4; c4 += ROW_THREADS) {
    const float4 v = reinterpret_cast<const float4*>(cr)[c4];
    const float4 gg = reinterpret_cast<const float4*>(g)[c4];
    const float4 bb = reinterpret_cast<const float4*>(b)[c4];
    reinterpret_cast<float4*>(cr)[c4] = make_float4(
        (v.x - mean) * inv * gg.x + bb.x, (v.y - mean) * inv * gg.y + bb.y,
        (v.z - mean) * inv * gg.z + bb.z, (v.w - mean) * inv * gg.w + bb.w);
  }
}

// Internal linkage: a static local of an inline function is one symbol
// across every loaded library (STB_GNU_UNIQUE), so fused_layer's and
// encoder_stack's libraries would share one `attr` and the second would
// never raise its own kernel's shared-memory limit.
namespace {

template <int BM, int BN>
int gemm_launch(const float* A, const float* B, const float* bias,
                const float* res, float* C, float* ws, int M, int N, int K,
                int splits, int per, int act, cudaStream_t s) {
  constexpr int NT = Tile<BM, BN>::NT;
  constexpr int SMEM = tile_smem_bytes<BM, BN>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tc_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_tc_kernel<BM, BN><<<grid, NT, SMEM, s>>>(
      A, B, bias, res, C, splits > 1 ? ws : nullptr, M, N, K, per, act);
  return 0;
}

}  // namespace

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// y = LN(x) row-wise over R rows of d (x may be y); see row_epilogue_kernel.
inline int layer_norm(const float* x, const float* g, const float* b,
                      float* y, int R, int d, int kind, cudaStream_t s) {
  if (R < 1 || d < 4 || d % 4 != 0 || !aligned16(x) || !aligned16(y) ||
      !aligned16(g) || !aligned16(b))
    return JT_ERR_SHAPE;
  row_epilogue_kernel<<<R, ROW_THREADS, 0, s>>>(
      nullptr, 0, nullptr, ACT_NONE, nullptr, g, b, kind, x, y, R, d);
  JT_CHECK_LAUNCH();
  return 0;
}

// C = LN?(act(A @ B + bias) + res) under plan = {BM, BN, splits} (what
// gemm_plan.plan returns). ws: (splits, M, N) floats when splits > 1.
// ln_g null: no LayerNorm. reduce false (with no act, res or LayerNorm): a
// split product's partials stay in ws unreduced, for a reader that sums
// them itself (encoder.cuh's attention core); unsplit, C is as before. A
// plan the code has no instance for, or a slice split that leaves a slice
// empty, returns JT_ERR_SHAPE.
inline int gemm(const int* plan, const float* A, const float* B,
                const float* bias, const float* res, float* C, float* ws,
                int M, int N, int K, int act, const float* ln_g,
                const float* ln_b, int ln_kind, cudaStream_t s,
                bool reduce = true) {
  const int bm = plan[0], bn = plan[1], splits = plan[2];
  const int steps = (K + TC_BK - 1) / TC_BK;
  if (M < 1 || K < 4 || N < 4 || N % 4 != 0 || K % 4 != 0)
    return JT_ERR_SHAPE;
  if (splits < 1 || splits > steps) return JT_ERR_SHAPE;
  const int per = (steps + splits - 1) / splits;
  if ((splits - 1) * per >= steps) return JT_ERR_SHAPE;   // an empty slice
  if (splits > 1 && (ws == nullptr || !aligned16(ws))) return JT_ERR_SHAPE;
  if (!aligned16(A) || !aligned16(B) || !aligned16(C) ||
      (bias != nullptr && !aligned16(bias)) ||
      (res != nullptr && !aligned16(res)) ||
      (ln_g != nullptr && (!aligned16(ln_g) || !aligned16(ln_b))))
    return JT_ERR_SHAPE;
  decltype(&gemm_launch<32, 64>) launch = nullptr;
  if (bm == 32 && bn == 64) launch = gemm_launch<32, 64>;
  if (bm == 32 && bn == 128) launch = gemm_launch<32, 128>;
  if (bm == 64 && bn == 64) launch = gemm_launch<64, 64>;
  if (bm == 64 && bn == 128) launch = gemm_launch<64, 128>;
  if (bm == 128 && bn == 64) launch = gemm_launch<128, 64>;
  if (bm == 128 && bn == 128) launch = gemm_launch<128, 128>;
  if (launch == nullptr) return JT_ERR_SHAPE;
  if (!reduce && (act != ACT_NONE || res != nullptr || ln_g != nullptr))
    return JT_ERR_SHAPE;
  const int rc = launch(A, B, bias, res, C, ws, M, N, K, splits, per, act, s);
  if (rc != 0) return rc;
  JT_CHECK_LAUNCH();
  if (splits > 1 && !reduce) return 0;
  if (splits > 1) {
    row_epilogue_kernel<<<M, ROW_THREADS, 0, s>>>(
        ws, splits, bias, act, res, ln_g, ln_b, ln_kind, nullptr, C, M, N);
    JT_CHECK_LAUNCH();
    return 0;
  }
  return ln_g != nullptr ? layer_norm(C, ln_g, ln_b, C, M, N, ln_kind, s)
                         : 0;
}

// ---------------------------------------------------------------------------
// bf16 (stored as uint16_t bit patterns)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf2f(uint32_t h) {
  return __uint_as_float((h & 0xffffu) << 16);
}

// x rounded to the nearest bf16 (ties to even), as a float
__device__ __forceinline__ float round_bf16(float x) { return bf2f(f2bf(x)); }

// two bf16 in one register, `lo` in the low half (the lower k or column)
__device__ __forceinline__ uint32_t pack_bf16(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ float4 load_bf16x4(const uint16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf2f(u.x), bf2f(u.x >> 16), bf2f(u.y), bf2f(u.y >> 16));
}

__device__ __forceinline__ void store_bf16x4(uint16_t* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(
      pack_bf16(f2bf(v.x), f2bf(v.y)), pack_bf16(f2bf(v.z), f2bf(v.w)));
}

// c += a @ b on one m16n8k16 bf16 tile, float32 accumulators. Fragments
// (g = lane >> 2, t = lane & 3), two bf16 a register, the lower index low:
// a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..);
// b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g); c as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared of any element type, zero-filled when !valid.
__device__ __forceinline__ void cp_async16b(void* smem, const void* gmem,
                                            bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

constexpr int TB_APAD = 8;   // bf16 A rows: BK + 8 halves (80 bytes)
constexpr int TB_BPAD = 8;   // bf16 B rows: BN + 8 halves

// The bf16 stage of a (BM, BN) tile, in halves; copies of 8 halves.
template <int BM, int BN>
struct TileB {
  static constexpr int WN = TileWarps<BM, BN>::WN;
  static constexpr int NT = Tile<BM, BN>::NT, MF = Tile<BM, BN>::MF,
                       NF = Tile<BM, BN>::NF;
  static constexpr int AS = TC_BK + TB_APAD, BS = BN + TB_BPAD;
  static constexpr int A_STAGE = BM * AS, B_STAGE = TC_BK * BS;
  static constexpr int A_COPIES = BM * TC_BK / 8 / NT;
  static constexpr int B_COPIES = TC_BK * BN / 8 / NT;
  static_assert(A_COPIES * NT * 8 == BM * TC_BK, "A stage split evenly");
  static_assert(B_COPIES * NT * 8 == TC_BK * BN, "B stage split evenly");
};

template <int BM, int BN>
constexpr int tile_bf16_smem_bytes() {
  return TC_STAGES * (BM * (TC_BK + TB_APAD) + TC_BK * (BN + TB_BPAD)) * 2;
}

// A thread's bf16 A copy i of a stage: tile row r and the 8 columns from kc.
template <int BM, int BN>
__device__ __forceinline__ void a_copy_slot_bf16(int i, int& r, int& kc) {
  const int c = threadIdx.x + i * TileB<BM, BN>::NT;
  r = c / (TC_BK / 8);
  kc = (c % (TC_BK / 8)) * 8;
}

// tc_product in bf16: the block's (BM, BN) tile of A[:, k_begin:k_end] @
// B[k_begin:k_end, n0:n0+BN] into sum, through the ring in `smem`
// (tile_bf16_smem_bytes). load_a(as, i, k0) issues the thread's A copy i
// (a_copy_slot_bf16) of the stage at column k0 into `as`. K slices are
// multiples of 8. Each stage's two k16 products start from zero and are
// added to the float32 sum.
template <int BM, int BN, class LoadA>
__device__ __forceinline__ void tc_product_bf16(
    uint16_t* smem, const LoadA& load_a, const uint16_t* __restrict__ B,
    int N, int n0, int k_begin, int k_end,
    float (&sum)[TileB<BM, BN>::MF][TileB<BM, BN>::NF][4]) {
  using TL = TileB<BM, BN>;
  constexpr int WN = TL::WN, NT = TL::NT, MF = TL::MF, NF = TL::NF;
  constexpr int AS = TL::AS, BS = TL::BS;
  constexpr int A_STAGE = TL::A_STAGE, B_STAGE = TL::B_STAGE;
  uint16_t* As = smem;
  uint16_t* Bs = smem + TC_STAGES * A_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WN) * MF * 16, wn0 = (warp % WN) * NF * 8;
  const int nsteps = (k_end - k_begin + TC_BK - 1) / TC_BK;

  auto load_stage = [&](int stage, int step) {
    const int k0 = k_begin + step * TC_BK;
    uint16_t* as = As + stage * A_STAGE;
    uint16_t* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < TL::A_COPIES; ++i) load_a(as, i, k0);
#pragma unroll
    for (int i = 0; i < TL::B_COPIES; ++i) {
      const int c = tid + i * NT;
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const bool ok = k0 + r < k_end && n0 + nc < N;
      cp_async16b(bs + r * BS + nc,
                  ok ? B + (size_t)(k0 + r) * N + n0 + nc : B, ok);
    }
  };

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    const int next = step + TC_STAGES - 1;
    if (next < nsteps) load_stage(next % TC_STAGES, next);
    cp_async_commit();

    const uint16_t* as = As + (step % TC_STAGES) * A_STAGE;
    const uint16_t* bs = Bs + (step % TC_STAGES) * B_STAGE;
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t a[MF][4], b[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const uint16_t* p = as + (wm0 + i * 16 + g) * AS + kk + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * AS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * AS + 8);
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const uint16_t* q = bs + (kk + 2 * t) * BS + wn0 + j * 8 + g;
        b[j][0] = pack_bf16(q[0], q[BS]);
        b[j][1] = pack_bf16(q[8 * BS], q[9 * BS]);
      }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] += acc[i][j][e];
  }
  cp_async_wait<0>();
}

// The residual of a bf16 epilogue: float32 or bf16 rows.
struct Rows {
  const void* p;
  bool f32;
  __device__ __forceinline__ float2 load2(size_t i) const {
    if (f32) return *reinterpret_cast<const float2*>(
        static_cast<const float*>(p) + i);
    const uint32_t u =
        *reinterpret_cast<const uint32_t*>(static_cast<const uint16_t*>(p) + i);
    return make_float2(bf2f(u), bf2f(u >> 16));
  }
  __device__ __forceinline__ float4 load4(size_t i) const {
    if (f32) return *reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + i);
    return load_bf16x4(static_cast<const uint16_t*>(p) + i);
  }
};

// gemm_tc_kernel in bf16. ws == null: the full epilogue (bias, act, res),
// into C32 (float32) or Cb (bf16); otherwise the raw float32 partial tile
// into ws[s].
template <int BM, int BN>
__global__ void __launch_bounds__(TileB<BM, BN>::NT)
gemm_bf16_kernel(const uint16_t* __restrict__ A,
                 const uint16_t* __restrict__ B,
                 const float* __restrict__ bias, Rows res,
                 float* __restrict__ C32, uint16_t* __restrict__ Cb,
                 float* __restrict__ ws, int M, int N, int K, int per,
                 int act) {
  using TL = TileB<BM, BN>;
  constexpr int WN = TL::WN, MF = TL::MF, NF = TL::NF, AS = TL::AS;
  extern __shared__ __align__(16) uint16_t smem_b[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WN) * MF * 16, wn0 = (warp % WN) * NF * 8;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * per * TC_BK;
  const int k_end = min(K, k_begin + per * TC_BK);

  auto load_a = [&](uint16_t* as, int i, int k0) {
    int r, kc;
    a_copy_slot_bf16<BM, BN>(i, r, kc);
    const bool ok = m0 + r < M && k0 + kc < k_end;
    cp_async16b(as + r * AS + kc,
                ok ? A + (size_t)(m0 + r) * K + k0 + kc : A, ok);
  };
  float sum[MF][NF][4];
  tc_product_bf16<BM, BN>(smem_b, load_a, B, N, n0, k_begin, k_end, sum);

#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm0 + i * 16 + g + 8 * h;
        const int c = n0 + wn0 + j * 8 + 2 * t;
        if (r >= M || c >= N) continue;
        float v0 = sum[i][j][2 * h], v1 = sum[i][j][2 * h + 1];
        const size_t at = (size_t)r * N + c;
        if (ws != nullptr) {
          *reinterpret_cast<float2*>(ws + (size_t)blockIdx.z * M * N + at) =
              make_float2(v0, v1);
          continue;
        }
        if (bias != nullptr) {
          v0 += bias[c];
          v1 += bias[c + 1];
        }
        v0 = apply_act(v0, act);
        v1 = apply_act(v1, act);
        if (res.p != nullptr) {
          const float2 q = res.load2(at);
          v0 += q.x;
          v1 += q.y;
        }
        if (C32 != nullptr)
          *reinterpret_cast<float2*>(C32 + at) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(Cb + at) =
              pack_bf16(f2bf(v0), f2bf(v1));
      }
}

// row_epilogue_kernel in bf16, one block per row of N / 4 columns, the row
// kept in float32 in shared memory (N floats, dynamic): splits > 0, the
// sum of ws[0..splits) + bias, act, + res; splits == 0, the row of x. Then
// the LayerNorm of kind `kind` in float32 (with g), and the row written to
// C32 (float32) and / or Cb (bf16).
__global__ void __launch_bounds__(ROW_THREADS)
row_epilogue_bf16_kernel(const float* __restrict__ ws, int splits,
                         const float* __restrict__ bias, int act, Rows res,
                         const float* __restrict__ g,
                         const float* __restrict__ b, int kind, Rows x,
                         float* __restrict__ C32, uint16_t* __restrict__ Cb,
                         int M, int N) {
  extern __shared__ __align__(16) float rowv[];
  __shared__ float red[ROW_THREADS / 32];
  const size_t row = blockIdx.x;
  const int n4 = N / 4;
  float s = 0.f;
  for (int c4 = threadIdx.x; c4 < n4; c4 += ROW_THREADS) {
    float4 v;
    if (splits > 0) {
      const float4* p = reinterpret_cast<const float4*>(ws + row * N) + c4;
      const size_t slice = (size_t)M * N / 4;
      v = p[0];
      for (int k = 1; k < splits; ++k) v = add4(v, p[k * slice]);
      if (bias != nullptr)
        v = add4(v, reinterpret_cast<const float4*>(bias)[c4]);
      v = act4(v, act);
      if (res.p != nullptr) v = add4(v, res.load4(row * N + 4 * c4));
    } else {
      v = x.load4(row * N + 4 * c4);
    }
    reinterpret_cast<float4*>(rowv)[c4] = v;
    s += (v.x + v.y) + (v.z + v.w);
  }
  float mean = 0.f, inv = 0.f;
  if (g != nullptr) {   // uniform across the block
    mean = block_sum(s, red) / (float)N;
    float ss = 0.f;
    for (int c4 = threadIdx.x; c4 < n4; c4 += ROW_THREADS) {
      const float4 v = reinterpret_cast<const float4*>(rowv)[c4];
      const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean,
                  d3 = v.w - mean;
      ss = fmaf(d0, d0, ss);
      ss = fmaf(d1, d1, ss);
      ss = fmaf(d2, d2, ss);
      ss = fmaf(d3, d3, ss);
    }
    ss = block_sum(ss, red);
    inv = (kind == 1) ? 1.f / (sqrtf(ss / (float)(N - 1)) + 1e-6f)
                      : rsqrtf(ss / (float)N + 1e-5f);
  }
  for (int c4 = threadIdx.x; c4 < n4; c4 += ROW_THREADS) {
    float4 v = reinterpret_cast<const float4*>(rowv)[c4];
    if (g != nullptr) {
      const float4 gg = reinterpret_cast<const float4*>(g)[c4];
      const float4 bb = reinterpret_cast<const float4*>(b)[c4];
      v = make_float4((v.x - mean) * inv * gg.x + bb.x,
                      (v.y - mean) * inv * gg.y + bb.y,
                      (v.z - mean) * inv * gg.z + bb.z,
                      (v.w - mean) * inv * gg.w + bb.w);
    }
    if (C32 != nullptr) reinterpret_cast<float4*>(C32 + row * N)[c4] = v;
    if (Cb != nullptr) store_bf16x4(Cb + row * N + 4 * c4, v);
  }
}

namespace {

template <int BM, int BN>
int gemm_bf16_launch(const uint16_t* A, const uint16_t* B, const float* bias,
                     Rows res, float* C32, uint16_t* Cb, float* ws, int M,
                     int N, int K, int splits, int per, int act,
                     cudaStream_t s) {
  constexpr int NT = TileB<BM, BN>::NT;
  constexpr int SMEM = tile_bf16_smem_bytes<BM, BN>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_bf16_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_bf16_kernel<BM, BN><<<grid, NT, SMEM, s>>>(A, B, bias, res, C32, Cb,
                                                  ws, M, N, K, per, act);
  return 0;
}

}  // namespace

inline bool aligned8(const void* p) { return ((uintptr_t)p & 7) == 0; }

// The row pass of the bf16 GEMM: rows of ws (splits > 0) or of x, to C32
// and / or Cb, with the LayerNorm when g is given.
inline int row_pass_bf16(const float* ws, int splits, const float* bias,
                         int act, Rows res, const float* g, const float* b,
                         int kind, Rows x, float* C32, uint16_t* Cb, int M,
                         int N, cudaStream_t s) {
  if (M < 1 || N < 4 || N % 4 != 0 || (g != nullptr && N < 2))
    return JT_ERR_SHAPE;
  if ((C32 == nullptr && Cb == nullptr) ||
      (C32 != nullptr && !aligned16(C32)) || (Cb != nullptr && !aligned8(Cb)))
    return JT_ERR_SHAPE;
  const size_t smem = (size_t)N * sizeof(float);
  if (smem > 48 * 1024) return JT_ERR_SHAPE;
  row_epilogue_bf16_kernel<<<M, ROW_THREADS, smem, s>>>(
      ws, splits, bias, act, res, g, b, kind, x, C32, Cb, M, N);
  JT_CHECK_LAUNCH();
  return 0;
}

// y (bf16 and / or float32) = LN(x) row-wise, x float32 or bf16 rows; with
// g null, a copy (the dtype conversion of the stack's input).
inline int layer_norm_bf16(Rows x, const float* g, const float* b,
                           float* y32, uint16_t* yb, int R, int d, int kind,
                           cudaStream_t s) {
  if (x.p == nullptr || (x.f32 ? !aligned16(x.p) : !aligned8(x.p)) ||
      (g != nullptr && (!aligned16(g) || !aligned16(b))))
    return JT_ERR_SHAPE;
  return row_pass_bf16(nullptr, 0, nullptr, ACT_NONE, Rows{nullptr, false}, g,
                       b, kind, x, y32, yb, R, d, s);
}

// gemm in bf16: C = LN?(act(A @ B + bias) + res), A (M, K) and B (K, N)
// bf16, bias and the LayerNorm float32, res float32 or bf16 rows (res.p
// null: none), into C32 (float32) and / or Cb (bf16). K and N multiples of
// 8. The product kernel's own epilogue writes one output when the product
// is unsplit and has no LayerNorm; otherwise its float32 partials go to ws
// ((splits, M, N), or (M, N) unsplit) and the row pass finishes them, so
// that the LayerNorm and the bf16 rounding see float32 sums. reduce false
// (no act, res or LayerNorm, one float32 output): a split product's
// partials stay in ws for the attention core, as `gemm`'s.
inline int gemm_bf16(const int* plan, const uint16_t* A, const uint16_t* B,
                     const float* bias, Rows res, float* C32, uint16_t* Cb,
                     float* ws, int M, int N, int K, int act,
                     const float* ln_g, const float* ln_b, int ln_kind,
                     cudaStream_t s, bool reduce = true) {
  const int bm = plan[0], bn = plan[1], splits = plan[2];
  const int steps = (K + TC_BK - 1) / TC_BK;
  if (M < 1 || K < 8 || N < 8 || N % 8 != 0 || K % 8 != 0)
    return JT_ERR_SHAPE;
  if (splits < 1 || splits > steps) return JT_ERR_SHAPE;
  const int per = (steps + splits - 1) / splits;
  if ((splits - 1) * per >= steps) return JT_ERR_SHAPE;
  if (!aligned16(A) || !aligned16(B) ||
      (bias != nullptr && !aligned16(bias)) ||
      (res.p != nullptr && (res.f32 ? !aligned16(res.p) : !aligned8(res.p))) ||
      (ln_g != nullptr && (!aligned16(ln_g) || !aligned16(ln_b))) ||
      (C32 != nullptr && !aligned16(C32)) || (Cb != nullptr && !aligned8(Cb)))
    return JT_ERR_SHAPE;
  if (C32 == nullptr && Cb == nullptr) return JT_ERR_SHAPE;
  if (!reduce && (act != ACT_NONE || res.p != nullptr || ln_g != nullptr ||
                  C32 == nullptr || Cb != nullptr))
    return JT_ERR_SHAPE;
  const bool row = splits > 1 || ln_g != nullptr ||
                   (C32 != nullptr && Cb != nullptr);
  if (row && (ws == nullptr || !aligned16(ws))) return JT_ERR_SHAPE;
  decltype(&gemm_bf16_launch<32, 64>) launch = nullptr;
  if (bm == 32 && bn == 64) launch = gemm_bf16_launch<32, 64>;
  if (bm == 32 && bn == 128) launch = gemm_bf16_launch<32, 128>;
  if (bm == 64 && bn == 64) launch = gemm_bf16_launch<64, 64>;
  if (bm == 64 && bn == 128) launch = gemm_bf16_launch<64, 128>;
  if (bm == 128 && bn == 64) launch = gemm_bf16_launch<128, 64>;
  if (bm == 128 && bn == 128) launch = gemm_bf16_launch<128, 128>;
  if (launch == nullptr) return JT_ERR_SHAPE;
  const int rc = launch(A, B, bias, res, C32, Cb, row ? ws : nullptr, M, N,
                        K, splits, per, act, s);
  if (rc != 0) return rc;
  JT_CHECK_LAUNCH();
  if (!row || (splits > 1 && !reduce)) return 0;
  return row_pass_bf16(ws, splits, bias, act, res, ln_g, ln_b, ln_kind,
                       Rows{nullptr, false}, C32, Cb, M, N, s);
}

}  // namespace jt
