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
// Next step for the float32 product: wgmma with TMA-fed operands. TF32
// wgmma takes B K-major from shared memory, and the weights are (K, N)
// row-major, so it needs the weights stored transposed at load time (or a
// transposing TMA layout).
//
// The bf16 variant (the JAX engine's bf16 dtype; `gemm_bf16` at the end) is
// a Hopper design of its own, on wgmma:
//
//  * Mainloop: wgmma.mma_async m64nBNk16 bf16 with float32 accumulators, A
//    and B both from shared memory through matrix descriptors in the
//    128-byte swizzle. A (rows, K-major) takes it as it is; B, the (K, N)
//    row-major weight, is MN-major, which wgmma reads for 16-bit types
//    through its transpose-B immediate: the weights need no transposed
//    copy. One consumer warpgroup a 64-row slab: tiles (BM, BN) of {64,
//    128} x {64, 128}, 32 or 64 float32 sums a thread.
//  * Stages: 64 bf16 of K a stage (a 128-byte row, the swizzle's width),
//    loaded by TMA (cuTensorMapEncodeTiled through the runtime's driver
//    entry point, no -lcuda; a tensor map for A and for B a call), which
//    zero-fills ragged rows, columns and the K tail. A producer warp's one
//    thread keeps a ring of stages full (full / empty mbarriers); each
//    consumer warpgroup releases a stage once its next stage's products
//    are issued, so the tensor cores see one stage's products while the
//    next is issued. TMA rather than cp.async: the consumers spend no
//    instructions or registers on copies, and a stage needs no
//    proxy fence.
//  * Persistent: at most one block an SM (two of a BM 64 tile, which takes
//    half an SM's shared memory) walks the product's units (a tile and a K
//    slice) in turn, so the producer loads the next unit while the
//    consumers run the epilogue.
//  * Accumulation: one float32 chain through the whole K slice. The
//    tensor cores' truncating adds cost a few float32 ulps over K 3072,
//    far inside the bf16 bars (2 bf16 ulps = 2^-6 relative); the per-stage
//    float32 sum of the 3xTF32 ring is not needed.
//  * Split-K reduced in the product kernel: each slice writes its float32
//    partial to the workspace and counts itself on a per-tile counter; the
//    last slice to arrive (atomicAdd, then __threadfence) sums the slices
//    in their fixed order, 0, 1, ..., and runs the epilogue, so two
//    launches give identical bits with no atomics on the data, and a split
//    product is one launch. The counters start at zero (the entry's one
//    memset) and the last slice puts each back to zero.
//  * Epilogue: the sums go through a float32 slab in shared memory, so that
//    each thread then handles 4 columns of whole rows (16-byte loads and
//    stores along the rows): bias, ReLU or exact GELU, a float32 or bf16
//    residual, the scale of the first `scale_cols` columns (the QKV
//    product's q * scale), a float32 and / or bf16 output; the bias and
//    LayerNorm vectors float32 or bf16. A LayerNorm needs whole rows: the
//    product's float32 rows wait in the workspace and the row pass
//    (row_norm_bf16_kernel) normalizes them.
//  * Plans: ops/kernels/gemm_plan.plan_bf16 (tiles over the blocks, K split
//    at small R into slices of about 16 steps).
//
// Bound: at the window head's 2688 rows the operations (989 TFLOP/s); at
// the text and gesture rows (32, 128) the weights' bytes, read once, and
// the latency of a launch and its units. On the H100 (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md §6) the window head's products ran at 15-30 %
// of their bound, the small ones at 3-20 %. Block 2's bf16 kernel
// (conv2.cu) runs the same wgmma, descriptors, mbarriers and
// bf16_tensor_map with its own gathering producer.
#pragma once

#include <cuda.h>           // CUtensorMap (the bf16 product's TMA)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
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

// The four 8x8 b16 matrices at the rows lanes 8i..8i+7 point to: lane (g,
// t) receives row g, columns 2t, 2t + 1 of matrix i in r[i] (an mma_bf16 B
// fragment of an (n, k) row-major operand, or an A fragment).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint16_t* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The same, each matrix transposed: lane (g, t) receives rows 2t, 2t + 1
// of column g of matrix i in r[i] (an mma_bf16 B fragment of a row-major
// (k, n) operand).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const uint16_t* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes global -> shared of any element type, zero-filled when !valid.
__device__ __forceinline__ void cp_async16b(void* smem, const void* gmem,
                                            bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// Float32 or bf16 values (a bf16 epilogue's residual rows, its bias, a
// LayerNorm's scale and shift), read as float32; at(i) the values from
// element i on.
struct Rows {
  const void* p;
  bool f32;
  Rows at(size_t i) const {
    if (p == nullptr) return *this;
    return Rows{f32 ? (const void*)(static_cast<const float*>(p) + i)
                    : (const void*)(static_cast<const uint16_t*>(p) + i),
                f32};
  }
  bool aligned() const {   // for load4
    return ((uintptr_t)p & (f32 ? 15 : 7)) == 0;
  }
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

// y (bf16 and / or float32) = LN(x) row-wise: one block per row of N / 4
// columns, x float32 or bf16 rows, the row kept in float32 in shared
// memory (N floats, dynamic); the LayerNorm of kind `kind` in float32 with
// g (g and b float32 or bf16), a copy (a dtype conversion) without; the
// row written to C32 and / or Cb.
__global__ void __launch_bounds__(ROW_THREADS)
row_norm_bf16_kernel(Rows g, Rows b, int kind, Rows x,
                     float* __restrict__ C32, uint16_t* __restrict__ Cb,
                     int N) {
  extern __shared__ __align__(16) float rowv[];
  __shared__ float red[ROW_THREADS / 32];
  const size_t row = blockIdx.x;
  const int n4 = N / 4;
  float s = 0.f;
  for (int c4 = threadIdx.x; c4 < n4; c4 += ROW_THREADS) {
    const float4 v = x.load4(row * N + 4 * c4);
    reinterpret_cast<float4*>(rowv)[c4] = v;
    s += (v.x + v.y) + (v.z + v.w);
  }
  float mean = 0.f, inv = 0.f;
  if (g.p != nullptr) {   // uniform across the block
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
    if (g.p != nullptr) {
      const float4 gg = g.load4(4 * c4), bb = b.load4(4 * c4);
      v = make_float4((v.x - mean) * inv * gg.x + bb.x,
                      (v.y - mean) * inv * gg.y + bb.y,
                      (v.z - mean) * inv * gg.z + bb.z,
                      (v.w - mean) * inv * gg.w + bb.w);
    }
    if (C32 != nullptr) reinterpret_cast<float4*>(C32 + row * N)[c4] = v;
    if (Cb != nullptr) store_bf16x4(Cb + row * N + 4 * c4, v);
  }
}

inline bool aligned8(const void* p) { return ((uintptr_t)p & 7) == 0; }

// y (bf16 and / or float32) = LN(x) row-wise over R rows of d, x float32 or
// bf16 rows; with g.p null, a copy (the dtype conversion of the stack's
// input).
inline int layer_norm_bf16(Rows x, Rows g, Rows b, float* y32, uint16_t* yb,
                           int R, int d, int kind, cudaStream_t s) {
  if (R < 1 || d < 4 || d % 4 != 0 || x.p == nullptr || !x.aligned() ||
      (g.p != nullptr && (!g.aligned() || b.p == nullptr || !b.aligned())))
    return JT_ERR_SHAPE;
  if ((y32 == nullptr && yb == nullptr) ||
      (y32 != nullptr && !aligned16(y32)) || (yb != nullptr && !aligned8(yb)))
    return JT_ERR_SHAPE;
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) return JT_ERR_SHAPE;
  row_norm_bf16_kernel<<<R, ROW_THREADS, smem, s>>>(g, b, kind, x, y32, yb,
                                                     d);
  JT_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------------------
// The bf16 product on wgmma (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int WG_BK = 64;        // K depth of a stage: one 128-byte row
constexpr int WG_ROW = 128;      // bytes of a stage row
constexpr int WG_NBLK = WG_BK * WG_ROW;   // bytes of B's 64-column block
constexpr int WG_SPAD = 8;       // a slab row: BN + 8 floats

// The shape of one built (BM, BN) tile: BM / 64 consumer warpgroups (warps
// 0.. 4 WGS - 1), each an m64 x BN slab, and one producer warp after them;
// per stage A (BM rows of 128 bytes, 8-row atoms of 1024 bytes) and B (BN
// / 64 blocks of 64 k rows of 128 bytes); each warpgroup's float32 slab
// for the epilogue; as many stages as fit beside them in the block's share
// of the SM (at most 8), their full / empty barriers, and 1024 bytes to
// align the ring to the swizzle's atom. A one-warpgroup block takes half
// an SM, so that two run on each: one's epilogue then overlaps the other's
// products.
template <int BM, int BN>
struct WgTile {
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN == 64 || BN == 128, "m64n64 or m64n128");
  static constexpr int WGS = BM / 64;
  static constexpr int WG_SMEM = (WGS == 1 ? 108 : 200) * 1024;
  static constexpr int NT = 128 * WGS + 32;
  static constexpr int A_STAGE = BM * WG_ROW;
  static constexpr int B_STAGE = (BN / 64) * WG_NBLK;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int SS = BN + WG_SPAD;             // slab row (floats)
  static constexpr int SLABS = WGS * 64 * SS * 4;     // bytes
  static constexpr int FIT = (WG_SMEM - SLABS) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = STAGES * STAGE + SLABS + 2 * STAGES * 8 + 16 +
                              1024;
  static constexpr int NACC = BN / 2;     // float32 sums a thread
  static constexpr int CPT = BN / 8;      // a thread's float4s of a slab
  static_assert(STAGES >= 3, "a ring of three stages at least");
};

// Descriptor of an operand in the 128-byte swizzle (layout type 1): `lbo`
// the bytes between 64-element blocks along M or N of an MN-major operand
// (unused K-major), `sbo` between 8-row (K-major) or 8-k (MN-major) atoms.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* smem,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  return wgmma_desc(smem, lbo, sbo) | (1ull << 62);
}

// d (a warpgroup's 64 x N float32 tile) = A @ B (+ d when accumulate): bf16
// m64nNk16, A K-major and B MN-major (transpose-B 1), both from shared
// memory in the 128-byte swizzle. d[4j..4j+3] are mma_bf16's c0..c3 of n8
// tile j for the warp's 16 rows.
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[32], uint64_t a_desc,
                                              uint64_t b_desc,
                                              bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"((int)accumulate));
}

__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[64], uint64_t a_desc,
                                              uint64_t b_desc,
                                              bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"((int)accumulate));
}

// d (a warpgroup's 64 x 64 float32 tile) = A @ B (+ d when accumulate):
// bf16 m64n64k16 with A from registers (a warp's 16 rows as mma_bf16's A
// fragment) and B from shared memory in the 128-byte swizzle, K-major (TB
// 0) or MN-major (TB 1). d as wgmma_ss_bf16's.
template <int TB>
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b_desc,
                                              bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "n"(TB),
        "r"((int)accumulate));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// mbarriers (shared memory, 8 bytes): `count` arrivals a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival, and `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed (a barrier's first
// wait on parity 1 returns at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box of `map` at (c0 inner, c1 outer) -> dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The 128 threads of a consumer warpgroup (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The epilogue of a bf16 product: v = act(sum + bias) + res, times `scale`
// on the columns below `scale_cols`, written to c32 (float32) and / or cb
// (bf16), each of (M, N) rows; the bias (N,) float32 or bf16.
struct Epi {
  Rows bias;
  int act;
  Rows res;
  float scale;
  int scale_cols;
  float* c32;
  uint16_t* cb;
};

// A persistent grid of at most one block an SM (two of one warpgroup)
// over the product's units, unit u = (tile u / splits, K slice u %
// splits), tile t = (row block t / tiles_n, column block t % tiles_n);
// block b takes units b, b + gridDim.x, ... The producer warp's lane 0 walks the block's units' 64-deep steps
// ahead through the ring: it waits for a stage's `empty` barrier, then TMA
// loads A's and B's boxes (OOB zero-filled) onto its `full` barrier. Each
// consumer warpgroup waits for `full`, issues the stage's four wgmma on
// its 64 rows, and releases the stage before (`empty`) once the products
// of this one are issued and those of that one done, so that one stage's
// products run while the next is issued. After a unit's last step the
// warpgroup moves its sums into its slab in shared memory and runs the
// epilogue from there, 16 bytes a thread along the rows, while the
// producer loads the next unit. Split, it first writes the slab to
// ws[slice] ((splits, M, N) floats) and counts it on cnt[tile * WGS + wg];
// the last slice to arrive sums ws[0..splits) in that order.
template <int BM, int BN>
__global__ void __launch_bounds__(WgTile<BM, BN>::NT, 1)
gemm_wg_kernel(const __grid_constant__ CUtensorMap tm_a,
               const __grid_constant__ CUtensorMap tm_b, Epi epi,
               float* __restrict__ ws, int* __restrict__ cnt, int M, int N,
               int K, int per, int splits) {
  using TL = WgTile<BM, BN>;
  constexpr int WGS = TL::WGS, S = TL::STAGES, NF = BN / 8, SS = TL::SS;
  constexpr int C4 = BN / 4;   // float4s of a slab row
  extern __shared__ uint8_t wg_smem[];
  uint8_t* smem = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  float* slabs = reinterpret_cast<float*>(smem + S * TL::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * TL::STAGE +
                                               TL::SLABS);
  uint64_t* empty = full + S;
  int* last = reinterpret_cast<int*>(empty + S);   // a flag a warpgroup

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (N + BN - 1) / BN;
  const int units = tiles_n * ((M + BM - 1) / BM) * splits;
  const int steps = (K + WG_BK - 1) / WG_BK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * WGS);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WGS) {   // the producer warp
    if (lane != 0) return;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int tile = u / splits, slice = u % splits;
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      const int s1 = min(steps, (slice + 1) * per);
      for (int st = slice * per; st < s1; ++st, ++it) {
        const int stage = it % S;
        mbar_wait(empty + stage, ((it / S) & 1) ^ 1);
        mbar_expect_tx(full + stage, TL::STAGE);
        uint8_t* as = smem + stage * TL::STAGE;
        tma_load(as, &tm_a, full + stage, st * WG_BK, m0);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load(as + TL::A_STAGE + b * WG_NBLK, &tm_b, full + stage,
                   n0 + 64 * b, st * WG_BK);
      }
    }
    return;
  }

  const int wg = warp >> 2, wt = tid & 127;
  float* slab = slabs + wg * 64 * SS;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u / splits, slice = u % splits;
    const int m0 = (tile / tiles_n) * BM + wg * 64, n0 = (tile % tiles_n) * BN;
    const int s1 = min(steps, (slice + 1) * per);
    float acc[TL::NACC];
#pragma unroll
    for (int e = 0; e < TL::NACC; ++e) acc[e] = 0.f;
    int prev = -1;
    for (int st = slice * per; st < s1; ++st, ++it) {
      const int stage = it % S;
      mbar_wait(full + stage, (it / S) & 1);
      const uint8_t* as = smem + stage * TL::STAGE;
      const uint64_t da = wgmma_desc_sw128(as + wg * 64 * WG_ROW, 0, 1024);
      const uint64_t db = wgmma_desc_sw128(as + TL::A_STAGE, WG_NBLK, 1024);
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
    for (int e = 0; e < TL::NACC; ++e) wgmma_pin(acc[e]);

    // the sums into the slab: element e of n8 tile j, half h is slab row
    // 16 (warp % 4) + g + 8 h, column 8 j + 2 t + e
    {
      const int r = (warp & 3) * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(slab + (r + 8 * h) * SS + 8 * j + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    wg_sync(wg);
    // a thread's float4 k of the slab: row (wt + 128 k) / C4, its columns
    // from 4 ((wt + 128 k) % C4)
    const int rows = min(64, M - m0), cols = min(BN, N - n0);
    if (splits > 1) {
#pragma unroll
      for (int k = 0; k < TL::CPT; ++k) {
        const int i = wt + 128 * k, r = i / C4, c = 4 * (i % C4);
        if (r < rows && c < cols)
          __stcg(reinterpret_cast<float4*>(ws + (size_t)slice * M * N +
                                           (size_t)(m0 + r) * N + n0 + c),
                 *reinterpret_cast<const float4*>(slab + r * SS + c));
      }
      __threadfence();
      wg_sync(wg);
      if (wt == 0) {
        int* count = cnt + tile * WGS + wg;
        last[wg] = atomicAdd(count, 1) == splits - 1;
        if (last[wg]) *count = 0;   // every slice has counted: ready again
      }
      wg_sync(wg);
      if (!last[wg]) continue;
      __threadfence();
      // slice by slice, each thread's loads of a slice in flight at once
      for (int q = 0; q < splits; ++q) {
        float4 p[TL::CPT];
#pragma unroll
        for (int k = 0; k < TL::CPT; ++k) {
          const int i = wt + 128 * k, r = i / C4, c = 4 * (i % C4);
          p[k] = r < rows && c < cols
                     ? __ldcg(reinterpret_cast<const float4*>(
                           ws + (size_t)q * M * N + (size_t)(m0 + r) * N +
                           n0 + c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < TL::CPT; ++k) {
          const int i = wt + 128 * k, r = i / C4, c = 4 * (i % C4);
          float4* v = reinterpret_cast<float4*>(slab + r * SS + c);
          *v = q == 0 ? p[k] : add4(*v, p[k]);
        }
      }
    }

    // the epilogue, 4 columns a thread at a time along the rows: a thread
    // keeps its columns (4 (wt % C4)) in every row it takes (wt / C4 +
    // (128 / C4) k), so its bias is loaded once, and all its residual
    // loads are in flight at once
    const int c = 4 * (wt % C4), col = n0 + c;
    if (c < cols) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 bias =
          epi.bias.p != nullptr ? epi.bias.load4(col) : zero;
      const bool scaled = col < epi.scale_cols;
      float4 res[TL::CPT];
#pragma unroll
      for (int k = 0; k < TL::CPT; ++k) {
        const int r = wt / C4 + (128 / C4) * k;
        res[k] = epi.res.p != nullptr && r < rows
                     ? epi.res.load4((size_t)(m0 + r) * N + col)
                     : zero;
      }
#pragma unroll
      for (int k = 0; k < TL::CPT; ++k) {
        const int r = wt / C4 + (128 / C4) * k;
        if (r >= rows) continue;   // N % 8 == 0: col + 3 < N too
        float4 v = add4(*reinterpret_cast<const float4*>(slab + r * SS + c),
                        bias);
        v = add4(act4(v, epi.act), res[k]);
        if (scaled)
          v = make_float4(v.x * epi.scale, v.y * epi.scale, v.z * epi.scale,
                          v.w * epi.scale);
        const size_t at = (size_t)(m0 + r) * N + col;
        if (epi.c32 != nullptr) *reinterpret_cast<float4*>(epi.c32 + at) = v;
        if (epi.cb != nullptr) store_bf16x4(epi.cb + at, v);
      }
    }
    wg_sync(wg);   // the slab is free for the next unit
  }
}

namespace {

// cuTensorMapEncodeTiled from the driver through the runtime (no -lcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A (outer, inner) row-major bf16 matrix as TMA boxes of (box_outer rows,
// 64 elements = 128 bytes) in the 128-byte swizzle, zero past its edges.
bool bf16_tensor_map(CUtensorMap* map, const void* ptr, int outer, int inner,
                     int box_outer) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)WG_BK, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN>
cudaError_t gemm_wg_prepare() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_wg_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WgTile<BM, BN>::SMEM);
  return attr;
}

// resident blocks an SM (after gemm_wg_prepare)
template <int BM, int BN>
int gemm_wg_blocks() {
  static const int blocks = [] {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, gemm_wg_kernel<BM, BN>, WgTile<BM, BN>::NT,
            WgTile<BM, BN>::SMEM) != cudaSuccess)
      b = 0;
    return b;
  }();
  return blocks;
}

template <int BM, int BN>
int gemm_wg_launch(const uint16_t* A, const uint16_t* B, const Epi& epi,
                   float* ws, int* cnt, int M, int N, int K, int splits,
                   int per, cudaStream_t s) {
  cudaError_t e = gemm_wg_prepare<BM, BN>();
  if (e != cudaSuccess) return (int)e;
  const int per_sm = gemm_wg_blocks<BM, BN>();
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap ta, tb;
  if (!bf16_tensor_map(&ta, A, M, K, BM) ||
      !bf16_tensor_map(&tb, B, K, N, WG_BK))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int units = ((N + BN - 1) / BN) * ((M + BM - 1) / BM) * splits;
  const int grid = units < per_sm * sms ? units : per_sm * sms;
  gemm_wg_kernel<BM, BN><<<grid, WgTile<BM, BN>::NT, WgTile<BM, BN>::SMEM,
                           s>>>(ta, tb, epi, ws, cnt, M, N, K, per, splits);
  return 0;
}

template <int BM, int BN>
int gemm_wg_info(int* info) {
  const void* fn = (const void*)gemm_wg_kernel<BM, BN>;
  cudaError_t e = gemm_wg_prepare<BM, BN>();
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, WgTile<BM, BN>::NT, WgTile<BM, BN>::SMEM);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = WgTile<BM, BN>::SMEM;
  info[3] = blocks;
  return 0;
}

}  // namespace

// gemm in bf16: C = act(A @ B + bias) + res (scaled below epi.scale_cols)
// under plan = {BM, BN, splits} (gemm_plan.plan_bf16), A (M, K) and B (K,
// N) bf16, K and N multiples of 8; into epi.c32 and / or epi.cb. Split:
// ws holds the (splits, M, N) float32 partials and cnt the tiles'
// counters (BM / 64 a tile), zero on entry and left zero. A plan the code
// has no instance for, or a split that leaves a slice empty, returns
// JT_ERR_SHAPE.
inline int gemm_bf16(const int* plan, const uint16_t* A, const uint16_t* B,
                     const Epi& epi, float* ws, int* cnt, int M, int N, int K,
                     cudaStream_t s) {
  const int bm = plan[0], bn = plan[1], splits = plan[2];
  const int steps = (K + WG_BK - 1) / WG_BK;
  if (M < 1 || K < 8 || N < 8 || N % 8 != 0 || K % 8 != 0)
    return JT_ERR_SHAPE;
  if (splits < 1 || splits > steps) return JT_ERR_SHAPE;
  const int per = (steps + splits - 1) / splits;
  if ((splits - 1) * per >= steps) return JT_ERR_SHAPE;   // an empty slice
  if (splits > 1 && (ws == nullptr || cnt == nullptr || !aligned16(ws)))
    return JT_ERR_SHAPE;
  if (!aligned16(A) || !aligned16(B) ||
      (epi.c32 == nullptr && epi.cb == nullptr) ||
      (epi.bias.p != nullptr && !epi.bias.aligned()) ||
      (epi.res.p != nullptr && !epi.res.aligned()) ||
      (epi.c32 != nullptr && !aligned16(epi.c32)) ||
      (epi.cb != nullptr && !aligned8(epi.cb)))
    return JT_ERR_SHAPE;
  decltype(&gemm_wg_launch<64, 64>) launch = nullptr;
  if (bm == 64 && bn == 64) launch = gemm_wg_launch<64, 64>;
  if (bm == 64 && bn == 128) launch = gemm_wg_launch<64, 128>;
  if (bm == 128 && bn == 64) launch = gemm_wg_launch<128, 64>;
  if (bm == 128 && bn == 128) launch = gemm_wg_launch<128, 128>;
  if (launch == nullptr) return JT_ERR_SHAPE;
  const int rc = launch(A, B, epi, ws, cnt, M, N, K, splits, per, s);
  if (rc != 0) return rc;
  JT_CHECK_LAUNCH();
  return 0;
}

// gemm_bf16, then with ln_g.p the row LayerNorm: the product's float32 rows
// wait in ws (where slice 0's partial was) and the row pass writes the
// normalized rows to epi.c32 and / or epi.cb. ws then holds at least M * N
// floats.
inline int gemm_ln_bf16(const int* plan, const uint16_t* A, const uint16_t* B,
                        Epi epi, Rows ln_g, Rows ln_b, int ln_kind, float* ws,
                        int* cnt, int M, int N, int K, cudaStream_t s) {
  if (ln_g.p == nullptr)
    return gemm_bf16(plan, A, B, epi, ws, cnt, M, N, K, s);
  if (ws == nullptr) return JT_ERR_SHAPE;
  float* y32 = epi.c32;
  uint16_t* yb = epi.cb;
  epi.c32 = ws;
  epi.cb = nullptr;
  const int rc = gemm_bf16(plan, A, B, epi, ws, cnt, M, N, K, s);
  if (rc != 0) return rc;
  return layer_norm_bf16(Rows{ws, true}, ln_g, ln_b, y32, yb, M, N, ln_kind,
                         s);
}

// {registers, spill bytes, shared memory, blocks an SM} of one tile of the
// bf16 product.
inline int gemm_info_bf16(int bm, int bn, int* info) {
  if (bm == 64 && bn == 64) return gemm_wg_info<64, 64>(info);
  if (bm == 64 && bn == 128) return gemm_wg_info<64, 128>(info);
  if (bm == 128 && bn == 64) return gemm_wg_info<128, 64>(info);
  if (bm == 128 && bn == 128) return gemm_wg_info<128, 128>(info);
  return JT_ERR_SHAPE;
}

// Zero `n` of a product chain's tile counters (once a call: each product
// leaves them zero).
inline int zero_counters(int* cnt, int n, cudaStream_t s) {
  if (n <= 0) return 0;
  const cudaError_t e = cudaMemsetAsync(cnt, 0, (size_t)n * sizeof(int), s);
  return e == cudaSuccess ? 0 : (int)e;
}

}  // namespace jt
