// Fused transformer encoder sublayers for Hopper (sm_90a), float32.
//
// Replaces jegal_tpu/ops/pallas/fused_layer.py:_attn_kernel and
// :_ffn_kernel. Each C entry point below is one sublayer, run as a few
// launches of hand-written kernels on the caller's stream:
//
//   attention:  [pre-LN] -> QKV (one d x 3d product + bias) -> per-segment
//               multi-head softmax attention with a key mask (-1e9 fill)
//               -> output product + bias + residual -> [post-LN]
//   FFN:        [pre-LN] -> W1 + bias -> ReLU | exact GELU -> W2 + bias +
//               residual -> [post-LN]
//
// What bounds it on the H100: the four products (QKV, output, W1, W2) are
// ~99% of the operations. At the window head's 2688 rows they are bound by
// operations; at the gesture and text encoders' 128 and 32 rows by the
// bytes of their weights. They run on the shared 3xTF32 tensor-core GEMM
// (gemm.cuh) with bias, activation and residual fused into its epilogue,
// split over K where the row tiles alone would leave SMs idle, and the
// post-LayerNorm fused into the split-K reduction. The only extra passes
// over device memory are the split partials, the pre-LayerNorm rows and
// the (R, 3d) QKV and (R, d_ff) activations, which the TPU kernel kept in
// VMEM. The wrapper plans each product (ops/kernels/gemm_plan.py) and
// allocates the workspace; plans holds {BM, BN, splits} per product.
//
// Attention and LayerNorm are the device code shared with encoder_stack.cu
// (encoder.cuh).
//
// The `_bf16` entries are the bf16 variants (the JAX engine's bf16 dtype):
// bf16 rows, weights and outputs, float32 or bf16 biases and norms (read as
// float32), the products on gemm.cuh's wgmma bf16 product and the
// attention on encoder.cuh's bf16 core, rounding where `_attn_kernel` and
// `_ffn_kernel` round a bf16 block:
// the pre-LN (float32) rounded to bf16 before the first product, the QKV
// product's float32 sums plus bias rounded to bf16 as it writes them (q
// times the scale first), the attention output bf16, the residual and the
// post-LN in float32 and the output rounded once; the FFN's hidden rows
// rounded to bf16 after the float32 activation. A split product reduces
// its slices in its own kernel, so a sublayer runs [the pre-LN], its two
// products (and for attention the core between them) and [the post-LN's
// row pass], plus one memset of the tile counters where a product splits.
#include "encoder.cuh"
#include "gemm.cuh"

// One attention sublayer over R = n_segments * seg rows of width d.
// Scratch (caller-allocated): h (R, d) when prenorm, qkv (R, 3d), att (R, d),
// ws the split-K workspace. plans: QKV, then the output product. Device
// kernels: [pre-LN], QKV, the attention core, output [+ its split-K
// reduction or the post-LN].
extern "C" int jt_attn_sublayer(const float* x, const float* wqkv,
                                const float* bqkv, const float* wo,
                                const float* bo, const float* ln_g,
                                const float* ln_b, const float* kmask,
                                float* h, float* qkv, float* att, float* out,
                                float* ws, const int* plans, int R, int d,
                                int heads, int seg, int prenorm, int ln_kind,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (seg <= 0 || R % seg != 0 || d % heads != 0) return JT_ERR_SHAPE;
  const float* src = x;
  if (prenorm) {
    const int rc = jt::layer_norm(x, ln_g, ln_b, h, R, d, ln_kind, s);
    if (rc != 0) return rc;
    src = h;
  }
  // A split QKV product's partials stay in ws, and the attention core sums
  // them. The output product then reuses ws: stream order runs the core to
  // its end before that product writes it.
  int rc = jt::gemm(plans, src, wqkv, bqkv, nullptr, qkv, ws, R, 3 * d, d,
                    jt::ACT_NONE, nullptr, nullptr, 0, s, /*reduce=*/false);
  if (rc != 0) return rc;
  rc = jt::attention(jt::qkv_source(plans, qkv, ws, bqkv, R, d), kmask, att,
                     R, d, heads, seg, s);
  if (rc != 0) return rc;
  return jt::gemm(plans + 3, att, wo, bo, x, out, ws, R, d, d, jt::ACT_NONE,
                  prenorm ? nullptr : ln_g, ln_b, ln_kind, s);
}

// {registers, spill bytes, shared memory, blocks an SM} of the attention
// core's schedule for head width dk, packed (seg <= 64) or streamed.
extern "C" int jt_attention_info(int dk, int packed, int* info) {
  return jt::attention_info(dk, packed != 0, info);
}

// One FFN sublayer over R rows. Scratch: h (R, d) when prenorm,
// h1 (R, dff), ws the split-K workspace. plans: W1, then W2.
// act: 1 ReLU, 2 exact-erf GELU.
extern "C" int jt_ffn_sublayer(const float* x, const float* w1,
                               const float* b1, const float* w2,
                               const float* b2, const float* ln_g,
                               const float* ln_b, float* h, float* h1,
                               float* out, float* ws, const int* plans, int R,
                               int d, int dff, int prenorm, int ln_kind,
                               int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* src = x;
  if (prenorm) {
    const int rc = jt::layer_norm(x, ln_g, ln_b, h, R, d, ln_kind, s);
    if (rc != 0) return rc;
    src = h;
  }
  const int rc = jt::gemm(plans, src, w1, b1, nullptr, h1, ws, R, dff, d,
                          act, nullptr, nullptr, 0, s);
  if (rc != 0) return rc;
  return jt::gemm(plans + 3, h1, w2, b2, x, out, ws, R, d, dff, jt::ACT_NONE,
                  prenorm ? nullptr : ln_g, ln_b, ln_kind, s);
}

// The bf16 attention sublayer: x, wqkv, wo, h, qkv, att, out bf16
// (uint16_t bit patterns); bqkv, bo, ln_g and ln_b float32 (vec_f32 1) or
// bf16 (0), read as float32 in the kernels; kmask and ws float32; cnt the
// products' n_cnt tile counters. Scratch as jt_attn_sublayer, qkv (R, 3d)
// bf16; ws holds a split product's partials and the output product's
// float32 rows when a post-LN follows it. plans: gemm_plan.plan_bf16's.
extern "C" int jt_attn_sublayer_bf16(
    const uint16_t* x, const uint16_t* wqkv, const void* bqkv,
    const uint16_t* wo, const void* bo, const void* ln_g, const void* ln_b,
    const float* kmask, uint16_t* h, uint16_t* qkv, uint16_t* att,
    uint16_t* out, float* ws, int* cnt, const int* plans, int R, int d,
    int heads, int seg, int prenorm, int ln_kind, int vec_f32, int n_cnt,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (seg <= 0 || R % seg != 0 || heads <= 0 || d % heads != 0)
    return JT_ERR_SHAPE;
  int rc = jt::zero_counters(cnt, n_cnt, s);
  if (rc != 0) return rc;
  const bool f = vec_f32 != 0;
  const jt::Rows xr{x, false}, none{nullptr, false}, g{ln_g, f}, b{ln_b, f};
  const uint16_t* src = x;
  if (prenorm) {
    rc = jt::layer_norm_bf16(xr, g, b, nullptr, h, R, d, ln_kind, s);
    if (rc != 0) return rc;
    src = h;
  }
  const float scale = (float)(1.0 / sqrt((double)(d / heads)));
  rc = jt::gemm_bf16(
      plans, src, wqkv,
      jt::Epi{jt::Rows{bqkv, f}, jt::ACT_NONE, none, scale, d, nullptr, qkv},
      ws, cnt, R, 3 * d, d, s);
  if (rc != 0) return rc;
  rc = jt::attention_bf16(qkv, kmask, att, R, d, heads, seg, s);
  if (rc != 0) return rc;
  return jt::gemm_ln_bf16(
      plans + 3, att, wo,
      jt::Epi{jt::Rows{bo, f}, jt::ACT_NONE, xr, 1.f, 0, nullptr, out},
      prenorm ? none : g, b, ln_kind, ws, cnt, R, d, d, s);
}

// {registers, spill bytes, shared memory, blocks an SM} of the bf16
// attention core's schedule (streamed: staging the longest segment).
extern "C" int jt_attention_info_bf16(int dk, int packed, int* info) {
  return jt::attention_info_bf16(dk, packed != 0, info);
}

// The same of the bf16 product's (bm, bn) tile.
extern "C" int jt_gemm_info_bf16(int bm, int bn, int* info) {
  return jt::gemm_info_bf16(bm, bn, info);
}

// The bf16 FFN sublayer: x, w1, w2, h, h1, out bf16; b1, b2, ln_g, ln_b
// float32 (vec_f32 1) or bf16 (0); ws float32; cnt the products' tile
// counters. Scratch and plans as jt_ffn_sublayer's (plans from
// gemm_plan.plan_bf16).
extern "C" int jt_ffn_sublayer_bf16(
    const uint16_t* x, const uint16_t* w1, const void* b1,
    const uint16_t* w2, const void* b2, const void* ln_g, const void* ln_b,
    uint16_t* h, uint16_t* h1, uint16_t* out, float* ws, int* cnt,
    const int* plans, int R, int d, int dff, int prenorm, int ln_kind,
    int act, int vec_f32, int n_cnt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = jt::zero_counters(cnt, n_cnt, s);
  if (rc != 0) return rc;
  const bool f = vec_f32 != 0;
  const jt::Rows xr{x, false}, none{nullptr, false}, g{ln_g, f}, b{ln_b, f};
  const uint16_t* src = x;
  if (prenorm) {
    rc = jt::layer_norm_bf16(xr, g, b, nullptr, h, R, d, ln_kind, s);
    if (rc != 0) return rc;
    src = h;
  }
  rc = jt::gemm_bf16(plans, src, w1,
                     jt::Epi{jt::Rows{b1, f}, act, none, 1.f, 0, nullptr, h1},
                     ws, cnt, R, dff, d, s);
  if (rc != 0) return rc;
  return jt::gemm_ln_bf16(
      plans + 3, h1, w2,
      jt::Epi{jt::Rows{b2, f}, jt::ACT_NONE, xr, 1.f, 0, nullptr, out},
      prenorm ? none : g, b, ln_kind, ws, cnt, R, d, dff, s);
}
