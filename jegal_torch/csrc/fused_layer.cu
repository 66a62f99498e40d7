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
