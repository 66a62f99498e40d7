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
// ~99% of the operations; in float32 on the CUDA cores their bound is the
// 67 TFLOP/s non-tensor rate, not memory (the window head's 2688-row
// products do ~30 FLOP per byte moved even counting every operand once).
// The design keeps them on one tiled register-blocked GEMM (gemm.cuh) with
// bias, activation and residual fused into its epilogue, so the only extra
// passes over device memory are the LayerNorm rows and the (R, 3d) QKV and
// (R, d_ff) activations, which the TPU kernel kept in VMEM.
//
// Attention and LayerNorm are the device code shared with encoder_stack.cu
// (encoder.cuh).
#include "encoder.cuh"
#include "gemm.cuh"

// One attention sublayer over R = n_segments * seg rows of width d.
// Scratch (caller-allocated): h (R, d) when prenorm, qkv (R, 3d), att (R, d).
extern "C" int jt_attn_sublayer(const float* x, const float* wqkv,
                                const float* bqkv, const float* wo,
                                const float* bo, const float* ln_g,
                                const float* ln_b, const float* kmask,
                                float* h, float* qkv, float* att, float* out,
                                int R, int d, int heads, int seg, int prenorm,
                                int ln_kind, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (seg <= 0 || R % seg != 0 || d % heads != 0) return JT_ERR_SHAPE;
  const float* src = x;
  if (prenorm) {
    jt::layer_norm(x, ln_g, ln_b, h, R, d, ln_kind, s);
    JT_CHECK_LAUNCH();
    src = h;
  }
  jt::gemm_f32(src, wqkv, bqkv, nullptr, qkv, R, 3 * d, d, jt::ACT_NONE, s);
  JT_CHECK_LAUNCH();
  const int rc = jt::attention(qkv, kmask, att, R, d, heads, seg, s);
  if (rc != 0) return rc;
  JT_CHECK_LAUNCH();
  jt::gemm_f32(att, wo, bo, x, out, R, d, d, jt::ACT_NONE, s);
  JT_CHECK_LAUNCH();
  if (!prenorm) {
    jt::layer_norm(out, ln_g, ln_b, out, R, d, ln_kind, s);
    JT_CHECK_LAUNCH();
  }
  return 0;
}

// One FFN sublayer over R rows. Scratch: h (R, d) when prenorm,
// h1 (R, dff). act: 1 ReLU, 2 exact-erf GELU.
extern "C" int jt_ffn_sublayer(const float* x, const float* w1,
                               const float* b1, const float* w2,
                               const float* b2, const float* ln_g,
                               const float* ln_b, float* h, float* h1,
                               float* out, int R, int d, int dff, int prenorm,
                               int ln_kind, int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* src = x;
  if (prenorm) {
    jt::layer_norm(x, ln_g, ln_b, h, R, d, ln_kind, s);
    JT_CHECK_LAUNCH();
    src = h;
  }
  jt::gemm_f32(src, w1, b1, nullptr, h1, R, dff, d, act, s);
  JT_CHECK_LAUNCH();
  jt::gemm_f32(h1, w2, b2, x, out, R, d, dff, jt::ACT_NONE, s);
  JT_CHECK_LAUNCH();
  if (!prenorm) {
    jt::layer_norm(out, ln_g, ln_b, out, R, d, ln_kind, s);
    JT_CHECK_LAUNCH();
  }
  return 0;
}
