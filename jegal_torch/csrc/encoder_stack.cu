// A whole transformer encoder stack in one call, for Hopper (sm_90a),
// float32.
//
// Replaces jegal_tpu/ops/pallas/fused_layer.py:_stack_kernel (reached
// through _stack_single and fused_roberta_stack): L layers of
//
//   attention:  [pre-LN] -> QKV (one d x 3d product + bias) -> per-segment
//               multi-head softmax attention with a key mask (-1e9 fill)
//               -> output product + bias + residual -> [post-LN]
//   FFN:        [pre-LN] -> W1 + bias -> ReLU | exact GELU -> W2 + bias +
//               residual -> [post-LN]
//
// as general as the TPU kernel: pre- or post-norm, std or ref LayerNorm,
// ReLU or GELU, head widths 64 and 96. Its main caller is XLM-R (12 layers,
// post-norm, std LN eps 1e-5, GELU, d 768, 12 heads, d_ff 3072).
//
// The TPU kernel ran the stack as one grid over (row blocks, L), holding
// the activations in an f32 VMEM scratch while the next layer's weights
// streamed in. Here the activations stay in two f32 (R, d) device buffers
// (`y` after each attention sublayer, `out` after each FFN sublayer; the
// input `x` is only read), and each layer's device kernels read their
// weights at offset l of the caller's pre-stacked (L, ...) operands, so
// nothing is gathered or concatenated per call. All 7L launches go on the
// caller's stream from one C call.
//
// What bounds it on the H100: at the text path's row counts (R = B * S_b,
// 32..512) every weight byte is read once per call, 28.3 MB a layer for
// XLM-R, and the products do only 2 R FLOP per weight element, so at
// R = 32 the bound is the bytes (340 MB at 3.35 TB/s, 0.10 ms), with the
// float32 operations close behind (5.5 GFLOP at 67 TFLOP/s). This first
// version sequences the shared device kernels (gemm.cuh, encoder.cuh) per
// layer; their 128x128 GEMM tile launches 6-24 blocks at R = 32, so it sits
// far above that bound. A persistent kernel that streams the weights by TMA
// is the later step.
#include "encoder.cuh"
#include "gemm.cuh"

// x (R, d) -> out (R, d) through L layers. Operands stacked per layer,
// row-major: wqkv (L, d, 3d), wo (L, d, d), w1 (L, d, dff), w2 (L, dff, d),
// bqkv (L, 3d), bo (L, d), b1 (L, dff), b2 (L, d), g1/be1/g2/be2 (L, d).
// kmask (R,) key validity (0 = masked) or null. Scratch (caller-allocated):
// h (R, d) when prenorm, qkv (R, 3d), att (R, d), y (R, d), h1 (R, dff).
// act: 1 ReLU, 2 exact-erf GELU; ln_kind: 0 std, 1 ref.
extern "C" int jt_encoder_stack(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* g1, const float* be1, const float* g2,
    const float* be2, const float* kmask, float* h, float* qkv, float* att,
    float* y, float* h1, float* out, int R, int d, int dff, int heads,
    int seg, int L, int prenorm, int ln_kind, int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (seg <= 0 || R % seg != 0 || heads <= 0 || d % heads != 0 || L <= 0)
    return JT_ERR_SHAPE;
  if (d / heads != 64 && d / heads != 96) return JT_ERR_SHAPE;
  const size_t dd = (size_t)d * d;
  for (int l = 0; l < L; ++l) {
    const float* cur = (l == 0) ? x : out;
    const float* ln1_g = g1 + (size_t)l * d;
    const float* ln1_b = be1 + (size_t)l * d;
    const float* ln2_g = g2 + (size_t)l * d;
    const float* ln2_b = be2 + (size_t)l * d;

    // attention sublayer: cur -> y
    const float* src = cur;
    if (prenorm) {
      jt::layer_norm(cur, ln1_g, ln1_b, h, R, d, ln_kind, s);
      JT_CHECK_LAUNCH();
      src = h;
    }
    jt::gemm_f32(src, wqkv + 3 * dd * l, bqkv + (size_t)3 * d * l, nullptr,
                 qkv, R, 3 * d, d, jt::ACT_NONE, s);
    JT_CHECK_LAUNCH();
    const int rc = jt::attention(qkv, kmask, att, R, d, heads, seg, s);
    if (rc != 0) return rc;
    JT_CHECK_LAUNCH();
    jt::gemm_f32(att, wo + dd * l, bo + (size_t)d * l, cur, y, R, d, d,
                 jt::ACT_NONE, s);
    JT_CHECK_LAUNCH();
    if (!prenorm) {
      jt::layer_norm(y, ln1_g, ln1_b, y, R, d, ln_kind, s);
      JT_CHECK_LAUNCH();
    }

    // FFN sublayer: y -> out
    src = y;
    if (prenorm) {
      jt::layer_norm(y, ln2_g, ln2_b, h, R, d, ln_kind, s);
      JT_CHECK_LAUNCH();
      src = h;
    }
    jt::gemm_f32(src, w1 + (size_t)d * dff * l, b1 + (size_t)dff * l,
                 nullptr, h1, R, dff, d, act, s);
    JT_CHECK_LAUNCH();
    jt::gemm_f32(h1, w2 + (size_t)dff * d * l, b2 + (size_t)d * l, y, out, R,
                 d, dff, jt::ACT_NONE, s);
    JT_CHECK_LAUNCH();
    if (!prenorm) {
      jt::layer_norm(out, ln2_g, ln2_b, out, R, d, ln_kind, s);
      JT_CHECK_LAUNCH();
    }
  }
  return 0;
}
