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
// nothing is gathered or concatenated per call. All its device launches go
// on the caller's stream from one C call.
//
// What bounds it on the H100: at the text path's row counts (R = B * S_b,
// 32..512) every weight byte is read once per call, 28.3 MB a layer for
// XLM-R, and the products do only 2 R FLOP per weight element, so at
// R = 32 the bound is the bytes (340 MB at 3.35 TB/s, 0.10 ms); in 3xTF32
// on the tensor cores the operations (3 x 5.5 GFLOP at 495 TFLOP/s) come
// close behind. The products run on the shared GEMM of gemm.cuh: 32-row
// tiles at R = 32, split over K until each product launches at least one
// wave of blocks on the 132 SMs, a cp.async ring that keeps the weight
// bytes in flight, and 3xTF32 mma.sync. The plans are computed once per
// call by the wrapper (ops/kernels/gemm_plan.py), and the post-LayerNorms
// run inside the split-K reductions; a split QKV product's partials are
// summed by the attention core as it loads them (encoder.cuh). Device
// launches per post-norm layer at R = 32: a product and its reduction for
// the output, W1 and W2 products, the QKV product and the attention core:
// 8 (96 for XLM-R), one after another, each a few microseconds, which with
// the weights' 0.10 ms sets this design's floor. The step after this one
// is a persistent kernel that streams each layer's weights by TMA into
// wgmma (weights stored K-major at load time) and keeps the (R, d)
// activations on chip, so a layer is not 8 launches.
#include "encoder.cuh"
#include "gemm.cuh"

// x (R, d) -> out (R, d) through L layers. Operands stacked per layer,
// row-major: wqkv (L, d, 3d), wo (L, d, d), w1 (L, d, dff), w2 (L, dff, d),
// bqkv (L, 3d), bo (L, d), b1 (L, dff), b2 (L, d), g1/be1/g2/be2 (L, d).
// kmask (R,) key validity (0 = masked) or null. Scratch (caller-allocated):
// h (R, d) when prenorm, qkv (R, 3d), att (R, d), y (R, d), h1 (R, dff),
// ws the split-K workspace. plans: {BM, BN, splits} of QKV, the output
// product, W1 and W2, the same for every layer.
// act: 1 ReLU, 2 exact-erf GELU; ln_kind: 0 std, 1 ref.
extern "C" int jt_encoder_stack(
    const float* x, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* g1, const float* be1, const float* g2,
    const float* be2, const float* kmask, float* h, float* qkv, float* att,
    float* y, float* h1, float* out, float* ws, const int* plans, int R,
    int d, int dff, int heads, int seg, int L, int prenorm, int ln_kind,
    int act, void* stream) {
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
      const int rc = jt::layer_norm(cur, ln1_g, ln1_b, h, R, d, ln_kind, s);
      if (rc != 0) return rc;
      src = h;
    }
    // a split QKV product's partials stay in ws for the attention core,
    // which stream order runs to its end before the output product
    // overwrites ws
    const float* bq = bqkv + (size_t)3 * d * l;
    int rc = jt::gemm(plans, src, wqkv + 3 * dd * l, bq, nullptr, qkv, ws, R,
                      3 * d, d, jt::ACT_NONE, nullptr, nullptr, 0, s,
                      /*reduce=*/false);
    if (rc != 0) return rc;
    rc = jt::attention(jt::qkv_source(plans, qkv, ws, bq, R, d), kmask, att,
                       R, d, heads, seg, s);
    if (rc != 0) return rc;
    rc = jt::gemm(plans + 3, att, wo + dd * l, bo + (size_t)d * l, cur, y, ws,
                  R, d, d, jt::ACT_NONE, prenorm ? nullptr : ln1_g, ln1_b,
                  ln_kind, s);
    if (rc != 0) return rc;

    // FFN sublayer: y -> out
    src = y;
    if (prenorm) {
      rc = jt::layer_norm(y, ln2_g, ln2_b, h, R, d, ln_kind, s);
      if (rc != 0) return rc;
      src = h;
    }
    rc = jt::gemm(plans + 6, src, w1 + (size_t)d * dff * l,
                  b1 + (size_t)dff * l, nullptr, h1, ws, R, dff, d, act,
                  nullptr, nullptr, 0, s);
    if (rc != 0) return rc;
    rc = jt::gemm(plans + 9, h1, w2 + (size_t)dff * d * l, b2 + (size_t)d * l,
                  y, out, ws, R, d, dff, jt::ACT_NONE,
                  prenorm ? nullptr : ln2_g, ln2_b, ln_kind, s);
    if (rc != 0) return rc;
  }
  return 0;
}
