"""The port's bf16 engine on the CPU against the JAX package's bf16 path.

1. Each bf16 plain twin (kernels 1 and 2 float and planar, 3, 4, 5 and 7)
   against the JAX Pallas kernel run in interpret mode on bf16 inputs, as the JAX
   package's own tests run them (tests/test_stem_pallas.py,
   tests/test_conv2_pallas.py:89-95, tests/test_fused_layer.py). The bar
   (tests/bf16_bars.py): every element within 2 bf16 ulps of the Pallas
   kernel's (`bf16_bars.ulps`, which measures an element that cancels to
   near zero at 1/16 of its row's scale), and a min row cosine of 0.9999. Both round the same float32 values at the same
   sites; they sum in another order, which can move a value across one
   rounding boundary.
2. The bf16 engine (`JegalEngine(dtype=torch.bfloat16)`) on one short clip
   at the real 270x480 geometry: raw and planar `vta`, `extract_many` and
   the two-stage path against the JAX bf16 engine (min row cosine 0.999:
   XLA rounds its bf16 layer loop at other sites than the port's kernels'
   twins) and against the port's own float32 engine (0.9995); rows unit
   norm in float32; a bf16 engine's `gestsync_features` accepted by its own
   `extract`; the same engine with stem_impl="window" (the JAX engine's
   stem), raw and planar.
3. `--bf16` on `infer` and `serve` in-process on the CPU; a bf16 stack past
   512 frames through the card's routing (the flash attention) against the
   JAX stack on its flash kernel; and the refusals: a dtype no kernel
   takes, mixed dtypes.

Inputs come from numpy seeds; weights from the port's init_* (randomized
BatchNorm statistics and LayerNorm parameters), cast to bf16 on each side
with round-to-nearest-even, so both packages see the same bf16 values."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jegal_tpu import api as JAPI
from jegal_tpu.host import media
from jegal_tpu.models import roberta as JR
from jegal_tpu.ops.pallas import conv2 as JC2
from jegal_tpu.ops.pallas import fused_layer as JF
from jegal_tpu.ops.pallas import stem as JS
from jegal_tpu.text.tokenizer import WordTokenizer as JaxWordTokenizer
from jegal_torch import api as TAPI
from jegal_torch.convert import (
    gestsync_params_from_jax,
    init_gestsync_params,
    init_jegal_params,
    init_roberta_params,
    jegal_params_from_jax,
    roberta_params_from_jax,
    tree_to_torch,
)
from jegal_torch.core import transformer as TT
from jegal_torch.models.roberta import RobertaConfig
from jegal_torch.ops.kernels import _build
from jegal_torch.ops.kernels import conv2 as TC2
from jegal_torch.ops.kernels import flash_attention as FA
from jegal_torch.ops.kernels import fused_layer as TF
from jegal_torch.ops.kernels import stem as TS
from jegal_torch.ops.video import s2d_repack
from jegal_torch.text.tokenizer import WordTokenizer
import bf16_bars as bars
from bf16_bars import KERNEL_COS, as_f32
from tok_util import make_tiny_tokenizer
from torch_threads import few_torch_threads  # noqa: F401

BF = torch.bfloat16
JAX_COS = 0.999
F32_COS = 0.9995
T = 8                                    # frames: T bucket 32
TINY_XLMR = dict(vocab_size=64, hidden_size=768, num_layers=1, num_heads=8,
                 intermediate_size=256, max_position_embeddings=64)


def _f32(a):
    return as_f32(a) if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))


def min_row_cos(a, b):
    return bars.min_row_cos(_f32(a), _f32(b))


def assert_kernel_bar(got, want):
    assert got.dtype == BF
    assert tuple(got.shape) == tuple(np.shape(want))
    bars.check_kernel_bar(_f32(got), _f32(want))


@pytest.fixture(scope="module")
def gs_np():
    """GestSync weights as a float32 numpy tree (JAX layout)."""
    return jax.tree.map(lambda t: t.numpy(),
                        init_gestsync_params(torch.Generator().manual_seed(41)))


def _jax_bf16(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


def _torch_bf16(tree):
    return jax.tree.map(lambda t: t.to(BF), tree_to_torch(tree))


def _mgrid_dense(m, w_pool):
    return np.asarray(m)[..., 0:2 * w_pool:2].transpose(0, 1, 3, 2)


# ---------------------------------------------------------------------------
# 1. Twins against the Pallas kernels, interpreted, in bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", TS.IMPLS)
@pytest.mark.parametrize("shape", [(24, 33, 24), (13, 45, 48)])
def test_band_stem_bf16_twin_float_entry(gs_np, shape, impl):
    """The bf16 stems' twin (kernels 1b and 2b share it) against the JAX
    window and band kernels interpreted in bf16, float entry."""
    t4, h, w = shape
    frames = np.random.default_rng(7).random((t4, h, w, 3)) \
        .astype(np.float32)
    blk = gs_np["net_vid"][0]
    lhs, scale, bias = JS.stem_kernel_params(_jax_bf16(blk))
    m = JS.stem_mgrid_x(JS.s2d_lanes(jnp.asarray(frames, jnp.bfloat16)),
                        lhs, scale, bias, w_valid=w // 3, interpret=True,
                        impl=impl)
    ops = TS.stem_kernel_params(_torch_bf16(blk))
    assert ops[0].dtype == BF and ops[1].dtype == torch.float32
    got = TS.stem_pool(torch.from_numpy(frames).to(BF), *ops, impl=impl)
    assert_kernel_bar(got, _mgrid_dense(m, got.shape[2]))


@pytest.mark.parametrize("impl", TS.IMPLS)
def test_band_stem_bf16_twin_planar_entry(gs_np, impl):
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (12, 27, 48, 3), dtype=np.uint8)
    cut = rng.integers(0, 12, 12).astype(np.int32)
    blk = gs_np["net_vid"][0]
    lhs, scale, bias = JS.stem_kernel_params(_jax_bf16(blk))
    m = JS.stem_mgrid_planar(jnp.asarray(media.s2d_repack(frames, cut)), lhs,
                             scale, bias, dtype=jnp.bfloat16, interpret=True,
                             impl=impl)
    ops = TS.stem_kernel_params(_torch_bf16(blk))
    _build.reset_launches()
    got = TS.stem_pool_planar(torch.from_numpy(s2d_repack(frames, cut)), *ops,
                              impl=impl)
    assert not any(_build.LAUNCHES.values())
    assert_kernel_bar(got, _mgrid_dense(m, got.shape[2]))


@pytest.mark.parametrize("t,n_j,w_pool", [(18, 11, 14), (3, 5, 5)])
def test_conv2_bf16_twin(gs_np, t, n_j, w_pool):
    blk2 = gs_np["net_vid"][1]
    dense = np.abs(np.random.default_rng(8).standard_normal(
        (t, n_j, w_pool, 64))).astype(np.float32)
    dense_bf = np.asarray(jnp.asarray(dense, jnp.bfloat16))
    m = np.zeros((t, n_j, 64, JS.SLOT), dense_bf.dtype)
    m[..., 0:2 * w_pool:2] = dense_bf.transpose(0, 1, 3, 2)
    want = JC2.mgrid_conv2_fused(jnp.asarray(m), *JC2.conv2_kernel_params(
        _jax_bf16(blk2)), w_pool, interpret=True)
    ops = TC2.conv2_kernel_params(_torch_bf16(blk2))
    got = TC2.conv2_bn_relu(torch.from_numpy(dense).to(BF), *ops)
    assert_kernel_bar(got, want)


def _layers(seed: int, n: int, d: int, dff: int):
    """n encoder layers (core/transformer layout) as float32 numpy, with
    randomized LayerNorm parameters and biases."""
    rng = np.random.default_rng(seed)

    def lin(i, o):
        return {"kernel": (rng.standard_normal((i, o)) / np.sqrt(i))
                .astype(np.float32),
                "bias": (0.1 * rng.standard_normal(o)).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}

    return [{"attn": {k: lin(d, d) for k in "qkvo"},
             "ff": {"w1": lin(d, dff), "w2": lin(dff, d)},
             "norm1": ln(), "norm2": ln()} for _ in range(n)]


def _rows_and_mask(seed, r, d, seg):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r, d)).astype(np.float32)
    kmask = np.ones((r // seg, seg), np.float32)
    kmask[-1, seg // 2:] = 0.0
    return x, kmask.reshape(-1)


def _segm_kcols(r, seg, kmask):
    rows = np.arange(r)
    segm = jnp.asarray((rows[:, None] // seg) == (rows[None, :] // seg),
                       jnp.float32)
    return segm, jnp.asarray(kmask.reshape(1, 1, r))


SUBLAYER_CASES = [  # (seg, d, heads, prenorm, ln_kind)
    (21, 128, 2, False, "std"),        # the window head (segments of 21)
    (16, 192, 2, True, "ref"),         # the JEGAL encoders, dk 96
]


@pytest.mark.parametrize("seg,d,heads,prenorm,ln_kind", SUBLAYER_CASES)
def test_attn_sublayer_bf16_twin(seg, d, heads, prenorm, ln_kind):
    r = 4 * seg if seg % 8 == 0 else 8 * seg
    layer = _layers(60, 1, d, 2 * d)[0]
    x, kmask = _rows_and_mask(61, r, d, seg)
    segm, kcols = _segm_kcols(r, seg, kmask)
    jl = _jax_bf16(layer)
    want = JF._attn_sublayer(jnp.asarray(x, jnp.bfloat16), jl["attn"],
                             jl["norm1"], segm, kcols, heads=heads,
                             prenorm=prenorm, ln_kind=ln_kind, br=r,
                             interpret=True)
    w = TF.fused_weights(_torch_bf16(layer))
    got = TF.attn_sublayer(torch.from_numpy(x).to(BF), w, seg, heads,
                           prenorm=prenorm, ln_kind=ln_kind,
                           kmask=torch.from_numpy(kmask))
    assert_kernel_bar(got, want)


@pytest.mark.parametrize("prenorm,ln_kind,activation", [
    (False, "std", "relu"), (True, "ref", "relu"), (False, "std", "gelu")])
def test_ffn_sublayer_bf16_twin(prenorm, ln_kind, activation):
    r, d = 64, 128
    layer = _layers(62, 1, d, 2048)[0]      # two 1024-wide d_ff blocks
    x, _ = _rows_and_mask(63, r, d, 16)
    jl = _jax_bf16(layer)
    want = JF._ffn_sublayer(jnp.asarray(x, jnp.bfloat16), jl["ff"],
                            jl["norm2"], prenorm=prenorm, ln_kind=ln_kind,
                            br=r, interpret=True, activation=activation)
    w = TF.fused_weights(_torch_bf16(layer))
    got = TF.ffn_sublayer(torch.from_numpy(x).to(BF), w, prenorm=prenorm,
                          ln_kind=ln_kind, activation=activation)
    assert_kernel_bar(got, want)


@pytest.mark.parametrize("prenorm,ln_kind,activation", [
    (False, "std", "gelu"),     # XLM-R
    (True, "ref", "relu"),      # the JEGAL encoders
])
def test_encoder_stack_bf16_twin(prenorm, ln_kind, activation):
    """The stack's twin keeps the residual stream in float32 between
    layers, as `_stack_kernel`'s scratch does: L 2, d 128, two 16-token
    sequences, the second with a pad tail."""
    seg, d, heads = 16, 128, 2
    layers = _layers(64, 2, d, 256)
    x, kmask = _rows_and_mask(65, 2 * seg, d, seg)
    want = JF.fused_encoder_stack(
        _jax_bf16(layers), jnp.asarray(x, jnp.bfloat16), seg, heads,
        prenorm=prenorm, ln_kind=ln_kind, kmask=jnp.asarray(kmask),
        interpret=True, activation=activation, single_kernel=True)
    w = TF.stacked_weights(_torch_bf16(layers))
    got = TF.encoder_stack(torch.from_numpy(x).to(BF), w, seg, heads,
                           prenorm=prenorm, ln_kind=ln_kind,
                           activation=activation,
                           kmask=torch.from_numpy(kmask))
    assert_kernel_bar(got, want)


def test_rows_of_another_dtype_raise():
    w = TF.fused_weights(tree_to_torch(_layers(66, 1, 128, 256)[0]))
    x = torch.zeros(21, 128, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TF.attn_sublayer(x, w, 21, 2, prenorm=False, ln_kind="std")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TF.ffn_sublayer(x, w, prenorm=False, ln_kind="std")


# ---------------------------------------------------------------------------
# 2. The bf16 engine against the JAX bf16 engine and its own float32 engine
# ---------------------------------------------------------------------------

def _as_numpy(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def weights():
    cfg = RobertaConfig(**TINY_XLMR)
    return (_as_numpy(init_jegal_params(torch.Generator().manual_seed(31))),
            _as_numpy(init_gestsync_params(torch.Generator().manual_seed(32))),
            _as_numpy(init_roberta_params(torch.Generator().manual_seed(33),
                                          cfg)))


@pytest.fixture(scope="module")
def sample():
    rng = np.random.default_rng(21)
    return dict(
        frames=rng.integers(0, 256, (T, 270, 480, 3), dtype=np.uint8),
        chin_rows=rng.integers(90, 200, T).astype(np.int32),
        wav=(rng.standard_normal(T * 640) * 1000).astype(np.float32),
        word_boundaries=[["a", 0, 1], ["b", 2, 4], ["c", 5, 7]],
        text="hello world abc", fname="clip")


def _port_engine(weights, dtype, **kw):
    jp, gp, rp = weights
    return TAPI.JegalEngine(jegal_params_from_jax(jp),
                            gestsync_params_from_jax(gp), device="cpu",
                            roberta_params=roberta_params_from_jax(rp),
                            roberta_cfg=RobertaConfig(**TINY_XLMR),
                            tokenizer=WordTokenizer(make_tiny_tokenizer()),
                            dtype=dtype, **kw)


@pytest.fixture(scope="module")
def port_bf16(weights):
    return _port_engine(weights, BF)


@pytest.fixture(scope="module")
def results(weights, sample, port_bf16):
    """`vta` from raw frames by the JAX bf16 engine, the port's float32
    engine and the port's bf16 engine; the bf16 engine's planar `vta`."""
    jp, gp, rp = weights
    jax_eng = JAPI.JegalEngine(
        jegal_params=jp, gestsync_params=gp, roberta_params=rp,
        roberta_cfg=JR.RobertaConfig(**TINY_XLMR),
        tokenizer=JaxWordTokenizer(make_tiny_tokenizer()),
        dtype=jnp.bfloat16)
    planar = s2d_repack(sample["frames"], sample["chin_rows"])
    no_chin = {k: v for k, v in sample.items()
               if k not in ("frames", "chin_rows")}
    return {
        "jax": jax_eng.extract(modalities="vta", **sample),
        "f32": _port_engine(weights, torch.float32).extract(
            modalities="vta", **sample),
        "bf16": port_bf16.extract(modalities="vta", **sample),
        "planar": port_bf16.extract(modalities="vta", frames=planar,
                                    **no_chin),
    }


def _check_embs(got, want, bar):
    for k in ("gesture_emb", "content_emb"):
        assert got[k].dtype == np.float32
        assert got[k].shape == want[k].shape
        assert min_row_cos(got[k], want[k]) >= bar, k


@pytest.mark.parametrize("which", ["bf16", "planar"])
def test_bf16_vta_matches_jax_bf16_and_port_f32(results, which):
    got = results[which]
    assert got["gesture_emb"].shape == (T, 512)
    assert got["content_emb"].shape == (3, 512)
    _check_embs(got, results["jax"], JAX_COS)
    _check_embs(got, results["f32"], F32_COS)
    for k in ("gesture_emb", "content_emb"):
        np.testing.assert_allclose(np.linalg.norm(got[k], axis=-1), 1.0,
                                   rtol=0, atol=1e-6)


def test_bf16_extract_many_and_two_stage(results, sample, port_bf16):
    """extract_many over the raw clip, its planar twin and a shorter clip
    (two T buckets); the two-stage path from the engine's own features.
    Against the engine's own single-clip rows the bar is KERNEL_COS: a
    batch of two sums its bf16 products in other blocks than one clip
    does, which moves some bf16 roundings by one ulp."""
    planar = s2d_repack(sample["frames"], sample["chin_rows"])
    no_chin = {k: v for k, v in sample.items()
               if k not in ("frames", "chin_rows")}
    many = port_bf16.extract_many(
        [sample, dict(no_chin, frames=planar),
         dict(no_chin, frames=planar[:5])], modalities="vta", batch_size=2)
    _check_embs(many[0], results["bf16"], KERNEL_COS)
    _check_embs(many[1], results["planar"], KERNEL_COS)
    for got in many[:2]:
        _check_embs(got, results["jax"], JAX_COS)
        _check_embs(got, results["f32"], F32_COS)
    assert many[2]["gesture_emb"].shape == (5, 512)
    feats = port_bf16.gestsync_features(sample["frames"], sample["chin_rows"])
    assert feats.dtype == np.float32 and feats.shape == (T, 1024)
    assert np.array_equal(feats, feats.astype(jnp.bfloat16).astype(np.float32))
    two = port_bf16.extract(modalities="vta", visual_feats=feats, **no_chin)
    _check_embs(two, results["bf16"], KERNEL_COS)
    _check_embs(two, results["jax"], JAX_COS)
    _check_embs(two, results["f32"], F32_COS)
    dev = port_bf16.gestsync_features(sample["frames"], sample["chin_rows"],
                                      as_device=True)
    assert dev.dtype == BF
    again = port_bf16.extract(modalities="vta", visual_feats=dev, **no_chin)
    np.testing.assert_array_equal(again["gesture_emb"], two["gesture_emb"])


@pytest.mark.parametrize("frames", ["raw", "planar"])
def test_bf16_window_stem_engine(weights, sample, results, frames):
    """A bf16 engine with stem_impl="window" (the JAX engine's default
    stem) against the JAX bf16 engine and the float32 engine at the bars
    above. On the CPU both stems take one twin, so its rows equal the
    bf16 band engine's bit for bit."""
    eng = _port_engine(weights, BF, stem_impl="window")
    if frames == "raw":
        got = eng.extract(modalities="vta", **sample)
        want = results["bf16"]
    else:
        no_chin = {k: v for k, v in sample.items()
                   if k not in ("frames", "chin_rows")}
        got = eng.extract(modalities="vta", frames=s2d_repack(
            sample["frames"], sample["chin_rows"]), **no_chin)
        want = results["planar"]
    _check_embs(got, results["jax"], JAX_COS)
    _check_embs(got, results["f32"], F32_COS)
    for k in ("gesture_emb", "content_emb"):
        np.testing.assert_array_equal(got[k], want[k])


def test_bf16_graph_signatures_carry_the_dtype(port_bf16):
    assert port_bf16.cached_graphs
    assert all(sig[-1] == "bfloat16" for sig in port_bf16.cached_graphs)


# ---------------------------------------------------------------------------
# 3. The CLI's --bf16, and the refusals
# ---------------------------------------------------------------------------

def test_refusals(weights):
    """A dtype no kernel takes raises; a bf16 engine and the bf16 stem
    wrapper take stem_impl="window"."""
    jp, gp, _ = weights
    eng = TAPI.JegalEngine(jegal_params_from_jax(jp), device="cpu", dtype=BF,
                           stem_impl="window")
    assert eng.dtype == BF
    with pytest.raises(ValueError, match="dtype"):
        TAPI.JegalEngine(jegal_params_from_jax(jp), device="cpu",
                         dtype=torch.float16)
    ops = TS.stem_kernel_params(_torch_bf16(gp["net_vid"][0]))
    got = TS.stem_pool(torch.zeros(5, 27, 24, 3, dtype=BF), *ops,
                       impl="window")
    assert got.dtype == BF and tuple(got.shape) == TS.pooled_shape(5, 27, 24)


def _dtype_case(case):
    rng = np.random.default_rng(68)
    q = torch.from_numpy(rng.standard_normal((1, 2, 16, 64))
                         .astype(np.float32))
    ops = TS.stem_kernel_params(_torch_bf16(_as_numpy(
        init_gestsync_params(torch.Generator().manual_seed(69)))
        ["net_vid"][0]))
    frames = torch.rand(5, 27, 24, 3, generator=torch.Generator()
                        .manual_seed(70))
    if case == "flash float16":
        return FA.flash_attention(*(q.half() for _ in range(3)))
    if case == "flash mixed":
        return FA.flash_attention(q.to(BF), q, q.to(BF))
    if case == "stem float16":
        return TS.stem_pool(frames.half(), ops[0].half(), *ops[1:],
                            impl="window")
    return TS.stem_pool(frames.to(BF), ops[0].float(), *ops[1:],
                        impl="window")


@pytest.mark.parametrize("case", ["flash float16", "flash mixed",
                                  "stem float16", "stem mixed"])
def test_wrappers_refuse_other_dtypes(case):
    """The flash attention and stem wrappers take float32 or bf16 operands
    of one dtype; anything else raises, on the CPU as on the card."""
    with pytest.raises(TypeError, match="float32 or bfloat16|must be|share"):
        _dtype_case(case)


def test_bf16_on_the_card_refuses_a_t_bucket_past_512(monkeypatch):
    """A bf16 pre-norm stack at T 1024 (past the fused gate's 512) through
    the card's routing (driven on the CPU through `_on_card`) no longer
    refuses: each layer's attention goes through `flash_attention_diff` in
    bf16. Held against the JAX package's `encoder_stack` in bf16 on its
    flash kernel (interpreted): a layer's attention within MAX_ULPS, the
    stack at KERNEL_COS. The stack is not held in ulps: the port's bf16
    LayerNorm rounds once, as the Pallas kernels' `_ln_f32`, where XLA's
    bf16 LayerNorm rounds at its own sites (3 ulps apart on one LayerNorm
    here), and two stacks that differ at one rounding site drift 7-8 ulps
    apart over 1024 keys and two layers (the JAX stack on its flash kernel
    against the same stack dense does too)."""
    from jegal_tpu.core import layers as JL
    from jegal_tpu.core import transformer as JT

    d, heads, t = 128, 2, 1024
    layers = _layers(67, 2, d, 256)
    rng = np.random.default_rng(71)
    norm = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    x = rng.standard_normal((1, t, d)).astype(np.float32)
    mask = np.ones((1, 1, t), np.float32)
    mask[..., 1000:] = 0.0
    jstack = _jax_bf16({"layers": layers, "norm": norm})
    jx = jnp.asarray(x, jnp.bfloat16)
    h = JL.ref_layer_norm(jstack["layers"][0]["norm1"], jx)
    JT.set_attention_impl("flash")
    try:
        want = JT.encoder_stack(jstack, jx, jnp.asarray(mask), heads)
        want_attn = JT.multi_head_attention(jstack["layers"][0]["attn"], h,
                                            h, h, jnp.asarray(mask), heads)
    finally:
        JT.set_attention_impl("auto")
    seen = []
    real = FA.flash_attention_diff

    def count_flash(q, k, v, m=None):
        seen.append((tuple(q.shape), q.dtype))
        return real(q, k, v, m)

    monkeypatch.setattr(TT, "_on_card", lambda t_: True)
    monkeypatch.setattr(FA, "flash_attention_diff", count_flash)
    tstack = _torch_bf16({"layers": layers, "norm": norm})
    th = torch.from_numpy(np.array(_f32(h))).to(BF)
    with torch.no_grad():
        got = TT.encoder_stack(tstack, torch.from_numpy(x).to(BF),
                               torch.from_numpy(mask), heads)
        assert seen == [((1, heads, t, d // heads), BF)] * 2
        got_attn = TT.multi_head_attention(tstack["layers"][0]["attn"], th,
                                           th, th, torch.from_numpy(mask),
                                           heads)
    assert len(seen) == 3
    assert got.dtype == got_attn.dtype == BF
    bars.check_kernel_bar(_f32(got_attn), _f32(want_attn),
                          "bf16 attention at T 1024")
    assert min_row_cos(got, want) >= KERNEL_COS


@pytest.fixture(scope="module")
def ckpt_files(weights, tmp_path_factory):
    from jegal_torch.convert import checkpoints as TCK

    d = tmp_path_factory.mktemp("bf16_ckpts")
    jp, gp, rp = weights
    paths = {k: str(d / f"{k}.npz") for k in ("jegal", "gestsync", "roberta")}
    TCK.save_npz(jegal_params_from_jax(jp), paths["jegal"])
    TCK.save_npz(gestsync_params_from_jax(gp), paths["gestsync"])
    TCK.save_roberta_npz(roberta_params_from_jax(rp), paths["roberta"],
                         num_heads=8)
    return paths


def test_cli_infer_bf16(ckpt_files, weights, sample, tmp_path):
    """`infer --bf16` on the CPU writes the rows of a bf16 engine's
    `extract`, float32 and unit-norm."""
    import pickle

    from jegal_torch.cli import main as TCLI
    from jegal_torch.host.media import write_wav

    tok = str(tmp_path / "tokenizer.json")
    make_tiny_tokenizer().save(tok)
    txt = tmp_path / "clip.txt"
    txt.write_text("\n".join(
        ["Text: hello world abc", "Lang: en", "", "WORD, START, END, SCORE",
         "hello, 0.0, 0.1, 0.9", "world, 0.12, 0.2, 0.9",
         "abc, 0.22, 0.3, 0.9"]) + "\n")
    wav = str(tmp_path / "clip.wav")
    write_wav(wav, sample["wav"], 16000)
    args = ["infer", "--checkpoint_path_jegal", ckpt_files["jegal"],
            "--roberta_path", ckpt_files["roberta"], "--tokenizer_path", tok,
            "--modalities", "ta", "--text_path", str(txt), "--audio_path", wav,
            "--device", "cpu", "--res_dir"]
    TCLI.main(args + [str(tmp_path / "bf16"), "--bf16"])
    TCLI.main(args + [str(tmp_path / "f32")])
    with open(tmp_path / "bf16" / "clip.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "f32" / "clip.pkl", "rb") as f:
        f32 = pickle.load(f)
    emb = got["content_emb"]
    assert emb.dtype == np.float32 and emb.shape == (3, 512)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-6)
    assert min_row_cos(emb, f32["content_emb"]) >= F32_COS
    assert not np.array_equal(emb, f32["content_emb"])


def test_cli_serve_bf16(ckpt_files, weights, monkeypatch):
    """`serve --bf16` in-process on the CPU: the server's engine is bf16,
    and a binary `v` request's answer (float32 on the wire) equals the
    bf16 engine's `extract` of the same features."""
    import threading
    import time
    import urllib.request

    from jegal_torch import serving as TSV
    from jegal_torch.cli import main as TCLI

    made = []
    real = TSV.create_server

    def create(engine, *a, **kw):
        made.append(real(engine, *a, **kw))
        return made[-1]

    monkeypatch.setattr(TSV, "create_server", create)
    t = threading.Thread(target=TCLI.main, daemon=True, args=([
        "serve", "--checkpoint_path", ckpt_files["jegal"], "--bf16",
        "--device", "cpu", "--port", "0"],))
    t.start()
    for _ in range(600):
        if made:
            break
        time.sleep(0.05)
    server = made[0]
    try:
        feats = np.random.default_rng(5).standard_normal(
            (17, 1024)).astype(np.float32)
        meta = {"modalities": "v", "fname": "vf"}
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/extract",
            data=TSV.encode_binary(meta, {"visual_feats": feats}),
            headers={"Content-Type": TSV.BINARY_CONTENT_TYPE,
                     "Accept": TSV.BINARY_CONTENT_TYPE})
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 200
            _, arrays = TSV.decode_binary(resp.read())
    finally:
        server.shutdown()
        t.join(timeout=30)
        server.server_close()
    got = arrays["gesture_emb"]
    assert got.dtype == np.float32 and got.shape == (17, 512)
    want = _port_engine(weights, BF).extract(modalities="v",
                                             visual_feats=feats)
    np.testing.assert_array_equal(got, want["gesture_emb"])
