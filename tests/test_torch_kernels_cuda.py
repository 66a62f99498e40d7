"""The port's CUDA kernels against their plain twins on the card, at shapes
the main path does not reach: ragged and long segments (several key tiles
of the online softmax), a fully masked sequence, head width 96, the GELU
activation, small stem geometries with a ragged pooled edge for both stem
kernels (window and band) on both entries (float and planar frames) and
the main path's, block 2 small and at the main path's shape, and the
encoder-stack kernel over 1 and 12 layers in both norm placements; the
sublayer and stack kernels at the main paths' small row counts (32, 128,
256) and ragged ones (1, 21, 33), on every tile of the shared GEMM, and
twice over with identical bits (the split-K sums run in a fixed order); the
attention core's packed and streamed schedules (seg 1 to 512, n 1, 2 and
4 at seg 21) at head widths 64 and 96 on split and unsplit QKV plans,
relaunched with identical bits, and each schedule without spills; the
flash attention kernel at the training and long-clip shapes, forward and
backward, and at ragged T (under one key tile, ragged last tiles) with
and without a mask; block 2 at ragged M (under one tile, tiles across
frames); both relaunched with identical bits; the window stem's two
entries relaunched with identical bits and on all-0 and all-255 pixels,
and its block without spills; the band stem's two entries at t_in = 5 and
J = 1, over ragged strips and frame groups, on planar widths that take
plain loads, on all-0 and all-255 pixels, relaunched with identical bits,
and its block without spills; the bf16 variants of every kernel, the
window stem's (1b) and the flash attention's (6b, with a misaligned
operand refused) among them, against their twins at the bars of
tests/bf16_bars.py, 2b, 6b and 7b also within KERNEL_COS of the float32
kernel, 2b over more units than SMs, 6b at the long clip relaunched with
identical bits, 7b over more tiles than SMs with a ragged last tile, and
all three without spills; 1b equal to 2b bit for bit on both entries,
its persistent grid (fewer units than SMs, and the real clip's 10,360
units) read from the profiler's trace, a relaunch after a launch of
another shape, and one block an SM; the bf16 stack at R 32 to 1024 (packed and
streamed attention, both norm placements) and captured into a graph; the
wrappers' refusals, a
misaligned flash operand and a gradient through a kernel that has
no backward among them; and the encoders' refusal of an input no kernel
takes; and the engine's CUDA graphs: a replay against an eager run of
its forward bit for bit (a raw and a planar clip, a batched chunk, the
two-stage forward), pipelined chunks of one key and of two against single
clips, the batched tower on clips already on the card against host clips,
a replay that counts no launch, a graph evicted and captured again,
and a capture that raises when a kernel fails inside it. Marked `cuda`:
each test skips without a card.

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerance: abs 1e-4 against the twin, which sums the same float32 products
in cuBLAS's / cuDNN's order (outputs are of order 1-10). A stack's
tolerance is 1e-4 times its largest output magnitude when that exceeds 1:
a pre-norm stack has no norm on its residual stream, which grows with
depth, and the float32 rounding grows with it."""

import numpy as np
import pytest
import torch

from jegal_torch.convert import init_roberta_params, tree_to_torch
from jegal_torch.models import roberta as R
from jegal_torch.ops.kernels import _build
from jegal_torch.ops.kernels import conv2 as C2
from jegal_torch.ops.kernels import flash_attention as FA
from jegal_torch.ops.kernels import fused_layer as FL
from jegal_torch.ops.kernels import gemm_plan as GP
from jegal_torch.ops.kernels import stem as S
from jegal_torch.ops.video import s2d_repack, s2d_unpack

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _weights(d, dff, dev, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    return dict(wqkv=rn(d, 3 * d, scale=d ** -0.5), bqkv=rn(3 * d, scale=0.1),
                wo=rn(d, d, scale=d ** -0.5), bo=rn(d, scale=0.1),
                g1=1 + rn(d, scale=0.1), be1=rn(d, scale=0.1),
                w1=rn(d, dff, scale=d ** -0.5), b1=rn(dff, scale=0.1),
                w2=rn(dff, d, scale=dff ** -0.5), b2=rn(d, scale=0.1),
                g2=1 + rn(d, scale=0.1), be2=rn(d, scale=0.1))


@pytest.mark.parametrize("seg,n,heads,d,prenorm,kind,masked", [
    (21, 7, 8, 512, False, "std", False),     # packed, a ragged last tile
    (300, 2, 8, 512, True, "ref", True),      # streamed
    (33, 3, 8, 768, False, "std", True),      # head width 96
    (1, 5, 8, 512, True, "ref", False),
    (21, 1, 8, 512, False, "std", True),      # one window, QKV split
    (21, 2, 8, 512, True, "ref", True),
    (21, 4, 8, 512, False, "std", False),
    (21, 128, 8, 512, False, "std", False),   # the window head, unsplit
    (64, 2, 8, 512, True, "ref", True),       # one whole 64-row tile
    (65, 2, 8, 512, False, "std", True),      # a 1-key second key tile
    (128, 1, 8, 512, True, "ref", True),      # the gesture encoder, split
    (512, 1, 8, 512, True, "ref", True),
    (32, 1, 8, 768, True, "ref", True),       # the text encoder, split
    (128, 2, 8, 768, False, "std", True),     # head width 96, streamed
])
def test_attn_sublayer(dev, seg, n, heads, d, prenorm, kind, masked):
    """The attention core's packed (seg <= 64) and streamed schedules at
    head widths 64 and 96, on split and unsplit QKV plans, relaunched
    with identical bits."""
    w = _weights(d, 4 * d, dev)
    x = torch.randn(n * seg, d, device=dev)
    km = None
    if masked:
        km = (torch.rand(n * seg, device=dev) > 0.4).float()
        if n > 1:
            km[:seg] = 0.0                    # one fully masked segment
    _build.reset_launches()
    got = FL.attn_sublayer(x, w, seg, heads, prenorm=prenorm, ln_kind=kind,
                           kmask=km)
    want = FL.attn_sublayer_plain(x, w, seg, heads, prenorm=prenorm,
                                  ln_kind=kind, kmask=km)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["attn_sublayer"] == 1
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert torch.equal(got, FL.attn_sublayer(x, w, seg, heads,
                                             prenorm=prenorm, ln_kind=kind,
                                             kmask=km))


@pytest.mark.parametrize("dk", FL.HEAD_DIMS)
@pytest.mark.parametrize("packed", [True, False])
def test_attention_core_fits_an_sm_without_spills(dev, dk, packed):
    """Each schedule of the attention core fits an SM without spilling
    registers."""
    info = FL.attention_info(dk, packed)
    assert info["spill_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1, info


@pytest.mark.parametrize("rows,d,dff,prenorm,kind,act", [
    (2688, 512, 2048, False, "std", "relu"),
    (77, 512, 2048, True, "ref", "relu"),
    (130, 768, 3072, False, "std", "gelu"),
    (32, 768, 3072, True, "ref", "gelu"),      # the text encoder's FFN
    (32, 768, 3072, False, "std", "gelu"),     # split-K + fused post-LN
    (128, 512, 2048, True, "ref", "relu"),     # the gesture encoder's FFN
    (1, 512, 2048, False, "std", "relu"),
    (21, 768, 3072, False, "ref", "gelu"),
    (33, 512, 2048, True, "std", "relu"),
])
def test_ffn_sublayer(dev, rows, d, dff, prenorm, kind, act):
    w = _weights(d, dff, dev, seed=1)
    x = torch.randn(rows, d, device=dev)
    got = FL.ffn_sublayer(x, w, prenorm=prenorm, ln_kind=kind, activation=act)
    want = FL.ffn_sublayer_plain(x, w, prenorm=prenorm, ln_kind=kind,
                                 activation=act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def _stacked(n_layers, d, dff, dev):
    per_layer = [_weights(d, dff, dev, seed=10 + i) for i in range(n_layers)]
    return {k: torch.stack([w[k] for w in per_layer]).contiguous()
            for k in FL.STACK_KEYS}


@pytest.mark.parametrize("n_layers,seg,n,heads,prenorm,kind,act,masked", [
    (12, 32, 1, 12, False, "std", "gelu", True),   # XLM-R, one 32-token text
    (12, 128, 2, 12, False, "std", "gelu", True),
    (1, 77, 3, 8, True, "ref", "relu", True),       # head width 96
    (12, 32, 2, 8, True, "ref", "relu", False),
    (1, 21, 4, 12, False, "ref", "relu", False),
    (12, 50, 2, 8, False, "std", "gelu", True),
    (12, 32, 8, 12, False, "std", "gelu", True),   # XLM-R, a training step
    (2, 1, 1, 12, False, "std", "gelu", False),     # ragged R = 1, 21, 33
    (2, 21, 1, 12, False, "std", "gelu", True),
    (2, 33, 1, 8, True, "ref", "relu", True),
    (2, 21, 2, 12, False, "std", "gelu", True),    # packed, n 2 and 4
    (2, 21, 4, 12, False, "std", "gelu", False),
    (2, 64, 2, 12, False, "std", "gelu", True),
    (2, 65, 2, 12, False, "std", "gelu", True),     # streamed
    (2, 128, 1, 8, True, "ref", "relu", True),      # head width 96
    (1, 512, 1, 12, False, "std", "gelu", True),
])
def test_encoder_stack(dev, n_layers, seg, n, heads, prenorm, kind, act,
                       masked):
    d, dff = 768, 3072
    w = _stacked(n_layers, d, dff, dev)
    x = torch.randn(n * seg, d, device=dev)
    km = None
    if masked:
        km = torch.ones(n * seg, device=dev)
        km[seg - seg // 3:seg] = 0.0            # a pad tail in segment 0
        if n > 1:
            km[seg:2 * seg] = 0.0               # a fully masked segment
    _build.reset_launches()
    got = FL.encoder_stack(x, w, seg, heads, prenorm=prenorm, ln_kind=kind,
                           activation=act, kmask=km)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(
        {k: 0 for k in _build.LAUNCHES}, encoder_stack=1)
    want = FL.encoder_stack_plain(x, w, seg, heads, prenorm=prenorm,
                                  ln_kind=kind, activation=act, kmask=km)
    atol = ATOL * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_split_k_is_deterministic(dev):
    """Two launches of the sublayer and stack kernels give identical bits:
    the split-K partials are summed in a fixed order, without atomics."""
    x = torch.randn(32, 768, device=dev)
    w = _weights(768, 3072, dev, seed=1)
    stacked = _stacked(2, 768, 3072, dev)
    km = torch.ones(32, device=dev)
    km[21:] = 0.0
    assert GP.plan(32, 768, 3072, GP.sm_count(dev))[2] > 1
    for run in (
            lambda: FL.ffn_sublayer(x, w, prenorm=False, ln_kind="std",
                                    activation="gelu"),
            lambda: FL.attn_sublayer(x, w, 32, 8, prenorm=False,
                                     ln_kind="std", kmask=km),
            lambda: FL.encoder_stack(x, stacked, 32, 12, prenorm=False,
                                     ln_kind="std", activation="gelu",
                                     kmask=km)):
        a, b = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", sorted(GP.TILES))
@pytest.mark.parametrize("splits", [1, 3])
def test_every_tile(dev, monkeypatch, tile, splits):
    """Each built tile pair of the shared GEMM, unsplit and split, under
    the FFN kernel (both products, ragged rows and a fused post-LN)."""
    monkeypatch.setattr(GP, "plan", lambda m, n, k, sms: (*tile, splits))
    w = _weights(512, 2048, dev, seed=2)
    for rows, prenorm in ((77, False), (200, True)):
        x = torch.randn(rows, 512, device=dev)
        got = FL.ffn_sublayer(x, w, prenorm=prenorm, ln_kind="std",
                              activation="gelu")
        want = FL.ffn_sublayer_plain(x, w, prenorm=prenorm, ln_kind="std",
                                     activation="gelu")
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_unbuilt_tile_raises(dev, monkeypatch):
    """A plan the C code has no instance for is refused, never run on
    another tile."""
    monkeypatch.setattr(GP, "plan", lambda m, n, k, sms: (16, 64, 1))
    w = _weights(512, 2048, dev)
    with pytest.raises(RuntimeError, match="shape not supported"):
        FL.ffn_sublayer(torch.randn(8, 512, device=dev), w, prenorm=False,
                        ln_kind="std")


def test_roberta_on_the_card_runs_the_stack_kernel(dev):
    """roberta.forward on CUDA is one encoder_stack launch and matches the
    plain loop on the CPU on the valid rows; configurations the kernel
    cannot take raise instead of running the loop."""
    cfg = R.RobertaConfig(vocab_size=300, hidden_size=768, num_layers=2,
                          num_heads=12, intermediate_size=3072,
                          max_position_embeddings=64)
    params = init_roberta_params(torch.Generator().manual_seed(3), cfg)
    ids = torch.randint(3, 300, (2, 16), generator=torch.Generator()
                        .manual_seed(4))
    ids[1, 11:] = R.PAD_TOKEN_ID
    mask = (ids != R.PAD_TOKEN_ID).long()
    want = R.forward(params, ids, mask, cfg)
    on_card = R.stack_layers(tree_to_torch(params, dev))
    _build.reset_launches()
    got = R.forward(on_card, ids.to(dev), mask.to(dev), cfg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["encoder_stack"] == 1
    valid = mask.bool()
    torch.testing.assert_close(got.cpu()[valid], want[valid], rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="head widths"):
        R.forward(on_card, ids.to(dev), mask.to(dev),
                  R.RobertaConfig(**dict(vars(cfg), num_heads=24)))
    with pytest.raises(ValueError, match="eps"):
        R.forward(on_card, ids.to(dev), mask.to(dev),
                  R.RobertaConfig(**dict(vars(cfg), layer_norm_eps=1e-12)))


@pytest.mark.parametrize("shape", [(13, 54, 96, 3), (6, 61, 110, 3)])
def test_stem_pool(dev, shape):
    g = torch.Generator().manual_seed(2)
    frames = torch.rand(*shape, generator=g).to(dev)
    w = (torch.randn(5, 7, 7, 3, 64, generator=g) * 0.05).to(dev)
    scale = (torch.rand(64, generator=g) + 0.5).to(dev)
    bias = (torch.randn(64, generator=g) * 0.1).to(dev)
    got = S.stem_pool(frames, w, scale, bias)
    want = S.stem_pool_plain(frames, w, scale, bias)
    torch.cuda.synchronize()
    assert got.shape == S.pooled_shape(*shape[:3])
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def _stem_weights(dev, seed=2):
    g = torch.Generator().manual_seed(seed)
    return ((torch.randn(5, 7, 7, 3, 64, generator=g) * 0.05).to(dev),
            (torch.rand(64, generator=g) + 0.5).to(dev),
            (torch.randn(64, generator=g) * 0.1).to(dev))


@pytest.mark.parametrize("impl", ["window", "band"])
@pytest.mark.parametrize("t4,h,w", [(13, 54, 96), (8, 45, 60),
                                    (152, 270, 480)])
def test_stem_entries(dev, impl, t4, h, w):
    """Each stem kernel on masked float frames and on the same frames
    repacked to planar uint8, against the twins; the float and planar
    results agree (the /255 sits on another side of the products)."""
    g = torch.Generator().manual_seed(3)
    u8 = torch.randint(0, 256, (t4, h, w, 3), generator=g, dtype=torch.uint8)
    cut = torch.randint(0, h // 2, (t4,), generator=g)
    planar = torch.from_numpy(s2d_repack(u8.numpy(), cut.numpy())).to(dev)
    frames = s2d_unpack(planar).float() / 255.0
    ops = _stem_weights(dev)
    _build.reset_launches()
    got_f = S.stem_pool(frames, *ops, impl=impl)
    got_p = S.stem_pool_planar(planar, *ops, impl=impl)
    torch.cuda.synchronize()
    want = (dict(stem_pool=1, stem_pool_planar=1) if impl == "window"
            else dict(stem_band=2))
    assert _build.LAUNCHES == dict({k: 0 for k in _build.LAUNCHES}, **want)
    assert got_f.shape == got_p.shape == S.pooled_shape(t4, h, w)
    torch.testing.assert_close(got_f, S.stem_pool_plain(frames, *ops),
                               rtol=0, atol=ATOL)
    torch.testing.assert_close(got_p, S.stem_pool_planar_plain(planar, *ops),
                               rtol=0, atol=ATOL)
    torch.testing.assert_close(got_p, got_f, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fill", [0, 255, None])
def test_stem_window_relaunch_and_extreme_pixels(dev, fill):
    """The window stem's two entries on frames of all 0, all 255 and
    random bytes: planar against float frames and both against their
    twins, and two launches of each entry bit-identical."""
    t4, h, w = 9, 57, 102
    if fill is None:
        u8 = torch.randint(0, 256, (t4, h, w, 3),
                           generator=torch.Generator().manual_seed(5),
                           dtype=torch.uint8)
    else:
        u8 = torch.full((t4, h, w, 3), fill, dtype=torch.uint8)
    planar = torch.from_numpy(s2d_repack(u8.numpy())).to(dev)
    frames = u8.to(dev).float() / 255.0
    ops = _stem_weights(dev, seed=6)
    got_f = S.stem_pool(frames, *ops, impl="window")
    got_p = S.stem_pool_planar(planar, *ops, impl="window")
    torch.cuda.synchronize()
    torch.testing.assert_close(got_f, S.stem_pool_plain(frames, *ops),
                               rtol=0, atol=ATOL)
    torch.testing.assert_close(got_p, S.stem_pool_planar_plain(planar, *ops),
                               rtol=0, atol=ATOL)
    torch.testing.assert_close(got_p, got_f, rtol=0, atol=ATOL)
    assert torch.equal(S.stem_pool(frames, *ops, impl="window"), got_f)
    assert torch.equal(S.stem_pool_planar(planar, *ops, impl="window"),
                       got_p)


@pytest.mark.parametrize("planar", [False, True])
def test_stem_window_fits_an_sm_without_spills(dev, planar):
    """The design's block fits an SM without spilling registers."""
    info = S.kernel_info(planar, impl="window")
    assert info["spill_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1, info



@pytest.mark.parametrize("t4,h,w", [(5, 15, 60), (13, 30, 111), (9, 57, 150),
                                    (12, 45, 96)])
@pytest.mark.parametrize("fill", [0, 255, None])
def test_stem_band_shapes_relaunch_and_extreme_pixels(dev, t4, h, w, fill):
    """The band stem's two entries at t_in = 5 and J = 1, over ragged
    strips and frame groups, on planar widths W3 of 20, 37 and 50 (not a
    multiple of 16: plain loads) and 32 (cp.async), on frames of all 0, all
    255 (1.0) and random bytes: planar against float frames and both
    against their twins, and two launches of each entry bit-identical."""
    if fill is None:
        u8 = torch.randint(0, 256, (t4, h, w, 3),
                           generator=torch.Generator().manual_seed(7),
                           dtype=torch.uint8)
    else:
        u8 = torch.full((t4, h, w, 3), fill, dtype=torch.uint8)
    planar = torch.from_numpy(s2d_repack(u8.numpy())).to(dev)
    frames = u8.to(dev).float() / 255.0
    ops = _stem_weights(dev, seed=8)
    got_f = S.stem_pool(frames, *ops, impl="band")
    got_p = S.stem_pool_planar(planar, *ops, impl="band")
    torch.cuda.synchronize()
    assert got_f.shape == S.pooled_shape(t4, h, w)
    torch.testing.assert_close(got_f, S.stem_pool_plain(frames, *ops),
                               rtol=0, atol=ATOL)
    torch.testing.assert_close(got_p, S.stem_pool_planar_plain(planar, *ops),
                               rtol=0, atol=ATOL)
    torch.testing.assert_close(got_p, got_f, rtol=0, atol=ATOL)
    assert torch.equal(S.stem_pool(frames, *ops, impl="band"), got_f)
    assert torch.equal(S.stem_pool_planar(planar, *ops, impl="band"), got_p)


@pytest.mark.parametrize("planar", [False, True])
def test_stem_band_fits_an_sm_without_spills(dev, planar):
    """The band design's block fits an SM without spilling registers."""
    info = S.kernel_info(planar, impl="band")
    assert info["spill_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1, info


@pytest.mark.parametrize("t,n_j,w_pool", [(3, 5, 5), (10, 11, 14),
                                          (148, 43, 78), (7, 9, 16),
                                          (5, 13, 21)])
def test_conv2(dev, t, n_j, w_pool):
    """Ragged M: under one 128-position tile (3 and 126 positions) and
    tiles that straddle frames (20, 45 and 740 positions a frame); one
    launch counted, and a second launch bit-identical."""
    g = torch.Generator().manual_seed(4)
    x = torch.rand(t, n_j, w_pool, 64, generator=g).to(dev)
    weight = (torch.randn(5, 5, 64, 128, generator=g) * 0.03).to(dev)
    scale = (torch.rand(128, generator=g) + 0.5).to(dev)
    bias = (torch.randn(128, generator=g) * 0.1).to(dev)
    _build.reset_launches()
    got = C2.conv2_bn_relu(x, weight, scale, bias)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict({k: 0 for k in _build.LAUNCHES}, conv2=1)
    assert tuple(got.shape) == C2.out_shape(t, n_j, w_pool)
    assert got.permute(0, 3, 1, 2).is_contiguous()      # NCHW underneath
    torch.testing.assert_close(got, C2.conv2_bn_relu_plain(x, weight, scale,
                                                           bias),
                               rtol=0, atol=ATOL)
    assert torch.equal(C2.conv2_bn_relu(x, weight, scale, bias), got)


def test_wrappers_refuse(dev):
    w = _weights(512, 2048, dev)
    x = torch.randn(42, 512, device=dev)
    with pytest.raises(TypeError, match="float32"):
        FL.ffn_sublayer(x.half(), w, prenorm=False, ln_kind="std")
    with pytest.raises(ValueError, match="contiguous"):
        FL.ffn_sublayer(torch.randn(512, 42, device=dev).t(), w,
                        prenorm=False, ln_kind="std")
    with pytest.raises(ValueError, match="segments"):
        FL.attn_sublayer(x, w, 20, 8, prenorm=False, ln_kind="std")
    with pytest.raises(ValueError, match="head widths"):
        FL.attn_sublayer(x, w, 21, 4, prenorm=False, ln_kind="std")
    stacked = {k: v[None] for k, v in w.items()}
    with pytest.raises(ValueError, match="shape"):
        FL.encoder_stack(x, dict(stacked, w2=w["w2"]), 21, 8, prenorm=False,
                         ln_kind="std")
    with pytest.raises(ValueError, match="is on"):
        FL.ffn_sublayer(x, dict(w, w1=w["w1"].cpu()), prenorm=False,
                        ln_kind="std")
    ops = _stem_weights(dev)
    with pytest.raises(TypeError, match="float32"):
        S.stem_pool(torch.rand(9, 54, 96, 3, device=dev).double(), *ops)
    with pytest.raises(TypeError, match="uint8"):
        S.stem_pool_planar(torch.zeros(9, 18, 27, 32, device=dev), *ops)
    with pytest.raises(ValueError, match="planar frames must be"):
        S.stem_pool_planar(torch.zeros(9, 18, 28, 32, dtype=torch.uint8,
                                       device=dev), *ops, impl="band")
    with pytest.raises(ValueError, match="impl"):
        S.stem_pool(torch.rand(9, 54, 96, 3, device=dev), *ops, impl="x")
    c2 = (torch.zeros(5, 5, 64, 128, device=dev), torch.ones(128, device=dev),
          torch.zeros(128, device=dev))
    with pytest.raises(ValueError, match="too small"):
        C2.conv2_bn_relu(torch.rand(4, 4, 9, 64, device=dev), *c2)
    with pytest.raises(TypeError, match="float32"):
        C2.conv2_bn_relu(torch.rand(4, 7, 9, 64, device=dev).double(), *c2)
    with pytest.raises(ValueError, match="shape"):
        C2.conv2_bn_relu(torch.rand(4, 7, 9, 64, device=dev), c2[0][:4],
                         *c2[1:])


def _qkvm(b, h, t, d, dev, seed=0):
    """q, k, v (B, H, T, D) and a (B, T) key mask: a pad tail in every
    row and, in the last batch row when B > 1, every key masked."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g).to(dev) for _ in range(3))
    mask = torch.ones(b, t)
    mask[:, t - t // 4:] = 0.0
    if b > 1:
        mask[-1] = 0.0
    return q, k, v, mask.to(dev)


@pytest.mark.parametrize("shape", [(8, 8, 128, 64), (8, 8, 32, 96),
                                   (1, 8, 1024, 64), (2, 3, 100, 96),
                                   (2, 3, 5, 64), (2, 3, 5, 96),
                                   (2, 3, 100, 64), (2, 3, 1000, 64),
                                   (2, 3, 1000, 96)])
def test_flash_attention(dev, shape):
    """The path's shapes, T under one 32-key tile (5) and ragged last query
    and key tiles (100, 1000), each with a pad tail and, where B > 1, a
    fully masked batch row, which averages V uniformly over its T keys;
    one launch counted; a second launch (on the transposed head views)
    bit-identical; and no mask."""
    q, k, v, mask = _qkvm(*shape, dev)
    _build.reset_launches()
    got = FA.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(
        {k_: 0 for k_ in _build.LAUNCHES}, flash_attention=1)
    want = FA.flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    if shape[0] > 1:
        torch.testing.assert_close(
            got[-1], v[-1].mean(1, keepdim=True).expand_as(v[-1]), rtol=0,
            atol=ATOL)
    # the transposed head views of core/transformer._split_heads
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(FA.flash_attention(qt, k, v, mask), got,
                               rtol=0, atol=0)
    torch.testing.assert_close(FA.flash_attention(q, k, v),
                               FA.flash_attention_plain(q, k, v), rtol=0,
                               atol=ATOL)


def test_flash_attention_refuses_misaligned(dev):
    """A contiguous view that does not start on 16 bytes is refused (the
    kernel copies rows 16 bytes at a time), never run another way."""
    buf = torch.randn(1 + 2 * 8 * 64 * 64, device=dev)
    q = buf[1:].view(2, 8, 64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(q, q, q)


def _grads(fn, q, k, v, mask, g):
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fn(*leaves, mask).backward(g)
    return [x.grad for x in leaves]


@pytest.mark.parametrize("shape", [(8, 8, 128, 64), (8, 8, 32, 96)])
def test_flash_attention_backward(dev, shape):
    """flash_attention_diff (kernel forward, dense backward) against the
    plain twin's own autograd, both on the card, where every row has a
    valid key. A fully masked row is the one place the two differ by
    design: the JAX package's VJP (flash_attention.py:91-107), which the
    port keeps, does not zero the gradient of the -1e9-filled scores, so
    its uniform softmax passes a gradient to q and k, where autograd of
    masked_fill passes none. There the card's backward is held against the
    same VJP on the CPU (which tests/test_torch_flash.py holds against
    jax.vjp)."""
    q, k, v, mask = _qkvm(*shape, dev, seed=1)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)) \
        .to(dev)
    rows = slice(0, shape[0] - 1)          # the rows with a valid key
    got = _grads(FA.flash_attention_diff, q, k, v, mask, g)
    want = _grads(FA.flash_attention_plain, q[rows], k[rows], v[rows],
                  mask[rows], g[rows])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a[rows], b, rtol=0, atol=ATOL)
    on_cpu = FA.flash_attention_bwd(q.cpu(), k.cpu(), v.cpu(), mask.cpu(),
                                    g.cpu())
    for a, b in zip(got, on_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=ATOL)


def test_kernels_without_backward_refuse_gradients(dev):
    """No kernel wrapper returns an output without grad_fn for an operand
    that needs a gradient: each raises, and runs under torch.no_grad()."""
    w = _weights(512, 2048, dev)
    x = torch.randn(42, 512, device=dev, requires_grad=True)
    stacked = {k: v[None].contiguous() for k, v in w.items()}
    frames = torch.rand(9, 54, 96, 3, device=dev, requires_grad=True)
    sw = torch.zeros(5, 7, 7, 3, 64, device=dev)
    sw_grad = sw.clone().requires_grad_(True)
    planar = torch.zeros(9, 18, 27, 32, dtype=torch.uint8, device=dev)
    c2x = torch.rand(4, 7, 9, 64, device=dev, requires_grad=True)
    c2w = torch.zeros(5, 5, 64, 128, device=dev)
    q, k, v, mask = _qkvm(1, 8, 32, 64, dev)
    calls = [
        lambda: FL.attn_sublayer(x, w, 21, 8, prenorm=False, ln_kind="std"),
        lambda: FL.ffn_sublayer(x, w, prenorm=True, ln_kind="ref"),
        lambda: FL.encoder_stack(x, stacked, 21, 8, prenorm=False,
                                 ln_kind="std"),
        lambda: S.stem_pool(frames, sw, torch.ones(64, device=dev),
                            torch.zeros(64, device=dev), impl="window"),
        lambda: FA.flash_attention(q.requires_grad_(True), k, v, mask),
        lambda: S.stem_pool(frames, sw, torch.ones(64, device=dev),
                            torch.zeros(64, device=dev), impl="band"),
        lambda: S.stem_pool_planar(planar, sw_grad, torch.ones(64, device=dev),
                                   torch.zeros(64, device=dev), impl="window"),
        lambda: S.stem_pool_planar(planar, sw_grad, torch.ones(64, device=dev),
                                   torch.zeros(64, device=dev), impl="band"),
        lambda: C2.conv2_bn_relu(c2x, c2w, torch.ones(128, device=dev),
                                 torch.zeros(128, device=dev)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            assert torch.isfinite(call()).all()
    # a weight that needs a gradient is refused as well
    with pytest.raises(RuntimeError, match="no backward"):
        FL.ffn_sublayer(x.detach(), dict(w, w1=w["w1"].requires_grad_(True)),
                        prenorm=False, ln_kind="std")
    with pytest.raises(ValueError, match="head width"):
        FA.flash_attention(*(torch.zeros(1, 2, 16, 32, device=dev)
                             for _ in range(3)))


def test_card_routing_raises_where_no_kernel_takes_the_input(dev):
    """On CUDA tensors the encoders never fall back to the plain attention:
    a mask that is not a key mask, or a length the flash gate refuses,
    raises before any kernel launches."""
    from jegal_torch.convert import init_jegal_params
    from jegal_torch.core import transformer as TT

    enc = init_jegal_params(torch.Generator().manual_seed(5), dev)[
        "encoder_rgb"]
    x = torch.randn(2, 32, 512, device=dev)
    pair = torch.ones(2, 32, 32, device=dev)     # (B, Tq, Tk): no key mask
    calls = [
        lambda: TT.encoder_stack(enc, x, pair, 8),
        lambda: TT.encoder_stack(enc, x, pair, 8, fused=False),
        lambda: TT.encoder_stack(enc, x[:, :21], None, 8, fused=False),
        lambda: TT.torch_encoder_stack(enc, x, pair, 8),
    ]
    for call in calls:
        _build.reset_launches()
        with torch.no_grad(), pytest.raises(ValueError):
            call()
        assert not any(_build.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The engine's CUDA graphs (va: the tower, the gesture encoder, the audio CNN)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from jegal_torch.convert import init_gestsync_params, init_jegal_params

    g = torch.Generator().manual_seed(7)
    return init_jegal_params(g, "cuda"), init_gestsync_params(g, "cuda")


def _graph_engine(graph_weights, **kw):
    from jegal_torch.api import JegalEngine

    jp, gp = graph_weights
    return JegalEngine(jp, gp, **kw)


def _graph_clip(t: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(frames=rng.integers(0, 256, (t, 270, 480, 3), dtype=np.uint8),
                chin_rows=rng.integers(90, 200, t),
                wav=(rng.standard_normal(t * 640) * 1000).astype(np.float32),
                word_boundaries=[["a", 0, t // 3], ["b", t // 3 + 1, t - 1]])


def _last_graph(eng):
    entry = eng._graphs[eng.cached_graphs[-1]]
    assert entry.graph is not None
    return entry


@pytest.mark.parametrize("form", ["raw", "planar", "batched", "two_stage"])
def test_graph_replay_equals_eager(dev, graph_weights, form):
    eng = _graph_engine(graph_weights)
    clip = _graph_clip(20, 1)
    if form == "raw":
        eng.extract("va", **clip)
    elif form == "planar":
        eng.extract("va", frames=s2d_repack(clip["frames"], clip["chin_rows"]),
                    wav=clip["wav"], word_boundaries=clip["word_boundaries"])
    elif form == "batched":
        eng.extract_many([clip, _graph_clip(14, 2)], "va", batch_size=2)
    else:
        feats = np.random.default_rng(3).standard_normal((20, 1024))
        eng.extract("va", visual_feats=feats.astype(np.float32),
                    wav=clip["wav"], word_boundaries=clip["word_boundaries"])
    entry = _last_graph(eng)
    with torch.inference_mode():
        entry.graph.replay()
        replay = entry.out.clone()
        eager = entry.fn(**entry.inputs)
    assert torch.equal(replay, eager)


def test_second_replay_adds_no_launches(dev, graph_weights):
    eng = _graph_engine(graph_weights)
    clip = _graph_clip(20, 4)
    _build.reset_launches()
    first = eng.extract("va", **clip)
    entry = _last_graph(eng)
    want = dict.fromkeys(_build.LAUNCHES, 0)
    want.update(stem_band=1, conv2=1, attn_sublayer=12, ffn_sublayer=12)
    assert entry.launches == want
    # the eager run before the capture, and the capture
    assert _build.LAUNCHES == {k: 2 * n for k, n in want.items()}
    _build.reset_launches()
    second = eng.extract("va", **clip)
    assert not any(_build.LAUNCHES.values())
    for key in ("gesture_emb", "content_emb"):
        np.testing.assert_array_equal(first[key], second[key])


def _close(got, want):
    for key in ("gesture_emb", "content_emb"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4)
        assert (got[key] * want[key]).sum(-1).min() >= 0.99999


def test_pipelined_chunks_match_single_clips(dev, graph_weights):
    """Chunks of one key back to back (T bucket 32, two chunks of 2: the
    second is staged while the first may still upload), then a chunk of
    another key (T bucket 64), each clip against its own `extract`."""
    eng = _graph_engine(graph_weights)
    clips = [_graph_clip(t, 10 + i)
             for i, t in enumerate((20, 24, 28, 30, 40, 50))]
    many = eng.extract_many(clips, "va", batch_size=2)
    assert len(eng.cached_graphs) == 2
    for got, clip in zip(many, clips):
        _close(got, eng.extract("va", **clip))


def test_raw_many_stacks_device_clips_on_the_card(dev, graph_weights):
    """gestsync_features_from_raw_many on clips already on the card (the
    extract-feats driver uploads on its decode threads): raw clips with
    chin rows and planar clips over two T buckets give the host clips'
    features bit for bit; a call mixing the two is refused."""
    eng = _graph_engine(graph_weights)
    clips = [_graph_clip(t, 20 + i) for i, t in enumerate((20, 24, 40))]
    for planar in (False, True):
        host = [(s2d_repack(c["frames"], c["chin_rows"]), None) if planar
                else (c["frames"], c["chin_rows"]) for c in clips]
        on_card = [(torch.from_numpy(f).cuda(), chin) for f, chin in host]
        want = eng.gestsync_features_from_raw_many(host, batch_size=2)
        got = eng.gestsync_features_from_raw_many(on_card, batch_size=2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    from jegal_torch.api import ClientError

    with pytest.raises(ClientError, match="not a mix"):
        eng.gestsync_features_from_raw_many([host[0], on_card[1]])


def test_evicted_graph_is_captured_again(dev, graph_weights):
    eng = _graph_engine(graph_weights, max_cached_graphs=1)
    short, long = _graph_clip(20, 5), _graph_clip(40, 6)
    first = eng.extract("va", **short)
    eng.extract("va", **long)
    assert len(eng._graphs) == 1
    assert dict(eng.cached_graphs[0][1])["frames"][0] == 64
    again = eng.extract("va", **short)
    assert dict(eng.cached_graphs[0][1])["frames"][0] == 32
    for key in ("gesture_emb", "content_emb"):
        np.testing.assert_array_equal(first[key], again[key])


def test_failed_capture_raises(dev, graph_weights, monkeypatch):
    """A kernel wrapper that fails inside the capture makes the call raise
    (nothing runs eagerly in its place) and leaves no graph behind."""
    real = _build.check

    def failing(lib, rc, what):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what} failed on purpose")
        real(lib, rc, what)

    eng = _graph_engine(graph_weights)
    clip = _graph_clip(20, 7)
    monkeypatch.setattr(_build, "check", failing)
    with pytest.raises(RuntimeError, match="on purpose"):
        eng.extract("va", **clip)
    assert not eng.cached_graphs and not eng._graphs
    monkeypatch.undo()
    assert eng.extract("va", **clip)["gesture_emb"].shape == (20, 512)


# ---------------------------------------------------------------------------
# bf16 variants (kernels 2, 3, 4, 5 and 7) against their bf16 twins, at the
# bars of tests/bf16_bars.py: 2 bf16 ulps an element (an element smaller
# than its row's RMS measured at the RMS; 4 for a stack of layers) and a
# min row cosine of 0.9999; each relaunched with identical bits.
# ---------------------------------------------------------------------------

BF = torch.bfloat16


def _bars():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import bf16_bars

    return bf16_bars


def _bf16_weights(d, dff, dev, seed=0):
    w = _weights(d, dff, dev, seed)
    return {k: v.to(BF) if k.startswith("w") else v for k, v in w.items()}


def _check_bf16(got, want, what="", stack=False):
    assert got.dtype == BF and got.shape == want.shape
    bars = _bars()
    bars.check_kernel_bar(got, want, what, bars.STACK_MAX_ULPS if stack
                          else bars.MAX_ULPS)


@pytest.mark.parametrize("seg,n,heads,d,prenorm,kind,masked", [
    (21, 7, 8, 512, False, "std", False),     # packed, a ragged last tile
    (21, 128, 8, 512, False, "std", True),    # the window head, unsplit
    (21, 1, 8, 512, False, "std", True),      # one window, QKV split
    (128, 1, 8, 512, True, "ref", True),      # the gesture encoder, split
    (300, 2, 8, 512, True, "ref", True),      # streamed
    (32, 1, 8, 768, True, "ref", True),       # the text encoder, dk 96
    (65, 2, 8, 768, False, "std", True),
])
def test_attn_sublayer_bf16(dev, seg, n, heads, d, prenorm, kind, masked):
    w = _bf16_weights(d, 4 * d, dev)
    x = torch.randn(n * seg, d, device=dev).to(BF)
    km = None
    if masked:
        km = (torch.rand(n * seg, device=dev) > 0.4).float()
        if n > 1:
            km[:seg] = 0.0
    _build.reset_launches()
    got = FL.attn_sublayer(x, w, seg, heads, prenorm=prenorm, ln_kind=kind,
                           kmask=km)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict({k: 0 for k in _build.LAUNCHES},
                                   attn_sublayer_bf16=1)
    want = FL.attn_sublayer_plain(x, w, seg, heads, prenorm=prenorm,
                                  ln_kind=kind, kmask=km)
    _check_bf16(got, want, "attention sublayer")
    assert torch.equal(got, FL.attn_sublayer(x, w, seg, heads,
                                             prenorm=prenorm, ln_kind=kind,
                                             kmask=km))


@pytest.mark.parametrize("rows,d,dff,prenorm,kind,act", [
    (2688, 512, 2048, False, "std", "relu"),   # the window head
    (128, 512, 2048, True, "ref", "relu"),     # the gesture encoder
    (32, 768, 2048, True, "ref", "relu"),      # the text encoder
    (77, 768, 3072, False, "std", "gelu"),
])
def test_ffn_sublayer_bf16(dev, rows, d, dff, prenorm, kind, act):
    w = _bf16_weights(d, dff, dev)
    x = torch.randn(rows, d, device=dev).to(BF)
    _build.reset_launches()
    got = FL.ffn_sublayer(x, w, prenorm=prenorm, ln_kind=kind,
                          activation=act)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict({k: 0 for k in _build.LAUNCHES},
                                   ffn_sublayer_bf16=1)
    _check_bf16(got, FL.ffn_sublayer_plain(x, w, prenorm=prenorm,
                                           ln_kind=kind, activation=act),
                "FFN sublayer")
    assert torch.equal(got, FL.ffn_sublayer(x, w, prenorm=prenorm,
                                            ln_kind=kind, activation=act))


@pytest.mark.parametrize("n_layers,seg,n,heads,prenorm,kind,act", [
    (12, 32, 1, 12, False, "std", "gelu"),     # XLM-R, one 32-token text
    (12, 32, 4, 12, False, "std", "gelu"),     # XLM-R, an extract_many chunk
    (12, 64, 8, 12, False, "std", "gelu"),     # XLM-R, a served batch
    (2, 32, 4, 12, True, "ref", "gelu"),       # R 128, pre-norm
    (2, 33, 2, 8, True, "ref", "relu"),        # head width 96, pre-norm
    (2, 128, 1, 8, True, "ref", "relu"),       # streamed, head width 96
    (2, 512, 1, 12, False, "std", "gelu"),     # streamed, one 512 segment
    (2, 512, 2, 8, True, "ref", "relu"),       # streamed, head width 96
])
def test_encoder_stack_bf16(dev, n_layers, seg, n, heads, prenorm, kind,
                            act):
    """The bf16 stack kernel against its twin at the stack's bar, one
    launch counted, a relaunch bit-identical: R 32 to 1024, packed and
    streamed attention at head widths 64 and 96, post- and pre-norm."""
    d, dff = 768, 3072
    w = {k: v.to(BF) if k.startswith("w") else v
         for k, v in _stacked(n_layers, d, dff, dev).items()}
    x = torch.randn(n * seg, d, device=dev).to(BF)
    km = torch.ones(n * seg, device=dev)
    km[seg - seg // 3:seg] = 0.0
    _build.reset_launches()
    got = FL.encoder_stack(x, w, seg, heads, prenorm=prenorm, ln_kind=kind,
                           activation=act, kmask=km)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict({k: 0 for k in _build.LAUNCHES},
                                   encoder_stack_bf16=1)
    _check_bf16(got, FL.encoder_stack_plain(x, w, seg, heads,
                                            prenorm=prenorm, ln_kind=kind,
                                            activation=act, kmask=km),
                "encoder stack", stack=True)
    assert torch.equal(got, FL.encoder_stack(x, w, seg, heads,
                                             prenorm=prenorm, ln_kind=kind,
                                             activation=act, kmask=km))


@pytest.mark.parametrize("tile", sorted(GP.TILES_BF16))
@pytest.mark.parametrize("splits", [1, 3])
def test_every_tile_bf16(dev, monkeypatch, tile, splits):
    """Each built tile of the bf16 wgmma product, unsplit and with its K
    slices summed in the kernel, under the bf16 FFN kernel (both
    products): ragged rows (1, 21, 77, 200, 2688), K not a multiple of 64
    (520) and N 512, 520, 768, 1536, 2048 and 3072, a fused post-LN and a
    pre-LN; a second launch bit-identical."""
    monkeypatch.setattr(GP, "plan_bf16",
                        lambda m, n, k, sms: (*tile, splits))
    for rows, d, dff, prenorm in ((1, 512, 1536, False),
                                  (21, 520, 2048, False),
                                  (77, 768, 3072, True),
                                  (200, 512, 2048, True),
                                  (2688, 512, 1536, False)):
        w = _bf16_weights(d, dff, dev, seed=2)
        x = torch.randn(rows, d, device=dev).to(BF)
        got = FL.ffn_sublayer(x, w, prenorm=prenorm, ln_kind="std",
                              activation="gelu")
        want = FL.ffn_sublayer_plain(x, w, prenorm=prenorm, ln_kind="std",
                                     activation="gelu")
        torch.cuda.synchronize()
        _check_bf16(got, want, f"tile {tile} splits {splits} rows {rows}")
        assert torch.equal(got, FL.ffn_sublayer(
            x, w, prenorm=prenorm, ln_kind="std", activation="gelu"))


@pytest.mark.parametrize("rows", [32, 128])
def test_split_k_is_deterministic_bf16(dev, rows):
    """Two launches of the bf16 sublayer and stack kernels at the text
    encoder's 32 rows and an extract_many chunk's 128, where the FFN's W2
    product (K 3072) is split and summed in the product kernel by the last
    slice to finish, give identical bits; both norm placements of the
    stack."""
    x = torch.randn(rows, 768, device=dev).to(BF)
    w = _bf16_weights(768, 3072, dev, seed=1)
    stacked = {k: v.to(BF) if k.startswith("w") else v
               for k, v in _stacked(2, 768, 3072, dev).items()}
    km = torch.ones(rows, device=dev)
    km[21:32] = 0.0
    assert GP.plan_bf16(rows, 768, 3072, GP.sm_count(dev))[2] > 1
    for run in (
            lambda: FL.ffn_sublayer(x, w, prenorm=False, ln_kind="std",
                                    activation="gelu"),
            lambda: FL.attn_sublayer(x, w, 32, 8, prenorm=True,
                                     ln_kind="ref", kmask=km),
            lambda: FL.encoder_stack(x, stacked, 32, 12, prenorm=False,
                                     ln_kind="std", activation="gelu",
                                     kmask=km),
            lambda: FL.encoder_stack(x, stacked, 32, 12, prenorm=True,
                                     ln_kind="ref", activation="gelu",
                                     kmask=km)):
        a, b = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_encoder_stack_bf16_graph_replay(dev):
    """The bf16 stack kernel captured into a CUDA graph: two replays equal
    the eager call bit for bit, and the capture counts one launch."""
    x = torch.randn(32, 768, device=dev).to(BF)
    stacked = {k: v.to(BF) if k.startswith("w") else v
               for k, v in _stacked(12, 768, 3072, dev).items()}
    km = torch.ones(32, device=dev)
    km[21:] = 0.0
    kw = dict(prenorm=False, ln_kind="std", activation="gelu", kmask=km)
    eager = FL.encoder_stack(x, stacked, 32, 12, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        FL.encoder_stack(x, stacked, 32, 12, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    _build.reset_launches()
    with torch.cuda.graph(graph):
        out = FL.encoder_stack(x, stacked, 32, 12, **kw)
    assert _build.LAUNCHES["encoder_stack_bf16"] == 1
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.parametrize("seg", [21, 32, 64, 65, 128, 256, 512])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_core_bf16(dev, seg, masked):
    """The one-walk bf16 attention core through the bf16 attention
    sublayer: packed (seg <= 64) and streamed (a whole segment staged, up
    to 512), two segments, masked with the first segment fully masked (it
    averages its own keys) or unmasked; against the twin at the bf16
    bars, relaunched bit-identical."""
    w = _bf16_weights(512, 2048, dev, seed=5)
    x = torch.randn(2 * seg, 512, device=dev).to(BF)
    km = None
    if masked:
        km = (torch.rand(2 * seg, device=dev) > 0.3).float()
        km[:seg] = 0.0
    got = FL.attn_sublayer(x, w, seg, 8, prenorm=True, ln_kind="ref",
                           kmask=km)
    torch.cuda.synchronize()
    _check_bf16(got, FL.attn_sublayer_plain(x, w, seg, 8, prenorm=True,
                                            ln_kind="ref", kmask=km),
                f"attention seg {seg}")
    assert torch.equal(got, FL.attn_sublayer(x, w, seg, 8, prenorm=True,
                                             ln_kind="ref", kmask=km))


@pytest.mark.parametrize("tile", sorted(GP.TILES_BF16))
def test_gemm_bf16_fits_an_sm_without_spills(dev, tile):
    """Each tile of the bf16 wgmma product fits an SM without spilling
    registers."""
    info = FL.gemm_info_bf16(tile)
    assert info["spill_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1, info


@pytest.mark.parametrize("t,n_j,w_pool", [(3, 5, 5), (10, 11, 14),
                                          (148, 43, 78), (5, 13, 21),
                                          (100, 23, 41)])
def test_conv2_bf16(dev, t, n_j, w_pool):
    """Kernel 7b against its twin at the bars and within KERNEL_COS of the
    float32 kernel on the same values; one launch counted, a relaunch
    bit-identical. (100, 23, 41) is 19,000 positions: more 128-position
    tiles than SMs, so blocks of the persistent grid take a second tile,
    and the last is ragged."""
    g = torch.Generator().manual_seed(4)
    x = torch.rand(t, n_j, w_pool, 64, generator=g).to(dev).to(BF)
    weight = (torch.randn(5, 5, 64, 128, generator=g) * 0.03).to(dev).to(BF)
    scale = (torch.rand(128, generator=g) + 0.5).to(dev)
    bias = (torch.randn(128, generator=g) * 0.1).to(dev)
    _build.reset_launches()
    got = C2.conv2_bn_relu(x, weight, scale, bias)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict({k: 0 for k in _build.LAUNCHES},
                                   conv2_bf16=1)
    assert got.permute(0, 3, 1, 2).is_contiguous()
    _check_bf16(got, C2.conv2_bn_relu_plain(x, weight, scale, bias), "conv2")
    assert torch.equal(got, C2.conv2_bn_relu(x, weight, scale, bias))
    f32 = C2.conv2_bn_relu(x.float(), weight.float(), scale, bias)
    assert _bars().min_row_cos(got, f32) >= _bars().KERNEL_COS


def test_conv2_bf16_fits_an_sm_without_spills(dev):
    """Kernel 7b's block fits an SM without spilling registers."""
    info = C2.kernel_info_bf16()
    assert info["spill_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1, info


@pytest.mark.parametrize("t4,h,w", [(5, 15, 60), (13, 30, 111), (9, 57, 150),
                                    (12, 45, 96), (28, 270, 480),
                                    (60, 120, 303)])
@pytest.mark.parametrize("fill", [0, 255, None])
def test_stem_band_bf16(dev, t4, h, w, fill):
    """Kernel 2b on both entries (bf16 frames; planar bytes with the folded
    bf16 weight), at t_in 5 and J 1, ragged strips, frame widths whose rows
    take plain loads (W * 3 not a multiple of 8; planar W3 not a multiple
    of 16), the real 270x480 frame, and more units than SMs (60, 120,
    303: blocks of the persistent grid take several), on all-0, all-255
    and random bytes: against their twins and within KERNEL_COS of the
    float32 kernel, relaunched bit-identical."""
    if fill is None:
        u8 = torch.randint(0, 256, (t4, h, w, 3),
                           generator=torch.Generator().manual_seed(7),
                           dtype=torch.uint8)
    else:
        u8 = torch.full((t4, h, w, 3), fill, dtype=torch.uint8)
    planar = torch.from_numpy(s2d_repack(u8.numpy())).to(dev)
    frames = (u8.to(dev).float() / 255.0).to(BF)
    wt, scale, bias = _stem_weights(dev, seed=8)
    ops = (wt.to(BF), scale, bias)
    _build.reset_launches()
    got_f = S.stem_pool(frames, *ops)
    got_p = S.stem_pool_planar(planar, *ops)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict({k: 0 for k in _build.LAUNCHES},
                                   stem_band_bf16=2)
    assert got_f.shape == S.pooled_shape(t4, h, w)
    _check_bf16(got_f, S.stem_pool_plain(frames, *ops), "stem float")
    _check_bf16(got_p, S.stem_pool_planar_plain(planar, *ops), "stem planar")
    assert torch.equal(S.stem_pool(frames, *ops), got_f)
    assert torch.equal(S.stem_pool_planar(planar, *ops), got_p)
    if fill is None:
        ops32 = (wt.to(BF).float(), scale, bias)
        bars = _bars()
        assert bars.min_row_cos(got_f, S.stem_pool(frames.float(), *ops32)) \
            >= bars.KERNEL_COS
        assert bars.min_row_cos(got_p, S.stem_pool_planar(planar, *ops32)) \
            >= bars.KERNEL_COS


@pytest.mark.parametrize("planar", [False, True])
def test_stem_band_bf16_fits_an_sm_without_spills(dev, planar):
    info = S.kernel_info(planar, impl="band", bf16=True)
    assert info["spill_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1, info


@pytest.mark.parametrize("dk", FL.HEAD_DIMS)
@pytest.mark.parametrize("packed", [True, False])
def test_attention_core_bf16_fits_an_sm_without_spills(dev, dk, packed):
    info = FL.attention_info(dk, packed, bf16=True)
    assert info["spill_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1, info


def test_bf16_wrappers_refuse(dev):
    """A bf16 weight beside float32 rows, float32 weights beside bf16
    frames (either stem), bf16 segments longer than the bf16 attention
    core stages, float16 frames and mixed q, k, v dtypes raise; nothing is
    cast quietly."""
    w = _weights(512, 2048, dev)
    x = torch.randn(21, 512, device=dev).to(BF)
    with pytest.raises(TypeError, match="bfloat16"):
        FL.ffn_sublayer(x, w, prenorm=False, ln_kind="std")
    ops = _stem_weights(dev)
    for impl in S.IMPLS:
        with pytest.raises(TypeError, match="bfloat16"):
            S.stem_pool(torch.rand(5, 15, 60, 3, device=dev).to(BF), *ops,
                        impl=impl)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            S.stem_pool(torch.rand(5, 15, 60, 3, device=dev).half(),
                        ops[0].half(), *ops[1:], impl=impl)
    xs = torch.randn(2 * 513, 512, device=dev).to(BF)
    with pytest.raises(ValueError, match="bf16 attention core"):
        FL.attn_sublayer(xs, _bf16_weights(512, 2048, dev), 513, 8,
                         prenorm=True, ln_kind="ref")
    q, k, v, _ = _qkvm(1, 2, 64, 64, dev)
    with pytest.raises(TypeError, match="share"):
        FA.flash_attention(q.to(BF), k, v.to(BF))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(q.half(), k.half(), v.half())


@pytest.mark.parametrize("t4,h,w", [(5, 15, 60), (13, 30, 111), (9, 57, 150),
                                    (12, 45, 96), (28, 270, 480)])
@pytest.mark.parametrize("fill", [0, 255, None])
def test_stem_window_bf16(dev, t4, h, w, fill):
    """The window stem's bf16 variant (kernel 1b) on both entries (bf16
    frames; planar bytes with the folded bf16 weight), at t_in 5 and J 1,
    ragged pooled edges, plain-load widths (a frame row of 3 W halves not
    a multiple of 8, planar W/3 not a multiple of 16) and the real 270x480
    frame, on all-0, all-255 and random bytes: against the twins (which
    the band stem's bf16 variant shares), one launch counted per entry,
    and relaunched bit-identical."""
    if fill is None:
        u8 = torch.randint(0, 256, (t4, h, w, 3),
                           generator=torch.Generator().manual_seed(9),
                           dtype=torch.uint8)
    else:
        u8 = torch.full((t4, h, w, 3), fill, dtype=torch.uint8)
    planar = torch.from_numpy(s2d_repack(u8.numpy())).to(dev)
    frames = (u8.to(dev).float() / 255.0).to(BF)
    wt, scale, bias = _stem_weights(dev, seed=10)
    ops = (wt.to(BF), scale, bias)
    _build.reset_launches()
    got_f = S.stem_pool(frames, *ops, impl="window")
    got_p = S.stem_pool_planar(planar, *ops, impl="window")
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict({k: 0 for k in _build.LAUNCHES},
                                   stem_pool_bf16=1, stem_pool_planar_bf16=1)
    assert got_f.shape == got_p.shape == S.pooled_shape(t4, h, w)
    _check_bf16(got_f, S.stem_pool_plain(frames, *ops), "window float")
    _check_bf16(got_p, S.stem_pool_planar_plain(planar, *ops),
                "window planar")
    assert torch.equal(S.stem_pool(frames, *ops, impl="window"), got_f)
    assert torch.equal(S.stem_pool_planar(planar, *ops, impl="window"),
                       got_p)


@pytest.mark.parametrize("planar", [False, True])
def test_stem_window_bf16_fits_an_sm_without_spills(dev, planar):
    info = S.kernel_info(planar, impl="window", bf16=True)
    assert info["spill_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1, info


def _window_bf16_inputs(dev, t4, h, w, fill, seed=9):
    """Bytes of all `fill` (or random), their planar repack and the bf16
    frames, with kernel 1b's bf16 operands."""
    if fill is None:
        u8 = torch.randint(0, 256, (t4, h, w, 3),
                           generator=torch.Generator().manual_seed(seed),
                           dtype=torch.uint8)
    else:
        u8 = torch.full((t4, h, w, 3), fill, dtype=torch.uint8)
    planar = torch.from_numpy(s2d_repack(u8.numpy())).to(dev)
    frames = (u8.to(dev).float() / 255.0).to(BF)
    wt, scale, bias = _stem_weights(dev, seed=10)
    return frames, planar, (wt.to(BF), scale, bias)


@pytest.mark.parametrize("t4,h,w", [(5, 15, 60), (13, 30, 111), (9, 57, 150),
                                    (12, 45, 96), (28, 270, 480)])
@pytest.mark.parametrize("fill", [0, 255, None])
def test_stem_window_bf16_equals_band_bf16(dev, t4, h, w, fill):
    """Kernel 1b gives kernel 2b's bits on both entries: both sum each
    position's bf16 products in the same K order and flush groups and
    pool with the same epilogue arithmetic (csrc/stem.cuh), at
    test_stem_window_bf16's shapes and fills."""
    frames, planar, ops = _window_bf16_inputs(dev, t4, h, w, fill)
    assert torch.equal(S.stem_pool(frames, *ops, impl="window"),
                       S.stem_pool(frames, *ops, impl="band"))
    assert torch.equal(S.stem_pool_planar(planar, *ops, impl="window"),
                       S.stem_pool_planar(planar, *ops, impl="band"))


def _units(t4, h, w):
    """Kernel 1b's units: (column strip, row tile, frame)."""
    t_out, n_j, w_pool, _ = S.pooled_shape(t4, h, w)
    return -(-w_pool // 8) * -(-n_j // 7) * t_out


def _launch_grid(fn, name):
    """The grid of the launch of kernel `name` that fn makes, from the
    profiler's trace; spin kernels first, so that the window's first
    stretch, which the profiler can lose, holds none of fn's work."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                torch.cuda._sleep(2_000_000)
            fn()
            torch.cuda.synchronize()
        with tempfile.NamedTemporaryFile(suffix=".json") as f:
            prof.export_chrome_trace(f.name)
            events = json.load(open(f.name))["traceEvents"]
        grids = [e["args"]["grid"] for e in events
                 if name in e.get("name", "") and "grid" in e.get("args", {})]
        if grids:
            assert len(grids) == 1, grids
            return grids[0]
    raise AssertionError(f"no launch of {name} in three profiles")


@pytest.mark.parametrize("t4,h,w", [(7, 30, 60), (152, 270, 480)])
def test_stem_window_bf16_persistent_grid(dev, t4, h, w):
    """Kernel 1b's persistent grid: min(units, SMs) blocks, at a shape with
    fewer units than SMs (3) and at the real clip's (152, 270, 480, 3),
    whose 10,360 units are not a multiple of the SM count; against the
    twins, 2b's bits on both entries."""
    frames, planar, ops = _window_bf16_inputs(dev, t4, h, w, None, seed=11)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    units = _units(t4, h, w)
    assert units < sms if t4 == 7 else units % sms
    for form, x, run in (
            ("Bf16Frames", frames,
             lambda impl: S.stem_pool(frames, *ops, impl=impl)),
            ("PlanarU8", planar,
             lambda impl: S.stem_pool_planar(planar, *ops, impl=impl))):
        got = run("window")
        twin = (S.stem_pool_plain(frames, *ops) if x is frames
                else S.stem_pool_planar_plain(planar, *ops))
        _check_bf16(got, twin, f"window {form}")
        assert torch.equal(got, run("band"))
        grid = _launch_grid(lambda: run("window"), "stem_pool_bf16_kernel")
        assert grid == [min(units, sms), 1, 1], (grid, units, sms)


def test_stem_window_bf16_relaunch_after_another_shape(dev):
    """Kernel 1b keeps no state from one launch to the next: each entry at
    one shape, then at another (more units, a ragged tile), then at the
    first again, bit-identical to its first launch."""
    small = _window_bf16_inputs(dev, 9, 57, 150, None, seed=12)
    big = _window_bf16_inputs(dev, 40, 270, 480, None, seed=13)
    for planar in (False, True):
        def run(inp):
            frames, pl, ops = inp
            return (S.stem_pool_planar(pl, *ops, impl="window") if planar
                    else S.stem_pool(frames, *ops, impl="window"))
        first = run(small)
        other = run(big)
        assert torch.equal(run(small), first)
        assert torch.equal(run(big), other)


@pytest.mark.parametrize("planar", [False, True])
def test_stem_window_bf16_one_block_an_sm(dev, planar):
    """kernel_info of kernel 1b: no spills, one block an SM (16 warps,
    210.7 KB of shared memory), and a launch at the real clip's shape takes
    a grid no larger than the SM count."""
    info = S.kernel_info(planar, impl="window", bf16=True)
    assert info["spill_bytes"] == 0, info
    assert info["blocks_per_sm"] == 1, info
    frames, pl, ops = _window_bf16_inputs(dev, 152, 270, 480, None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = _launch_grid(
        (lambda: S.stem_pool_planar(pl, *ops, impl="window")) if planar
        else (lambda: S.stem_pool(frames, *ops, impl="window")),
        "stem_pool_bf16_kernel")
    assert grid[0] <= sms and grid[1:] == [1, 1], (grid, sms)


@pytest.mark.parametrize("shape", [(2, 2, 128, 64), (2, 2, 256, 64),
                                   (2, 2, 128, 96), (2, 2, 256, 96),
                                   (1, 8, 1024, 64), (8, 8, 128, 96),
                                   (2, 3, 100, 96), (2, 3, 5, 64),
                                   (2, 3, 1000, 64)])
def test_flash_attention_bf16(dev, shape):
    """The flash kernel's bf16 variant (kernel 6b) at the CPU test's
    shapes, the long clip's, a text shape at D 96 and ragged T, with a pad
    tail in every row and, where B > 1, a fully masked batch row (which
    averages V uniformly), and without a mask: against its twin at the
    bars, one launch counted, a relaunch on the transposed head views
    bit-identical."""
    q, k, v, mask = (x.to(BF) if x.dim() == 4 else x
                     for x in _qkvm(*shape, dev, seed=1))
    _build.reset_launches()
    got = FA.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(
        {k_: 0 for k_ in _build.LAUNCHES}, flash_attention_bf16=1)
    _check_bf16(got, FA.flash_attention_plain(q, k, v, mask), "flash bf16")
    if shape[0] > 1:
        _check_bf16(got[-1], v[-1].float().mean(1, keepdim=True)
                    .expand_as(v[-1]).to(BF), "the fully masked row")
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(FA.flash_attention(qt, k, v, mask), got)
    _check_bf16(FA.flash_attention(q, k, v),
                FA.flash_attention_plain(q, k, v), "flash bf16, no mask")
    f32 = FA.flash_attention(q.float(), k.float(), v.float(), mask)
    assert _bars().min_row_cos(got, f32) >= _bars().KERNEL_COS


def test_flash_attention_bf16_long_clip_relaunch(dev):
    """Kernel 6b at the bf16 long clip's (1, 8, 1024, 64) with its last 24
    keys masked (a 1000-frame clip in the T 1024 bucket): at the bars of
    its twin, and a relaunch bit-identical."""
    q, k, v, _ = (x.to(BF) if x.dim() == 4 else x
                  for x in _qkvm(1, 8, 1024, 64, dev, seed=5))
    mask = torch.ones(1, 1024, device=dev)
    mask[:, 1000:] = 0.0
    got = FA.flash_attention(q, k, v, mask)
    _check_bf16(got, FA.flash_attention_plain(q, k, v, mask), "long clip")
    assert torch.equal(FA.flash_attention(q, k, v, mask), got)


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_flash_attention_bf16_fits_an_sm_without_spills(dev, d):
    """Kernel 6b's block fits an SM without spilling registers."""
    info = FA.kernel_info_bf16(d)
    assert info["spill_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1, info


def test_flash_attention_bf16_refuses_misaligned(dev):
    """A bf16 q, k or v that does not start on 16 bytes is refused, never
    run another way."""
    buf = torch.randn(8 + 2 * 8 * 64 * 64, device=dev).to(BF)
    bad = buf[1:1 + 2 * 8 * 64 * 64].view(2, 8, 64, 64)
    good = buf[8:].view(2, 8, 64, 64)
    _build.reset_launches()
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            FA.flash_attention(*args)
    assert not any(_build.LAUNCHES.values())
