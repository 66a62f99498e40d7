"""The port's CUDA kernels against their plain twins on the card, at shapes
the main path does not reach: ragged and long segments (several key tiles
of the online softmax), a fully masked sequence, head width 96, the GELU
activation, and a small stem geometry with a ragged pooled edge; and the
wrappers' refusals. Marked `cuda`: each test skips without a card.

    python -m pytest tests/test_torch_kernels_cuda.py -q    # on the card

Tolerance: abs 1e-4 against the twin, which sums the same float32 products
in cuBLAS's / cuDNN's order (outputs are of order 1-10)."""

import pytest
import torch

from jegal_torch.ops.kernels import _build
from jegal_torch.ops.kernels import fused_layer as FL
from jegal_torch.ops.kernels import stem as S

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
    (21, 7, 8, 512, False, "std", False),
    (300, 2, 8, 512, True, "ref", True),
    (33, 3, 8, 768, False, "std", True),      # head width 96
    (1, 5, 8, 512, True, "ref", False),
])
def test_attn_sublayer(dev, seg, n, heads, d, prenorm, kind, masked):
    w = _weights(d, 4 * d, dev)
    x = torch.randn(n * seg, d, device=dev)
    km = None
    if masked:
        km = (torch.rand(n * seg, device=dev) > 0.4).float()
        km[:seg] = 0.0                        # one fully masked segment
    _build.reset_launches()
    got = FL.attn_sublayer(x, w, seg, heads, prenorm=prenorm, ln_kind=kind,
                           kmask=km)
    want = FL.attn_sublayer_plain(x, w, seg, heads, prenorm=prenorm,
                                  ln_kind=kind, kmask=km)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["attn_sublayer"] == 1
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("rows,d,dff,prenorm,kind,act", [
    (2688, 512, 2048, False, "std", "relu"),
    (77, 512, 2048, True, "ref", "relu"),
    (130, 768, 3072, False, "std", "gelu"),
])
def test_ffn_sublayer(dev, rows, d, dff, prenorm, kind, act):
    w = _weights(d, dff, dev, seed=1)
    x = torch.randn(rows, d, device=dev)
    got = FL.ffn_sublayer(x, w, prenorm=prenorm, ln_kind=kind, activation=act)
    want = FL.ffn_sublayer_plain(x, w, prenorm=prenorm, ln_kind=kind,
                                 activation=act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


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
    with pytest.raises(ValueError, match="is on"):
        FL.ffn_sublayer(x, dict(w, w1=w["w1"].cpu()), prenorm=False,
                        ln_kind="std")
    with pytest.raises(TypeError, match="float32"):
        S.stem_pool(torch.rand(9, 54, 96, 3, device=dev).double(),
                    torch.zeros(5, 7, 7, 3, 64, device=dev),
                    torch.ones(64, device=dev), torch.zeros(64, device=dev))
