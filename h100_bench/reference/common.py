"""Layers of the plain references, written from the reference models'
equations (Sindhu-Hegde/jegal models/modules.py, models/gestsync.py,
models/jegal.py; HF XLMRobertaModel) on the parameter layout of
`jegal_torch.convert` (linear kernels (in, out), conv kernels DHWIO /
HWIO). One clip at a time at its natural length: no bucket padding, no
masks, no batching, no fused operands.

`precision(tf32)` is the context every reference call runs in: TF32 off
for matmuls and cuDNN convolutions (true float32), or on for the control,
the same reference one precision step lower."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(tf32: bool = False):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def linear(p, x):
    return x @ p["kernel"] + p["bias"]


def mlp2(ps, x):
    return linear(ps[1], torch.relu(linear(ps[0], x)))


def std_layer_norm(p, x, eps: float = 1e-5):
    """torch nn.LayerNorm."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def ref_layer_norm(p, x, eps: float = 1e-6):
    """The JEGAL encoders' LayerNorm (models/modules.py): the Bessel
    standard deviation, divided by std + eps."""
    mean = x.mean(-1, keepdim=True)
    std = x.std(-1, keepdim=True, unbiased=True)
    return p["scale"] * (x - mean) / (std + eps) + p["bias"]


def batch_norm(p, x, eps: float = 1e-5):
    """Inference BatchNorm over axis 1."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - p["mean"].reshape(shape))
            / torch.sqrt(p["var"].reshape(shape) + eps)
            * p["scale"].reshape(shape) + p["bias"].reshape(shape))


def attention(p, x, heads: int):
    """Self-attention over (N, T, d), no mask, and its output product."""
    n, t, d = x.shape
    dk = d // heads

    def split(y):
        return y.reshape(n, t, heads, dk).transpose(1, 2)

    q, k, v = (split(linear(p[name], x)) for name in ("q", "k", "v"))
    w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dk), dim=-1)
    return linear(p["o"], (w @ v).transpose(1, 2).reshape(n, t, d))


def post_norm_layer(p, x, heads: int):
    """torch nn.TransformerEncoderLayer (post-norm, ReLU, eps 1e-5)."""
    x = std_layer_norm(p["norm1"], x + attention(p["attn"], x, heads))
    ff = linear(p["ff"]["w2"], torch.relu(linear(p["ff"]["w1"], x)))
    return std_layer_norm(p["norm2"], x + ff)


def pre_norm_stack(p, x, heads: int):
    """The JEGAL encoder (models/modules.py): pre-norm layers with the
    reference LayerNorm, then a final one."""
    for layer in p["layers"]:
        x = x + attention(layer["attn"], ref_layer_norm(layer["norm1"], x),
                          heads)
        h = ref_layer_norm(layer["norm2"], x)
        x = x + linear(layer["ff"]["w2"], torch.relu(
            linear(layer["ff"]["w1"], h)))
    return ref_layer_norm(p["norm"], x)


def sinusoid(rows: int, d: int, device) -> torch.Tensor:
    """The sinusoidal position table (models/modules.py
    PositionalEncoding), worked out in float64, returned in float32."""
    pos = torch.arange(rows, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(rows, d, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(torch.float32)


def conv3d(p, x, stride, padding):
    """x (N, C, D, H, W); kernel DHWIO."""
    return F.conv3d(x, p["kernel"].permute(4, 3, 0, 1, 2), p["bias"],
                    stride=tuple(stride), padding=tuple(padding))


def conv2d(p, x, stride, padding):
    """x (N, C, H, W); kernel HWIO."""
    return F.conv2d(x, p["kernel"].permute(3, 2, 0, 1), p["bias"],
                    stride=tuple(stride), padding=tuple(padding))


def unit_rows(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)
