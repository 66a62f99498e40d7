"""NN primitives with the JAX package's layouts and numerics
(jegal_tpu/core/layers.py), on torch tensors.

Parameters are nested dicts of tensors in the JAX layouts, so a tree
converted leaf by leaf from the JAX package computes the same function:

  linear:    {"kernel": (in, out), "bias": (out,)}        y = x @ kernel + bias
  layernorm: {"scale": (d,), "bias": (d,)}
  batchnorm: {"scale", "bias", "mean", "var"}  (inference statistics)
  conv2d:    {"kernel": HWIO, "bias": (O,)}               data NHWC
  conv3d:    {"kernel": DHWIO, "bias": (O,)}              data NDHWC

`ref_layer_norm` is the reference model's own LayerNorm (Bessel std,
divided by std + eps); `std_layer_norm` is torch nn.LayerNorm.

Convolutions run with cuDNN's TF32 mode off: the engine computes in float32
and TF32 keeps about three decimal digits (cudnn.allow_tf32 defaults to
True for convolutions)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def linear(params, x):
    """y = x @ kernel + bias. kernel: (in, out)."""
    y = torch.matmul(x, params["kernel"])
    if params.get("bias") is not None:
        y = y + params["bias"]
    return y


def _in_f32(norm):
    """A LayerNorm computed in float32 on a bf16 input (parameters upcast,
    exact), the result rounded back to bf16 once, as the JAX package's
    kernels do (`_ln_f32`); on float32 it is the plain function."""
    def wrapped(params, x, eps=None):
        kw = {} if eps is None else {"eps": eps}
        if x.dtype == torch.float32:
            return norm(params, x, **kw)
        p32 = {k: v.to(torch.float32) for k, v in params.items()}
        return norm(p32, x.to(torch.float32), **kw).to(x.dtype)

    wrapped.__doc__ = norm.__doc__
    wrapped.__name__ = norm.__name__
    return wrapped


@_in_f32
def ref_layer_norm(params, x, eps: float = 1e-6):
    """(x - mean) / (std_bessel + eps) * scale + bias (reference
    models/modules.py:32-35)."""
    mean = x.mean(dim=-1, keepdim=True)
    cen = x - mean
    var = (cen * cen).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
    return params["scale"] * cen / (torch.sqrt(var) + eps) + params["bias"]


@_in_f32
def std_layer_norm(params, x, eps: float = 1e-5):
    """torch nn.LayerNorm: biased variance, rsqrt(var + eps)."""
    mean = x.mean(dim=-1, keepdim=True)
    cen = x - mean
    var = (cen * cen).mean(dim=-1, keepdim=True)
    return params["scale"] * (cen * torch.rsqrt(var + eps)) + params["bias"]


def batch_norm_inference(params, x, eps: float = 1e-5):
    """Inference BatchNorm over the trailing channel axis."""
    inv = torch.rsqrt(params["var"] + eps) * params["scale"]
    return x * inv + (params["bias"] - params["mean"] * inv)


def batch_norm_nchw(params, x, eps: float = 1e-5):
    """Inference BatchNorm over axis 1 (the tower's channels-first
    layout). On a bf16 input the scale and shift are folded in float32
    and rounded to bf16, and applied as x * scale + shift in bf16, the
    JAX package's `batch_norm_inference` in the engine dtype."""
    if x.dtype != torch.float32:
        p32 = {k: params[k].to(torch.float32)
               for k in ("var", "scale", "bias", "mean")}
        inv = torch.rsqrt(p32["var"] + eps) * p32["scale"]
        shift = (p32["bias"] - p32["mean"] * inv).to(x.dtype)
        inv = inv.to(x.dtype)
    else:
        inv = torch.rsqrt(params["var"] + eps) * params["scale"]
        shift = params["bias"] - params["mean"] * inv
    shape = (-1,) + (1,) * (x.dim() - 2)
    return x * inv.reshape(shape) + shift.reshape(shape)


def _tuple(v, n: int) -> tuple:
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v}")
        return tuple(v)
    return (v,) * n


@contextlib.contextmanager
def f32_convs():
    """Context in which cuDNN convolutions keep full float32 (no TF32)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv2d_nchw(x, kernel_hwio, bias=None, stride=(1, 1), padding=(0, 0)):
    """Channels-first conv2d with an HWIO kernel (the tower's internal
    layout)."""
    with f32_convs():
        return F.conv2d(x, kernel_hwio.permute(3, 2, 0, 1), bias,
                        stride=_tuple(stride, 2), padding=_tuple(padding, 2))


def conv2d(params, x, stride=(1, 1), padding=(0, 0)):
    """x: NHWC, kernel: HWIO, symmetric zero padding -> NHWC."""
    y = conv2d_nchw(x.permute(0, 3, 1, 2), params["kernel"],
                    params.get("bias"), stride, padding)
    return y.permute(0, 2, 3, 1)


def conv3d(params, x, stride=(1, 1, 1), padding=(0, 0, 0)):
    """x: NDHWC, kernel: DHWIO, symmetric zero padding -> NDHWC."""
    with f32_convs():
        y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                     params["kernel"].permute(4, 3, 0, 1, 2),
                     params.get("bias"), stride=_tuple(stride, 3),
                     padding=_tuple(padding, 3))
    return y.permute(0, 2, 3, 4, 1)


def max_pool2d(x, kernel=(2, 2), stride=(2, 2)):
    """NHWC max pool, VALID."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), _tuple(kernel, 2),
                     _tuple(stride, 2))
    return y.permute(0, 2, 3, 1)


def max_pool3d(x, kernel=(1, 2, 2), stride=(1, 2, 2)):
    """NDHWC max pool, VALID."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), _tuple(kernel, 3),
                     _tuple(stride, 3))
    return y.permute(0, 2, 3, 4, 1)
