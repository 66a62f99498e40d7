"""Fused GestSync stem: the CUDA kernel of csrc/stem.cu and its plain
PyTorch twin.

Port of jegal_tpu/ops/pallas/stem.py (`_stem_kernel` and
`stem_kernel_params`): block 1 of the GestSync conv tower (reference
models/gestsync.py:35-45), conv3d k(5,7,7) s(1,3,3) 3->64 without padding,
BatchNorm folded into a per-channel scale and bias, ReLU, and maxpool
(1,3,3)/(1,2,2). Frames in, pooled NDHWC out — the dense layout of the
JAX package's `fused_stem_pool` (stem.py:643-656), not its TPU m-grid.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from jegal_torch.core.layers import f32_convs
from jegal_torch.ops.kernels import _build

KERNEL = (5, 7, 7)
STRIDE = 3
C_OUT = 64


def stem_kernel_params(blk, eps: float = 1e-5):
    """Fold block 1's conv bias and BatchNorm into the kernel operands.

    blk: {"conv": {"kernel" (5,7,7,3,64), "bias" (64,)}, "bn": {...}}.
    -> (weight (5,7,7,3,64), scale (64,), bias (64,)), all contiguous f32:
    relu(conv(x, weight) * scale + bias) == relu(bn(conv(x) + conv_bias)).
    """
    bn = blk["bn"]
    scale = bn["scale"] * torch.rsqrt(bn["var"] + eps)
    bias = bn["bias"] - bn["mean"] * scale
    cb = blk["conv"].get("bias")
    if cb is not None:
        bias = bias + cb * scale
    return (blk["conv"]["kernel"].contiguous(), scale.contiguous(),
            bias.contiguous())


def pooled_shape(t_in: int, h: int, w: int) -> tuple:
    hc, wc = (h - KERNEL[1]) // STRIDE + 1, (w - KERNEL[2]) // STRIDE + 1
    return (t_in - KERNEL[0] + 1, (hc - 3) // 2 + 1, (wc - 3) // 2 + 1, C_OUT)


def stem_pool_plain(frames, weight, scale, bias):
    """conv3d + scale/bias + ReLU + maxpool in eager PyTorch.
    frames (T4, H, W, 3) -> (T4 - 4, J, W_pool, 64)."""
    x = frames.permute(3, 0, 1, 2)[None]                  # (1, 3, T4, H, W)
    with f32_convs():
        y = F.conv3d(x, weight.permute(4, 3, 0, 1, 2),
                     stride=(1, STRIDE, STRIDE))
    y = torch.relu(y * scale[:, None, None, None] + bias[:, None, None, None])
    y = F.max_pool3d(y, (1, 3, 3), (1, 2, 2))
    return y[0].permute(1, 2, 3, 0)


def _lib():
    lib = _build.library("stem")
    lib.jt_stem_pool.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.jt_stem_pool.restype = ctypes.c_int
    return lib


def stem_pool(frames, weight, scale, bias):
    """Fused stem over float32 frames (T4, H, W, 3) in [0, 1] ->
    (T4 - 4, J, W_pool, 64). The kernel for a CUDA tensor (it has no
    backward, and raises when an operand needs a gradient), the plain twin
    for a CPU one."""
    if not frames.is_cuda:
        return stem_pool_plain(frames, weight, scale, bias)
    _build.refuse_grad("stem kernel", frames, weight, scale, bias)
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (T, H, W, 3), got "
                         f"{tuple(frames.shape)}")
    for name, t, shape in (("frames", frames, frames.shape),
                           ("weight", weight, KERNEL + (3, C_OUT)),
                           ("scale", scale, (C_OUT,)),
                           ("bias", bias, (C_OUT,))):
        _build.check_operand(name, t, shape, frames.device)
    if weight.data_ptr() % 16:
        raise ValueError("weight must be 16-byte aligned (the kernel reads "
                         "it as float4)")
    t_in, h, w, _ = frames.shape
    shape = pooled_shape(t_in, h, w)
    if min(shape) < 1:
        raise ValueError(f"frames {tuple(frames.shape)} are too small for "
                         f"the stem")
    out = torch.empty(shape, device=frames.device, dtype=torch.float32)
    lib = _lib()
    P = _build.ptr
    rc = lib.jt_stem_pool(P(frames), P(weight), P(scale), P(bias), P(out),
                          t_in, h, w, _build.stream_ptr(frames.device))
    _build.check(lib, rc, "stem kernel")
    _build.LAUNCHES["stem_pool"] += 1
    return out
