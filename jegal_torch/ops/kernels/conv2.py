"""GestSync block 2, fused: the CUDA kernel of csrc/conv2.cu and its plain
PyTorch twin.

Port of jegal_tpu/ops/pallas/conv2.py (`_conv2_kernel`,
`conv2_kernel_params`, `conv2_ok`): the reference conv2 block (models/
gestsync.py:47-53), conv k(1,5,5) s(1,2,2) 64->128 without padding, conv
bias and BatchNorm folded into a per-channel scale and bias, ReLU. It reads
the port's dense stem output (T, J, Wp, 64); the TPU kernel's lane
compaction of the m-grid has nothing to undo here. The tower selects it
with conv2_impl="kernel" (models/gestsync.py); the default, "dense", runs
block 2 as cuDNN's convolution, the counterpart of the JAX package's
default `mgrid_conv2_dense`.

bf16 rows (a bf16 stem output and a bf16 weight) take the kernel's bf16
variant (kernel 7b): bf16 products summed in float32, BN and ReLU in
float32, the output rounded to bf16 (the JAX package's conv2.py:115-140 in
bf16); on the card a persistent wgmma implicit GEMM, one stage a tap
(csrc/conv2.cu).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from jegal_torch.core.layers import f32_convs
from jegal_torch.ops.kernels import _build

C_IN = 64
C_OUT = 128
K = 5
STRIDE = 2


def conv2_kernel_params(blk2, eps: float = 1e-5):
    """Fold block 2's conv bias and BatchNorm into the kernel operands.

    blk2: {"conv": {"kernel" (1,5,5,64,128), "bias" (128,)?}, "bn": {...}}.
    -> (weight (5,5,64,128) HWIO, scale (128,), bias (128,)), contiguous:
    relu(conv(x, weight) * scale + bias) == relu(bn(conv(x) + bias)). The
    BatchNorm folds in float32; the weight keeps its dtype."""
    bn = {k: v.to(torch.float32) for k, v in blk2["bn"].items()}
    scale = bn["scale"] * torch.rsqrt(bn["var"] + eps)
    bias = bn["bias"] - bn["mean"] * scale
    cb = blk2["conv"].get("bias")
    if cb is not None:
        bias = bias + cb.to(torch.float32) * scale
    return (blk2["conv"]["kernel"][0].contiguous(), scale.contiguous(),
            bias.contiguous())


def conv2_ok(w_pool: int, n_j: int) -> bool:
    """Geometry contract: enough pooled rows and columns for one 5-tap
    window (the JAX package's conv2.py:181)."""
    return w_pool >= K and n_j >= K


def out_shape(t: int, n_j: int, w_pool: int) -> tuple:
    return (t, (n_j - K) // STRIDE + 1, (w_pool - K) // STRIDE + 1, C_OUT)


def conv2_bn_relu_plain(x, weight, scale, bias):
    """F.conv2d + the folded scale and bias + ReLU in eager PyTorch:
    x (T, J, Wp, 64) -> (T, J2, W2, 128). bf16 rows: x and the weight
    upcast to float32 (exact), the output rounded to bf16."""
    if x.dtype == torch.bfloat16:
        return conv2_bn_relu_plain(x.to(torch.float32),
                                   weight.to(torch.float32), scale,
                                   bias).to(torch.bfloat16)
    with f32_convs():
        y = F.conv2d(x.permute(0, 3, 1, 2), weight.permute(3, 2, 0, 1),
                     stride=STRIDE)
    y = torch.relu(y * scale[:, None, None] + bias[:, None, None])
    return y.permute(0, 2, 3, 1)


def _lib():
    lib = _build.library("conv2")
    lib.jt_conv2.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.jt_conv2.restype = ctypes.c_int
    lib.jt_conv2_bf16.argtypes = lib.jt_conv2.argtypes
    lib.jt_conv2_bf16.restype = ctypes.c_int
    return lib


def kernel_info_bf16() -> dict:
    """What the compiler and the occupancy calculator say of kernel 7b:
    registers and spill bytes a thread, dynamic shared memory a block and
    resident blocks an SM (on the current card)."""
    lib = _lib()
    lib.jt_conv2_bf16_info.argtypes = [ctypes.c_void_p]
    lib.jt_conv2_bf16_info.restype = ctypes.c_int
    info = (ctypes.c_int * 4)()
    _build.check(lib, lib.jt_conv2_bf16_info(ctypes.cast(info,
                                                         ctypes.c_void_p)),
                 "conv2 kernel info")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm"), info))


def conv2_bn_relu(x, weight, scale, bias):
    """Block 2 over the dense stem output x (T, J, Wp, 64) -> (T, J2, W2,
    128), J2 = (J - 5) // 2 + 1 and W2 likewise. The result is a
    channels-last view of an NCHW buffer (T, 128, J2, W2), the layout the
    kernel writes and block 3 reads: `.permute(0, 3, 1, 2)` of it is
    contiguous. The kernel for a CUDA tensor (it has no backward, and raises
    when an operand needs a gradient), the plain twin for a CPU one."""
    if not x.is_cuda:
        return conv2_bn_relu_plain(x, weight, scale, bias)
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block 2 takes float32 or bfloat16 rows, got {dt}")
    _build.refuse_grad("conv2 kernel", x, weight, scale, bias)
    if x.dim() != 4 or x.shape[-1] != C_IN:
        raise ValueError(f"x must be (T, J, Wp, {C_IN}), got "
                         f"{tuple(x.shape)}")
    t, n_j, w_pool, _ = x.shape
    if t < 1 or not conv2_ok(w_pool, n_j):
        raise ValueError(f"x {tuple(x.shape)} is too small for block 2's "
                         f"{K}x{K} window")
    for name, v, shape, vdt in (("x", x, x.shape, dt),
                                ("weight", weight, (K, K, C_IN, C_OUT), dt),
                                ("scale", scale, (C_OUT,), torch.float32),
                                ("bias", bias, (C_OUT,), torch.float32)):
        _build.check_operand(name, v, shape, x.device, vdt)
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("x and weight must be 16-byte aligned (the kernel "
                         "reads them as float4)")
    _, j2, w2, _ = out_shape(t, n_j, w_pool)
    out = torch.empty((t, C_OUT, j2, w2), device=x.device, dtype=dt)
    lib = _lib()
    P = _build.ptr
    bf16 = dt == torch.bfloat16
    entry = lib.jt_conv2_bf16 if bf16 else lib.jt_conv2
    rc = entry(P(x), P(weight), P(scale), P(bias), P(out), t, n_j, w_pool,
               _build.stream_ptr(x.device))
    _build.check(lib, rc, "conv2 kernel")
    _build.LAUNCHES["conv2_bf16" if bf16 else "conv2"] += 1
    return out.permute(0, 2, 3, 1)
