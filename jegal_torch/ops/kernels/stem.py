"""Fused GestSync stem: the CUDA kernels of csrc/stem.cu (window) and
csrc/stem_band.cu (band), and their plain PyTorch twins.

Port of jegal_tpu/ops/pallas/stem.py (`_stem_kernel`, `_stem_kernel_band`
and `stem_kernel_params`): block 1 of the GestSync conv tower (reference
models/gestsync.py:35-45), conv3d k(5,7,7) s(1,3,3) 3->64 without padding,
BatchNorm folded into a per-channel scale and bias, ReLU, and maxpool
(1,3,3)/(1,2,2). Pooled NDHWC out — the dense layout of the JAX package's
`fused_stem_pool` (stem.py:643-656), not its TPU m-grid.

Two entries, as the JAX package's `stem_mgrid_x` and `stem_mgrid_planar`:
`stem_pool` takes float frames in [0, 1], `stem_pool_planar` host-repacked
uint8 planar frames (ops/video.s2d_repack) with /255 folded into the
weights. Each takes `impl`: "band" (the default: on the H100 it is the
faster kernel on both entries, PERF.md §6) or "window" (the JAX package's
STEM_IMPL default); both compute the same function, and a CPU tensor
takes the same twin for either. `_rotate_lhs` has no counterpart: its
phase rotation is a TPU K-band layout.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from jegal_torch.core.layers import f32_convs
from jegal_torch.ops.kernels import _build
from jegal_torch.ops.video import s2d_unpack

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


def stem_pool_planar_plain(planar, weight, scale, bias):
    """The planar entry's twin: un-repack the uint8 planar frames (T4, H3,
    27, W3) to raw 0..255 float frames and convolve with weight / 255, the
    kernel's arithmetic. -> (T4 - 4, J, W_pool, 64)."""
    return stem_pool_plain(s2d_unpack(planar).to(torch.float32),
                           weight / 255.0, scale, bias)


# impl -> (library: csrc/<name>.cu, its entry for float frames)
KERNELS = {"window": ("stem", "jt_stem_pool"),
           "band": ("stem_band", "jt_stem_band")}
IMPLS = tuple(KERNELS)


def _entry(impl, planar: bool):
    """The C entry of the `impl` kernel for the input form, with its
    library (for error strings)."""
    name, fn = KERNELS[impl]
    lib = _build.library(name)
    f = getattr(lib, fn + "_planar" if planar else fn)
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return lib, f


def kernel_info(planar: bool, impl: str = "band") -> dict:
    """What the compiler and the occupancy calculator say of the `impl`
    stem's kernel for an entry: registers and spill bytes a thread, dynamic
    shared memory a block and resident blocks an SM (on the current card)."""
    _check_impl(impl)
    name, fn = KERNELS[impl]
    lib = _build.library(name)
    fn = getattr(lib, fn + "_info")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 4)()
    _build.check(lib, fn(int(planar), ctypes.cast(info, ctypes.c_void_p)),
                 "stem kernel info")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm"), info))


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _check_params(weight, scale, bias, device):
    for name, t, shape in (("weight", weight, KERNEL + (3, C_OUT)),
                           ("scale", scale, (C_OUT,)),
                           ("bias", bias, (C_OUT,))):
        _build.check_operand(name, t, shape, device)
    if weight.data_ptr() % 16:
        raise ValueError("weight must be 16-byte aligned (the kernels read "
                         "it in 16-byte pieces)")


def _launch(impl, planar, x, weight, scale, bias, t_in, h, w):
    """Run the `impl` kernel on the entry's input `x` (frames, or planar
    with h, w its raw frame size) -> (t_in - 4, J, W_pool, 64)."""
    shape = pooled_shape(t_in, h, w)
    if min(shape) < 1:
        raise ValueError(f"input {tuple(x.shape)} is too small for the stem")
    out = torch.empty(shape, device=x.device, dtype=torch.float32)
    lib, fn = _entry(impl, planar)
    P = _build.ptr
    dims = (h // 3, w // 3) if planar else (h, w)
    rc = fn(P(x), P(weight), P(scale), P(bias), P(out), t_in, *dims,
            _build.stream_ptr(x.device))
    _build.check(lib, rc, f"{impl} stem kernel")
    _build.LAUNCHES["stem_band" if impl == "band" else
                    "stem_pool_planar" if planar else "stem_pool"] += 1
    return out


def stem_pool(frames, weight, scale, bias, impl: str = "band"):
    """Fused stem over float32 frames (T4, H, W, 3) in [0, 1] ->
    (T4 - 4, J, W_pool, 64). On a CUDA tensor the `impl` kernel ("window"
    or "band"; it has no backward, and raises when an operand needs a
    gradient), the plain twin for a CPU one."""
    _check_impl(impl)
    if not frames.is_cuda:
        return stem_pool_plain(frames, weight, scale, bias)
    _build.refuse_grad("stem kernel", frames, weight, scale, bias)
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (T, H, W, 3), got "
                         f"{tuple(frames.shape)}")
    _build.check_operand("frames", frames, frames.shape, frames.device)
    _check_params(weight, scale, bias, frames.device)
    t_in, h, w, _ = frames.shape
    return _launch(impl, False, frames, weight, scale, bias, t_in, h, w)


def stem_pool_planar(planar, weight, scale, bias, impl: str = "band"):
    """Fused stem over host-repacked uint8 planar frames (T4, H3, 27, W3)
    (ops/video.s2d_repack, edge-padded) -> (T4 - 4, J, W_pool, 64), the
    output of `stem_pool` on the raw frames / 255. `weight` is block 1's
    folded weight as `stem_kernel_params` returns it; the wrapper divides
    it by 255. On a CUDA tensor the `impl` kernel, on a CPU one the twin."""
    _check_impl(impl)
    if not planar.is_cuda:
        return stem_pool_planar_plain(planar, weight, scale, bias)
    _build.refuse_grad("stem kernel", weight, scale, bias)
    if planar.dim() != 4 or planar.shape[2] != 27:
        raise ValueError(f"planar frames must be (T, H3, 27, W3), got "
                         f"{tuple(planar.shape)}")
    if planar.dtype != torch.uint8:
        raise TypeError(f"planar frames must be uint8, got {planar.dtype}")
    if not planar.is_contiguous():
        raise ValueError("planar frames must be contiguous")
    _check_params(weight, scale, bias, planar.device)
    t_in, h3, _, w3 = planar.shape
    return _launch(impl, True, planar, (weight / 255.0).contiguous(), scale,
                   bias, t_in, 3 * h3, 3 * w3)
