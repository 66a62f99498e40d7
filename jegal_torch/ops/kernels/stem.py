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

bf16 (the JAX engine's bf16 dtype): float frames in bf16 (the /255 rounded
to bf16 where the mask is applied, ops/video.mask_frames_device), or the
same uint8 planar frames with a bf16 weight (/255 folded in float32, then
rounded to bf16, stem.py:523), take the `impl` kernel's bf16 variant. Both
variants compute one function, and one pair of twins serves both: bf16
products summed in float32, BN and ReLU in float32, the max pool over
float32 conv rows, and the pooled value rounded to bf16 once. That is
`_stem_kernel`'s arithmetic (its conv rows stay float32, stem.py:465 and
:552, and the pooled max is rounded at :213), and `_stem_kernel_band`'s
(it rounds each conv row, stem.py:305, and takes the max on bf16 values:
rounding is monotone, so rounding the pooled max is the same).
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
    -> (weight (5,7,7,3,64), scale (64,), bias (64,)), all contiguous:
    relu(conv(x, weight) * scale + bias) == relu(bn(conv(x) + conv_bias)).
    The BatchNorm is folded in float32 whatever the parameters' dtype (the
    JAX package's stem_kernel_params); the weight keeps its dtype.
    """
    bn = {k: v.to(torch.float32) for k, v in blk["bn"].items()}
    scale = bn["scale"] * torch.rsqrt(bn["var"] + eps)
    bias = bn["bias"] - bn["mean"] * scale
    cb = blk["conv"].get("bias")
    if cb is not None:
        bias = bias + cb.to(torch.float32) * scale
    return (blk["conv"]["kernel"].contiguous(), scale.contiguous(),
            bias.contiguous())


def pooled_shape(t_in: int, h: int, w: int) -> tuple:
    hc, wc = (h - KERNEL[1]) // STRIDE + 1, (w - KERNEL[2]) // STRIDE + 1
    return (t_in - KERNEL[0] + 1, (hc - 3) // 2 + 1, (wc - 3) // 2 + 1, C_OUT)


def stem_pool_plain(frames, weight, scale, bias):
    """conv3d + scale/bias + ReLU + maxpool in eager PyTorch.
    frames (T4, H, W, 3) -> (T4 - 4, J, W_pool, 64). bf16 frames take the
    bf16 variants' twin: frames and weight upcast to float32 (exact), the
    products, BN, ReLU and the pool in float32, the output rounded to
    bf16."""
    if frames.dtype == torch.bfloat16:
        return stem_pool_plain(frames.to(torch.float32),
                               weight.to(torch.float32), scale,
                               bias).to(torch.bfloat16)
    x = frames.permute(3, 0, 1, 2)[None]                  # (1, 3, T4, H, W)
    with f32_convs():
        y = F.conv3d(x, weight.permute(4, 3, 0, 1, 2),
                     stride=(1, STRIDE, STRIDE))
    y = torch.relu(y * scale[:, None, None, None] + bias[:, None, None, None])
    y = F.max_pool3d(y, (1, 3, 3), (1, 2, 2))
    return y[0].permute(1, 2, 3, 0)


def planar_weight(weight):
    """The planar entry's weight: the raw pixels' /255 folded in; for a
    bf16 weight folded in float32 and rounded to bf16 (stem.py:523)."""
    if weight.dtype == torch.bfloat16:
        return (weight.to(torch.float32) / 255.0).to(torch.bfloat16)
    return weight / 255.0


def stem_pool_planar_plain(planar, weight, scale, bias):
    """The planar entry's twin: un-repack the uint8 planar frames (T4, H3,
    27, W3) to raw 0..255 float frames and convolve with weight / 255, the
    kernel's arithmetic. -> (T4 - 4, J, W_pool, 64), bf16 for a bf16
    weight."""
    w = planar_weight(weight)
    out = stem_pool_plain(s2d_unpack(planar).to(torch.float32),
                          w.to(torch.float32), scale, bias)
    return out.to(weight.dtype)


# impl -> (library: csrc/<name>.cu, its entry for float frames)
KERNELS = {"window": ("stem", "jt_stem_pool"),
           "band": ("stem_band", "jt_stem_band")}
IMPLS = tuple(KERNELS)


def _entry(impl, planar: bool, bf16: bool = False):
    """The C entry of the `impl` kernel for the input form (and its bf16
    variant), with its library (for error strings)."""
    name, fn = KERNELS[impl]
    lib = _build.library(name)
    f = getattr(lib, fn + ("_planar" if planar else "")
                + ("_bf16" if bf16 else ""))
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return lib, f


def kernel_info(planar: bool, impl: str = "band", bf16: bool = False) -> dict:
    """What the compiler and the occupancy calculator say of the `impl`
    stem's kernel for an entry (its bf16 variant with bf16=True):
    registers and spill bytes a thread, dynamic shared memory a block and
    resident blocks an SM (on the current card)."""
    _check_impl(impl)
    name, fn = KERNELS[impl]
    lib = _build.library(name)
    fn = getattr(lib, fn + ("_bf16" if bf16 else "") + "_info")
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


def _check_params(weight, scale, bias, device, dtype=torch.float32):
    for name, t, shape, dt in (
            ("weight", weight, KERNEL + (3, C_OUT), dtype),
            ("scale", scale, (C_OUT,), torch.float32),
            ("bias", bias, (C_OUT,), torch.float32)):
        _build.check_operand(name, t, shape, device, dt)
    if weight.data_ptr() % 16:
        raise ValueError("weight must be 16-byte aligned (the kernels read "
                         "it in 16-byte pieces)")


def _launch(impl, planar, x, weight, scale, bias, t_in, h, w):
    """Run the `impl` kernel on the entry's input `x` (frames, or planar
    with h, w its raw frame size) -> (t_in - 4, J, W_pool, 64)."""
    shape = pooled_shape(t_in, h, w)
    if min(shape) < 1:
        raise ValueError(f"input {tuple(x.shape)} is too small for the stem")
    bf16 = weight.dtype == torch.bfloat16
    out = torch.empty(shape, device=x.device, dtype=weight.dtype)
    lib, fn = _entry(impl, planar, bf16)
    P = _build.ptr
    dims = (h // 3, w // 3) if planar else (h, w)
    rc = fn(P(x), P(weight), P(scale), P(bias), P(out), t_in, *dims,
            _build.stream_ptr(x.device))
    _build.check(lib, rc, f"{impl} stem kernel")
    counter = "stem_band" if impl == "band" else \
        "stem_pool_planar" if planar else "stem_pool"
    _build.LAUNCHES[counter + ("_bf16" if bf16 else "")] += 1
    return out


def stem_pool(frames, weight, scale, bias, impl: str = "band"):
    """Fused stem over float frames (T4, H, W, 3) in [0, 1], float32 or
    bf16 (with a weight of the same dtype) -> (T4 - 4, J, W_pool, 64) of
    that dtype. On a CUDA tensor the `impl` kernel ("window" or "band") of
    that dtype (it has no backward, and raises when an operand needs a
    gradient), the plain twin for a CPU one."""
    _check_impl(impl)
    dt = frames.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"frames must be float32 or bfloat16, got {dt}")
    if weight.dtype != dt:
        raise TypeError(f"weight must be {dt} like the frames, got "
                        f"{weight.dtype}")
    if not frames.is_cuda:
        return stem_pool_plain(frames, weight, scale, bias)
    _build.refuse_grad("stem kernel", frames, weight, scale, bias)
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (T, H, W, 3), got "
                         f"{tuple(frames.shape)}")
    _build.check_operand("frames", frames, frames.shape, frames.device, dt)
    _check_params(weight, scale, bias, frames.device, dt)
    t_in, h, w, _ = frames.shape
    return _launch(impl, False, frames, weight, scale, bias, t_in, h, w)


def stem_pool_planar(planar, weight, scale, bias, impl: str = "band"):
    """Fused stem over host-repacked uint8 planar frames (T4, H3, 27, W3)
    (ops/video.s2d_repack, edge-padded) -> (T4 - 4, J, W_pool, 64), the
    output of `stem_pool` on the raw frames / 255. `weight` is block 1's
    folded weight as `stem_kernel_params` returns it; the wrapper divides
    it by 255 (`planar_weight`). A bf16 weight takes the `impl` kernel's
    bf16 variant and gives bf16. On a CUDA tensor the `impl` kernel, on a
    CPU one the twin."""
    _check_impl(impl)
    if weight.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weight must be float32 or bfloat16, got "
                        f"{weight.dtype}")
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
    _check_params(weight, scale, bias, planar.device, weight.dtype)
    t_in, h3, _, w3 = planar.shape
    return _launch(impl, True, planar, planar_weight(weight).contiguous(),
                   scale, bias, t_in, 3 * h3, 3 * w3)
