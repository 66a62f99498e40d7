"""Blockwise multi-head attention: the CUDA kernels of csrc/flash_attention.cu,
their plain PyTorch twin, and the autograd Function that training calls.

Port of jegal_tpu/ops/pallas/flash_attention.py (`_make_kernel`,
`flash_attention`, `flash_attention_diff` and its dense VJP `_flash_bwd`).
q, k, v are (B, H, T, D) float32 or bf16 (all three of one dtype); mask is
a (B, T) key validity (0 = masked) or None. Scores are (q / sqrt(D)) k^T
with masked keys FILLED with -1e9 before a float32 softmax (reference
models/modules.py:61-75).

bf16 rows take the kernel's bf16 variant (kernel 6b), which computes what
`_make_kernel` computes on a bf16 block (flash_attention.py:45-72): q, k
and v upcast to float32 (exact), q scaled in float32, float32 scores,
softmax and p, and the output rounded to bf16 once. On the card it runs
its products as bf16 tensor-core passes over q * scale and p split into
two bf16 pieces each (csrc/flash_attention.cu).

`flash_attention` launches the kernel of the rows' dtype for a CUDA tensor
and runs the twin for a CPU one. `flash_attention_diff` is the
differentiable entry: the kernel (or twin) forward and the dense float32
backward of the JAX package's `_flash_bwd`, which there is plain XLA
einsums, not a Pallas kernel, and here is plain PyTorch; its gradients
come back in the inputs' dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from jegal_torch.ops.kernels import _build

NEG_FILL = -1e9          # the reference's fill value (models/modules.py:70)
HEAD_DIMS = (64, 96)     # head widths the kernel is built for
# rows' dtype -> (C entry, launch counter)
KERNELS = {torch.float32: ("jt_flash_attention", "flash_attention"),
           torch.bfloat16: ("jt_flash_attention_bf16", "flash_attention_bf16")}


def _masked(s, mask):
    if mask is None:
        return s
    return s.masked_fill(mask[:, None, None, :] == 0, NEG_FILL)


def _check_dtypes(q, k, v):
    if q.dtype not in KERNELS:
        raise TypeError(f"q, k and v must be float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def flash_attention_plain(q, k, v, mask=None):
    """The kernel's function in eager PyTorch (q scaled before the
    product, as the TPU kernel does). bf16 rows: q, k and v upcast to
    float32, everything in float32 (p too), the output rounded to bf16."""
    _check_dtypes(q, k, v)
    if q.dtype == torch.bfloat16:
        return flash_attention_plain(q.float(), k.float(), v.float(),
                                     mask).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    return torch.matmul(torch.softmax(_masked(s, mask), dim=-1), v)


def flash_attention_bwd(q, k, v, mask, g):
    """-> (dq, dk, dv): the dense float32 VJP of `_flash_bwd`
    (flash_attention.py:91-107), recomputing p with the -1e9 fill; bf16
    inputs are upcast and the gradients cast back to each input's dtype,
    as there."""
    dts = (q.dtype, k.dtype, v.dtype)
    q, k, v, g = (x.float() for x in (q, k, v, g))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _masked(torch.matmul(q, k.transpose(-1, -2)) * scale, mask)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return tuple(x.to(dt) for x, dt in zip((dq, dk, dv), dts))


def _lib():
    lib = _build.library("flash_attention")
    for entry, _ in KERNELS.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def kernel_info_bf16(d: int) -> dict:
    """What the compiler and the occupancy calculator say of kernel 6b at
    head width `d`: registers and spill bytes a thread, dynamic shared
    memory a block and resident blocks an SM (on the current card)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d}: the kernel takes {HEAD_DIMS}")
    lib = _lib()
    fn = lib.jt_flash_attention_bf16_info
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 4)()
    _build.check(lib, fn(d, ctypes.cast(info, ctypes.c_void_p)),
                 "flash attention kernel info")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm"), info))


def flash_attention(q, k, v, mask=None):
    """(B, H, T, D) q, k, v (float32 or bf16) and an optional (B, T) key
    mask -> (B, H, T, D) of the rows' dtype. The kernel of that dtype for
    a CUDA tensor (no gradient: see `flash_attention_diff`), the plain
    twin for a CPU one. Non-contiguous views (the transposed heads of
    core/transformer._split_heads) are copied to contiguous ones first."""
    _check_dtypes(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, mask)
    _build.refuse_grad("flash attention kernel", q, k, v)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d}: the flash attention kernel takes "
                         f"head widths {HEAD_DIMS}")
    dev, dt = q.device, q.dtype
    q, k, v = (x.contiguous() for x in (q, k, v))
    for name, x in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(name, x, (b, h, t, d), dev, dt)
    if mask is not None:
        mask = mask.to(dtype=torch.float32).contiguous()
        _build.check_operand("mask", mask, (b, t), dev)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned (the kernel "
                         "copies their rows 16 bytes at a time)")
    out = torch.empty_like(q)
    lib = _lib()
    entry, counter = KERNELS[dt]
    P = _build.ptr
    rc = getattr(lib, entry)(P(q), P(k), P(v), P(mask), P(out), b, h, t, d,
                             1.0 / math.sqrt(d), _build.stream_ptr(dev))
    _build.check(lib, rc, "flash attention kernel")
    _build.LAUNCHES[counter] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """`flash_attention` forward, `flash_attention_bwd` backward (the JAX
    package's custom VJP, flash_attention.py:77-110). The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return flash_attention(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, mask, g), None)


def flash_attention_diff(q, k, v, mask=None):
    """Differentiable blockwise attention: what the attention of the
    encoder layer loop calls (core/transformer.multi_head_attention)."""
    return FlashAttention.apply(q, k, v, mask)
