"""Blockwise multi-head attention: the CUDA kernel of csrc/flash_attention.cu,
its plain PyTorch twin, and the autograd Function that training calls.

Port of jegal_tpu/ops/pallas/flash_attention.py (`_make_kernel`,
`flash_attention`, `flash_attention_diff` and its dense VJP `_flash_bwd`).
q, k, v are (B, H, T, D) float32; mask is a (B, T) key validity (0 =
masked) or None. Scores are (q / sqrt(D)) k^T with masked keys FILLED with
-1e9 before a float32 softmax (reference models/modules.py:61-75).

`flash_attention` launches the kernel for a CUDA tensor and runs the twin
for a CPU one. `flash_attention_diff` is the differentiable entry: the
kernel (or twin) forward and the dense float32 backward of the JAX
package's `_flash_bwd`, which there is plain XLA einsums, not a Pallas
kernel, and here is plain PyTorch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from jegal_torch.ops.kernels import _build

NEG_FILL = -1e9          # the reference's fill value (models/modules.py:70)
HEAD_DIMS = (64, 96)     # head widths the kernel is built for


def _masked(s, mask):
    if mask is None:
        return s
    return s.masked_fill(mask[:, None, None, :] == 0, NEG_FILL)


def flash_attention_plain(q, k, v, mask=None):
    """The kernel's function in eager PyTorch (q scaled before the
    product, as the TPU kernel does)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    return torch.matmul(torch.softmax(_masked(s, mask), dim=-1), v)


def flash_attention_bwd(q, k, v, mask, g):
    """-> (dq, dk, dv): the dense float32 VJP of `_flash_bwd`
    (flash_attention.py:91-107), recomputing p with the -1e9 fill."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _masked(torch.matmul(q, k.transpose(-1, -2)) * scale, mask)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


def _lib():
    lib = _build.library("flash_attention")
    lib.jt_flash_attention.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    lib.jt_flash_attention.restype = ctypes.c_int
    return lib


def flash_attention(q, k, v, mask=None):
    """(B, H, T, D) q, k, v and an optional (B, T) key mask ->
    (B, H, T, D). The kernel for a CUDA tensor (no gradient: see
    `flash_attention_diff`), the plain twin for a CPU one. Non-contiguous
    views (the transposed heads of core/transformer._split_heads) are
    copied to contiguous ones first."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, mask)
    _build.refuse_grad("flash attention kernel", q, k, v)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d}: the flash attention kernel takes "
                         f"head widths {HEAD_DIMS}")
    dev = q.device
    q, k, v = (x.contiguous() for x in (q, k, v))
    for name, x in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(name, x, (b, h, t, d), dev)
    if mask is not None:
        mask = mask.to(dtype=torch.float32).contiguous()
        _build.check_operand("mask", mask, (b, t), dev)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned (the kernel "
                         "copies their rows 16 bytes at a time)")
    out = torch.empty_like(q)
    lib = _lib()
    P = _build.ptr
    rc = lib.jt_flash_attention(P(q), P(k), P(v), P(mask), P(out), b, h, t, d,
                                1.0 / math.sqrt(d), _build.stream_ptr(dev))
    _build.check(lib, rc, "flash attention kernel")
    _build.LAUNCHES["flash_attention"] += 1
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
