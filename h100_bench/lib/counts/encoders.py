"""The encoder kernels (ops/kernels/fused_layer.py: the attention and FFN
sublayers, and the whole XLM-R stack) over (R, d) rows of `seg`-row
segments.

Operations: the products (QKV 2 R d 3d, attention scores and values 4 R
seg d, output 2 R d d; FFN 2 R d dff twice), counted once. Rows, norms,
softmax and activations are left out: they are a few operations a row
element beside the products' thousands. Bytes: the input rows, every
weight, bias and norm parameter, the key mask, read once, and the output
rows written once, in float32. The shape arithmetic of chip_smoke.py's
`core_row` (:651) and `bound_3xtf32` (:534), with each operation counted
once rather than three times."""

from __future__ import annotations

F32 = 4


def attn(r: int, d: int, seg: int, masked: bool) -> tuple[float, float]:
    """(operations, bytes) of one attention sublayer launch."""
    ops = 2.0 * r * d * 3 * d + 4.0 * r * seg * d + 2.0 * r * d * d
    weights = 3 * d * d + 3 * d + d * d + d + 2 * d
    return ops, F32 * (2.0 * r * d + weights + (r if masked else 0))


def ffn(r: int, d: int, dff: int) -> tuple[float, float]:
    """(operations, bytes) of one FFN sublayer launch."""
    ops = 4.0 * r * d * dff
    weights = 2 * d * dff + dff + d + 2 * d
    return ops, F32 * (2.0 * r * d + weights)


def stack(r: int, d: int, dff: int, seg: int, layers: int, masked: bool
          ) -> tuple[float, float]:
    """(operations, bytes) of one whole-stack launch (every layer's
    weights read once, the rows read and written once)."""
    a_ops, _ = attn(r, d, seg, masked)
    f_ops, _ = ffn(r, d, dff)
    weights = 4 * d * d + 4 * d + 2 * d * dff + dff + d + 4 * d
    return (layers * (a_ops + f_ops),
            F32 * (2.0 * r * d + layers * weights + (r if masked else 0)))
