"""Block 1 of the GestSync tower, the fused stem: conv3d k(5, 7, 7) s(1, 3,
3) from 3 to 64 channels without padding, BatchNorm, ReLU and max pool
(1, 3, 3) / (1, 2, 2) (ops/kernels/stem.py's kernels).

The shape arithmetic is a frozen copy of chip_smoke.py's `stem_flops`
(:675) and jegal_torch/ops/kernels/stem.py's `pooled_shape` (:68):
operations are those of the conv positions the pool reads, (2 J + 1) x
(2 Wp + 1) a frame (the 3x3/2 pool never reads a trailing odd conv row or
column), counted once; chip_smoke's 3xTF32 bound counted them three times
(two on planar frames), which is how today's kernels compute, not what the
stem needs."""

from __future__ import annotations

KERNEL = (5, 7, 7)
STRIDE = 3
C_IN, C_OUT = 3, 64


def pooled_shape(t_in: int, h: int, w: int) -> tuple:
    """(output frames, pooled rows J, pooled columns Wp, channels)."""
    hc = (h - KERNEL[1]) // STRIDE + 1
    wc = (w - KERNEL[2]) // STRIDE + 1
    return (t_in - KERNEL[0] + 1, (hc - 3) // 2 + 1, (wc - 3) // 2 + 1, C_OUT)


def flops(t_in: int, h: int = 270, w: int = 480) -> float:
    t_out, j, wp, c = pooled_shape(t_in, h, w)
    k = KERNEL[0] * KERNEL[1] * KERNEL[2] * C_IN
    return 2.0 * t_out * (2 * j + 1) * (2 * wp + 1) * c * k


def nbytes(t_in: int, h: int = 270, w: int = 480, planar: bool = True
           ) -> float:
    """Frames read once (uint8 planar, or float32), the weight, the folded
    BatchNorm scale and bias, and the pooled output written (float32)."""
    t_out, j, wp, c = pooled_shape(t_in, h, w)
    frames = t_in * h * w * C_IN * (1 if planar else 4)
    weight = 4 * (KERNEL[0] * KERNEL[1] * KERNEL[2] * C_IN * C_OUT + 2 * C_OUT)
    return float(frames + weight + 4 * t_out * j * wp * c)
