"""The bf16 bars of the port's tests and chip_smoke.py (numpy and torch
only: the card machine has no JAX).

`ulps(got, want)`: per element |got - want| in bf16 ulps (the spacing of
bf16 numbers at a magnitude m: 2^(e - 7) for m in [2^e, 2^(e+1))), at the
larger of the two magnitudes, and at least the RMS of the element's row
(its last axis). The floor is for elements smaller than their row's
scale: each is a sum of terms of the row's scale through intermediate
bf16 roundings (p, the attention output, the FFN hidden rows), and a
one-ulp flip of one of those, which two summation orders cause, lands on
it as an error of the row's scale, which a small element's own ulp does
not measure. (The attention sublayer's twin summed in float64 instead of
float32 differs from itself by 3 ulps of an element's own magnitude at
the window head's 1.4 M elements.)

`min_row_cos(a, b)`: the smallest cosine between matching rows (last
axis), in float64, over the rows where either is nonzero.

A kernel against its twin or the Pallas kernel: MAX_ULPS and KERNEL_COS.
A whole stack of layers against its twin: STACK_MAX_ULPS. Each layer's
roundings move with the summation order of the one before, so the noise
grows with depth: the 12-layer XLM-R stack's twin summed in float64
instead of float32 differs from itself by 3 ulps (2 at 2 layers), and
the bar doubles MAX_ULPS, as the float32 stack's STACK_ATOL doubles its
sublayers' bar in chip_smoke.py."""

import numpy as np

MAX_ULPS = 2
STACK_MAX_ULPS = 4
KERNEL_COS = 0.9999


def as_f32(a) -> np.ndarray:
    """A bf16 (or any float) array of torch, JAX or numpy -> float32 numpy
    (exact for bf16)."""
    try:
        import torch

        if isinstance(a, torch.Tensor):
            return a.detach().to(torch.float32).cpu().numpy()
    except ImportError:
        pass
    return np.asarray(a).astype(np.float32)


def ulps(got, want) -> np.ndarray:
    got, want = as_f32(got), as_f32(want)
    mag = np.maximum(np.abs(got), np.abs(want))
    rms = np.sqrt(np.mean(np.square(mag.astype(np.float64)), axis=-1,
                          keepdims=True))
    mag = np.maximum(np.maximum(mag, rms), 2.0 ** -126)
    return np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)


def min_row_cos(a, b) -> float:
    a = as_f32(a)
    a = a.reshape(-1, a.shape[-1]).astype(np.float64)
    b = as_f32(b).reshape(a.shape).astype(np.float64)
    na, nb = np.linalg.norm(a, axis=-1), np.linalg.norm(b, axis=-1)
    live = (na > 0) | (nb > 0)
    if not live.any():
        return 1.0
    return float(np.min(np.sum(a * b, -1)[live]
                        / np.maximum(na * nb, 1e-300)[live]))


def kernel_bar(got, want) -> tuple[float, float]:
    """(worst ulps, min row cosine) of got against want."""
    return float(ulps(got, want).max()), min_row_cos(got, want)


def check_kernel_bar(got, want, what: str = "",
                     max_ulps: float = MAX_ULPS) -> tuple[float, float]:
    worst, cos = kernel_bar(got, want)
    if worst > max_ulps or cos < KERNEL_COS:
        raise AssertionError(f"{what}: {worst} bf16 ulps (bar {max_ulps}), "
                             f"min row cosine {cos} (bar {KERNEL_COS})")
    return worst, cos
