"""Static-shape bucketing (the JAX package's data/bucketing.py).

On the card the engine captures one CUDA graph per bucket signature, so
the buckets bound its graph cache as they bound the JAX engine's compile
cache; the engine's padding (edge-repeat frames, zero mel, masked
attention, zero pooling rows) produces the same rows as the JAX engine's."""

from __future__ import annotations

import numpy as np
import torch

T_BUCKETS = (32, 64, 128, 256, 512)        # video frames (PE cap is 500)
S_BUCKETS = (16, 32, 64, 128, 256)         # subword tokens
W_BUCKETS = (8, 16, 32, 64, 128)           # words
MEL_BUCKETS = tuple(4 * t for t in T_BUCKETS)  # mel frames (4x token rate)


def next_bucket(n: int, buckets=T_BUCKETS) -> int:
    """Smallest bucket >= n; past the table end, the next multiple of the
    last bucket."""
    if n <= 0:
        raise ValueError(f"bucketing requires n >= 1, got {n}")
    for b in buckets:
        if n <= b:
            return b
    last = buckets[-1]
    return -(-n // last) * last


def batch_ladder(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at `cap`: the padded batch of an
    n-sample chunk, so a straggler chunk pays for a right-sized batch and
    not a full one (the JAX package's api._batch_ladder)."""
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def pad_axis(arr, axis: int, target: int, value=0.0):
    """Pad `arr` with `value` along `axis` up to `target` length. A torch
    tensor pads on its own device; anything else pads as a numpy array."""
    cur = arr.shape[axis]
    if cur == target:
        return arr
    if cur > target:
        raise ValueError(f"axis {axis} length {cur} exceeds bucket {target}")
    if isinstance(arr, torch.Tensor):
        shape = list(arr.shape)
        shape[axis] = target - cur
        fill = torch.full(shape, value, dtype=arr.dtype, device=arr.device)
        return torch.cat([arr, fill], dim=axis)
    widths = [(0, 0)] * np.ndim(arr)
    widths[axis] = (0, target - cur)
    return np.pad(np.asarray(arr), widths, constant_values=value)
