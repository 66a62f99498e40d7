"""The host's space-to-depth repack of decoder frames into the planar
frames that `extract-feats` hands the engine, and its inverse.

`s2d_repack` is a frozen copy of `s2d_repack` in jegal_torch/ops/video.py:40
(itself bit-exact with the C++ repack of the decoder); `s2d_repack_torch`
computes the same bytes with torch on any device, so that the benchmark's
pool is masked and repacked on the card in a few large calls, and
`s2d_unpack_torch` is its inverse for the plain reference. A test holds
the torch pair to the numpy copy bit for bit."""

from __future__ import annotations

import numpy as np
import torch


def s2d_repack(frames_u8, cut_rows=None) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, H/3, 27, W/3) uint8 planar frames:
    out[t, h3, (dh*3+dw)*3+ch, w3] = frames[t, 3*h3+dh, 3*w3+dw, ch], with
    raw rows h < cut_rows[t] zeroed (no rows without cut_rows)."""
    frames = np.ascontiguousarray(frames_u8, dtype=np.uint8)
    t, h, w, c = frames.shape
    if c != 3 or h % 3 or w % 3:
        raise ValueError(f"frames must be (T, H, W, 3) with H and W multiples "
                         f"of 3, got {frames.shape}")
    if cut_rows is not None:
        cut = np.asarray(cut_rows, np.int64)
        if cut.shape != (t,):
            raise ValueError(f"cut_rows must be ({t},), got {cut.shape}")
        rows = np.arange(h)[None, :, None, None]
        frames = np.where(rows < cut[:, None, None, None], np.uint8(0),
                          frames)
    x = frames.reshape(t, h // 3, 3, w // 3, 3, 3)        # t h3 dh w3 dw ch
    return np.ascontiguousarray(
        x.transpose(0, 1, 2, 4, 5, 3).reshape(t, h // 3, 27, w // 3))


def s2d_repack_torch(frames_u8: torch.Tensor, cut_rows: torch.Tensor):
    """`s2d_repack` on a uint8 tensor (T, H, W, 3) with chin rows (T,), on
    the tensor's device."""
    t, h, w, _ = frames_u8.shape
    rows = torch.arange(h, device=frames_u8.device).reshape(1, h, 1, 1)
    x = torch.where(rows < cut_rows.to(torch.int64).reshape(t, 1, 1, 1),
                    torch.zeros((), dtype=torch.uint8,
                                device=frames_u8.device), frames_u8)
    x = x.reshape(t, h // 3, 3, w // 3, 3, 3)
    return x.permute(0, 1, 2, 4, 5, 3).reshape(t, h // 3, 27, w // 3) \
        .contiguous()


def s2d_unpack_torch(planar: torch.Tensor) -> torch.Tensor:
    """(T, H3, 27, W3) -> (T, 3*H3, 3*W3, 3), same dtype and device."""
    t, h3, _, w3 = planar.shape
    x = planar.reshape(t, h3, 3, 3, 3, w3)                # t h3 dh dw ch w3
    return x.permute(0, 1, 2, 5, 3, 4).reshape(t, 3 * h3, 3 * w3, 3)
