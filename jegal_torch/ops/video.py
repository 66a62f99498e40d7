"""Face masking of the GestSync input (the JAX package's ops/video.py:28-44)
and the host's space-to-depth repack into planar frames (its
host/media.py:116, C++ decoder.cc:509-545).

uint8 decoder frames (already resized to 270x480) -> float /255 -> the rows
above each frame's chin line zeroed -> +/-12 frames of edge-repeat padding.
Without chin rows, the reference's face-None branch masks the top 111 rows
(cv2.rectangle (0,0)-(w,110) fills rows 0..110, inference_embs.py:262-264).

Planar frames are the same pixels, masked and repacked on the host:
(T, H, W, 3) -> (T, H/3, 27, W/3) uint8 with channel (dh*3+dw)*3+ch, the
stem's 3x3 space-to-depth blocks. The stem reads them as uint8
(ops/kernels/stem.stem_pool_planar).
"""

from __future__ import annotations

import numpy as np
import torch

from jegal_torch.config import EDGE_PAD_FRAMES as EDGE_PAD

FALLBACK_ROWS = 111


def s2d_repack(frames_u8, cut_rows=None) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, H/3, 27, W/3) uint8 planar frames:
    out[t, h3, (dh*3+dw)*3+ch, w3] = frames[t, 3*h3+dh, 3*w3+dw, ch], with
    raw rows h < cut_rows[t] zeroed (no rows without cut_rows). Bit-exact
    with the JAX package's C++ repack: a cut of 0 or below masks nothing,
    a cut past H masks the whole frame."""
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


def s2d_unpack(planar):
    """Inverse of s2d_repack on a tensor: (T, H3, 27, W3) -> (T, 3*H3,
    3*W3, 3), same dtype and device."""
    t, h3, _, w3 = planar.shape
    x = planar.reshape(t, h3, 3, 3, 3, w3)                # t h3 dh dw ch w3
    return x.permute(0, 1, 2, 5, 3, 4).reshape(t, 3 * h3, 3 * w3, 3)


def edge_pad(x, before: int = EDGE_PAD, after: int = EDGE_PAD):
    """Repeat the first frame `before` times and the last `after` times
    along axis 0."""
    return torch.cat([x[:1].expand(before, *x.shape[1:]), x,
                      x[-1:].expand(after, *x.shape[1:])], dim=0)


def mask_frames_device(frames_u8, y2=None):
    """frames_u8: (T, H, W, 3) uint8 tensor -> (T + 24, H, W, 3) float32 in
    [0, 1], masked and edge-padded, on the frames' device.

    y2: per-frame chin rows (T,) (clipped to [0, H]), or None for the
    111-row fallback mask."""
    t, h = frames_u8.shape[:2]
    x = frames_u8.to(torch.float32) / 255.0
    rows = torch.arange(h, device=x.device).reshape(1, h, 1, 1)
    if y2 is None:
        cut = torch.full((t, 1, 1, 1), FALLBACK_ROWS, device=x.device)
    else:
        cut = torch.as_tensor(y2, device=x.device).to(torch.int64)
        cut = cut.clamp(0, h).reshape(t, 1, 1, 1)
    return edge_pad(torch.where(rows < cut, torch.zeros((), device=x.device),
                                x))
