"""Face masking of the GestSync input on the device (the JAX package's
ops/video.py:28-44).

uint8 decoder frames (already resized to 270x480) -> float /255 -> the rows
above each frame's chin line zeroed -> +/-12 frames of edge-repeat padding.
Without chin rows, the reference's face-None branch masks the top 111 rows
(cv2.rectangle (0,0)-(w,110) fills rows 0..110, inference_embs.py:262-264).
"""

from __future__ import annotations

import torch

from jegal_torch.config import EDGE_PAD_FRAMES as EDGE_PAD

FALLBACK_ROWS = 111


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
    x = torch.where(rows < cut, torch.zeros((), device=x.device), x)
    return torch.cat([x[:1].expand(EDGE_PAD, -1, -1, -1), x,
                      x[-1:].expand(EDGE_PAD, -1, -1, -1)], dim=0)
