"""Face masking + resize for the GestSync input (host-side, pure numpy; the
JAX package's host/masking.py).

Replicates reference load_rgb_masked_frames (inference_embs.py:235-286):
per frame, black out everything above the chin line (face-oval bbox max-y +
15 px) so the sync model sees only gestures; resize to 480x270; scale to
[0,1]; edge-pad +/-12 frames.

Keypoints come from a pluggable backend (MediaPipe Holistic in the
reference — an external pretrained C++ graph, inference_embs.py:27,155-193).
When no keypoint backend is available, the `face=None` branch of the
reference is used for every frame: resize then mask the top 110 rows
(inference_embs.py:262-264) — a documented, principled fallback.
"""

from __future__ import annotations

import numpy as np

from jegal_torch.config import EDGE_PAD_FRAMES as EDGE_PAD

WIDTH, HEIGHT = 480, 270

# face-oval landmark indices (MediaPipe FaceMesh oval, reference
# inference_embs.py:250-251)
FACE_OVAL_IDX = [10, 21, 54, 58, 67, 93, 103, 109, 127, 132, 136, 148, 149,
                 150, 152, 162, 172, 176, 234, 251, 284, 288, 297, 323, 332,
                 338, 356, 361, 365, 377, 378, 379, 389, 397, 400, 454]


def resize_bilinear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Bilinear resize with half-pixel centers (cv2 INTER_LINEAR semantics),
    vectorized numpy. img: (H, W, C) uint8/float -> (out_h, out_w, C)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    sy, sx = h / out_h, w / out_w
    ys = (np.arange(out_h) + 0.5) * sy - 0.5
    xs = (np.arange(out_w) + 0.5) * sx - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    im = img.astype(np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if img.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def face_bbox_bottom(face_landmarks, resolution) -> int:
    """Chin line: max y of the face-oval landmarks, in pixels.

    face_landmarks: sequence of {x, y} normalized coords (len 468+).
    """
    ys = [
        int(face_landmarks[i]["y"] * resolution[0])
        for i in FACE_OVAL_IDX
        if i < len(face_landmarks)
    ]
    return max(ys)


def mask_frames(frames: np.ndarray, keypoints=None) -> np.ndarray:
    """frames: (T, H, W, 3) uint8 -> masked (T + 24, 270, 480, 3) float32
    in [0, 1], edge-padded +/-12 frames (GestSync input contract).

    keypoints: optional per-frame dicts with a 'face' entry (list of
    normalized landmarks) as produced by a Holistic-style backend; None (or
    per-frame face=None) falls back to the top-110-rows mask after resize.
    """
    t, h, w = frames.shape[:3]
    out = np.empty((t, HEIGHT, WIDTH, 3), dtype=np.float32)
    for i in range(t):
        img = frames[i]
        face = None
        if keypoints is not None and i < len(keypoints):
            face = keypoints[i].get("face")
        # cv2.rectangle with thickness=-1 fills the bottom row INCLUSIVE:
        # (0,0)-(w,110) masks rows 0..110 (111 rows); (0,0)-(w,y2+15) masks
        # rows 0..y2+15 (reference inference_embs.py:264,275)
        if face is None:
            small = resize_bilinear(img, WIDTH, HEIGHT).astype(np.float32)
            small[:111, :, :] = 0.0
            out[i] = small / 255.0
        else:
            img = img.astype(np.float32).copy()
            y2 = face_bbox_bottom(face, (h, w))
            img[: min(h, y2 + 16), :, :] = 0.0
            out[i] = resize_bilinear(img, WIDTH, HEIGHT) / 255.0
    return np.pad(out, ((EDGE_PAD, EDGE_PAD), (0, 0), (0, 0), (0, 0)), "edge")


def check_visible_gestures(keypoints) -> bool:
    """Gesture-visibility gate (reference inference_embs.py:195-233): reject
    when >70% of frames lack both hands or <30% of frames have pose.
    With no keypoint backend (keypoints None) the gate is skipped."""
    if keypoints is None:
        return True
    if len(keypoints) < 25:
        # reference returns (None, None) here and the caller ignores the
        # return entirely (inference_embs.py:200-201,555) — proceed
        return True
    handless = sum(
        1 for k in keypoints
        if k.get("pose") is not None
        and k.get("left_hand") is None and k.get("right_hand") is None
    )
    with_pose = sum(1 for k in keypoints if k.get("pose") is not None)
    n = len(keypoints)
    return not (handless / n > 0.7 or with_pose / n < 0.3)
