"""Holistic keypoint backend (pluggable; the JAX package's
host/keypoints.py).

The reference uses MediaPipe Holistic (an external pretrained C++ graph,
inference_embs.py:27,155-193; preprocess/extract_kps.py) for face masking,
gesture-visibility checks, and upper-body crop guidance. MediaPipe is an
external model dependency, not part of this framework; when its wheel is
present we use it, otherwise callers fall back to keypoint-free paths
(host/masking.py documents the fallback).

Keypoint dict format (per frame): {"pose": [...], "left_hand": [...],
"right_hand": [...], "face": [...]} with normalized {x, y, z, visibility}
landmark dicts, matching the reference's protobuf_to_dict output
(inference_embs.py:177-189) and the extract_kps.py pkl schema.
"""

from __future__ import annotations

import pickle


def _landmarks_to_list(landmarks):
    if landmarks is None:
        return None
    return [
        {"x": lm.x, "y": lm.y, "z": lm.z,
         "visibility": getattr(lm, "visibility", 0.0)}
        for lm in landmarks.landmark
    ]


def extract_keypoints(frames, min_detection_confidence: float = 0.5,
                      min_tracking_confidence: float = 0.5):
    """frames: (T, H, W, 3) uint8 RGB -> list of per-frame keypoint dicts.

    Raises RuntimeError when no MediaPipe wheel is installed (callers fall
    back to keypoint-free masking).
    """
    try:
        import mediapipe as mp
    except ImportError as e:
        raise RuntimeError("mediapipe is not installed") from e

    out = []
    with mp.solutions.holistic.Holistic(
        min_detection_confidence=min_detection_confidence,
        min_tracking_confidence=min_tracking_confidence,
    ) as holistic:
        for frame in frames:
            res = holistic.process(frame)
            out.append({
                "pose": _landmarks_to_list(res.pose_landmarks),
                "left_hand": _landmarks_to_list(res.left_hand_landmarks),
                "right_hand": _landmarks_to_list(res.right_hand_landmarks),
                "face": _landmarks_to_list(res.face_landmarks),
            })
    return out


def save_keypoints(keypoints, resolution, path: str):
    """extract_kps.py-compatible pkl: {"kps": [...], "resolution": (H,W,3)}."""
    with open(path, "wb") as f:
        pickle.dump({"kps": keypoints, "resolution": tuple(resolution)}, f)


def load_keypoints(path: str):
    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["kps"], d["resolution"]
