"""Speaker detect/track/crop preprocessing (L1 of the pipeline; the JAX
package's host/preprocess.py).

Re-implements the reference preprocess stage (preprocess/
inference_preprocess.py — ffmpeg shell-outs -> 25 fps video + 16 kHz wav;
YOLOv9 person boxes; greedy IOU tracker; median-filter smoothing; keypoint-
guided upper-body crop; per-track .avi/.wav + tracks.pkl) on top of the
port's native in-process media runtime (jegal_torch/host/media.py) with
pluggable external-model backends:

  detector:  frames -> per-frame [(x1, y1, x2, y2, conf), ...] person boxes
             (the reference's YOLOv9; ultralytics is used if installed)
  keypoints: jegal_torch.host.keypoints backend (MediaPipe when installed)

Intentional fixes of reference defects (SURVEY.md §2.9), as in the JAX
package:
  * defect 7 — IOU typo `yB = min(boxB[3], boxB[3])` is corrected to use
    boxA[3]; the broken version under-computes intersections.
  * defect 8/9 — cv2.resize argument swap that transposed non-square crops;
    we resize to (max_h, max_w) consistently.
"""

from __future__ import annotations

import os
import pickle
import shutil

import numpy as np
from scipy import signal
from scipy.interpolate import interp1d

from jegal_torch.config import (
    CROP_SCALE,
    DETECTOR_CONF,
    IOU_THRESHOLD,
    MEDFILT_KERNEL,
    MIN_FRAME_SIZE,
    MIN_TRACK,
    NUM_FAILED_DET,
    TIGHT_SCALE,
)
from jegal_torch.host.masking import resize_bilinear

PAD_VALUE = 110  # constant-pad gray used by the reference crop (":345")


def iou(box_a, box_b) -> float:
    """Intersection-over-union (reference bug at inference_preprocess.py:56
    fixed: intersection bottom uses BOTH boxes)."""
    xa = max(box_a[0], box_b[0])
    ya = max(box_a[1], box_b[1])
    xb = min(box_a[2], box_b[2])
    yb = min(box_a[3], box_b[3])
    inter = max(0, xb - xa) * max(0, yb - ya)
    area_a = (box_a[2] - box_a[0]) * (box_a[3] - box_a[1])
    area_b = (box_b[2] - box_b[0]) * (box_b[3] - box_b[1])
    denom = float(area_a + area_b - inter)
    return inter / denom if denom > 0 else 0.0


def detect_persons(frames, detector, conf_threshold: float = DETECTOR_CONF,
                   padding: int = 5):
    """-> per-frame list of {'frame', 'bbox', 'conf'} person detections,
    boxes padded and clamped (reference detect_speaker :260-283)."""
    h, w = frames.shape[1:3]
    dets = []
    for fidx in range(len(frames)):
        boxes = detector(frames[fidx])
        frame_dets = []
        for (x1, y1, x2, y2, conf) in boxes:
            if conf <= conf_threshold:
                continue
            frame_dets.append({
                "frame": fidx,
                "bbox": [max(0, int(x1) - padding), max(0, int(y1) - padding),
                         min(w, int(x2) + padding), min(h, int(y2) + padding)],
                "conf": float(conf),
            })
        dets.append(frame_dets)
    return dets


def track_speakers(dets, iou_threshold: float = IOU_THRESHOLD,
                   num_failed_det: int = NUM_FAILED_DET,
                   min_track: int = MIN_TRACK,
                   min_frame_size: int = MIN_FRAME_SIZE):
    """Greedy IOU tracker with gap tolerance + box interpolation
    (reference track_speakers :70-123). Consumes `dets` destructively."""
    tracks = []
    while True:
        track = []
        for frame_dets in dets:
            for det in list(frame_dets):
                if not track:
                    track.append(det)
                    frame_dets.remove(det)
                elif det["frame"] - track[-1]["frame"] <= num_failed_det:
                    if iou(det["bbox"], track[-1]["bbox"]) > iou_threshold:
                        track.append(det)
                        frame_dets.remove(det)
                else:
                    break
        if not track:
            break
        if len(track) > min_track:
            framenum = np.array([d["frame"] for d in track])
            bboxes = np.array([d["bbox"] for d in track], dtype=np.float64)
            frame_i = np.arange(framenum[0], framenum[-1] + 1)
            bboxes_i = np.stack(
                [interp1d(framenum, bboxes[:, j])(frame_i) for j in range(4)],
                axis=1,
            )
            mean_w = np.mean(bboxes_i[:, 2] - bboxes_i[:, 0])
            mean_h = np.mean(bboxes_i[:, 3] - bboxes_i[:, 1])
            if max(mean_w, mean_h) > min_frame_size:
                tracks.append({"frame": frame_i, "bbox": bboxes_i})
    return tracks


def smooth_track(track, tight_scale: float = TIGHT_SCALE,
                 kernel: int = MEDFILT_KERNEL):
    """Tight-scale + median-filter the track into center/size series
    (reference crop_video :314-330)."""
    boxes = track["bbox"]
    width = (boxes[:, 2] - boxes[:, 0]) * tight_scale
    height = (boxes[:, 3] - boxes[:, 1]) * tight_scale
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    size = np.maximum(width, height) / 2
    # fixed kernel like the reference (scipy medfilt zero-pads short tracks)
    return {
        "s": signal.medfilt(size, kernel_size=kernel),
        "x": signal.medfilt(cx, kernel_size=kernel),
        "y": signal.medfilt(cy, kernel_size=kernel),
    }


def crop_track_frames(frames, track, proc, crop_scale: float = CROP_SCALE):
    """Per-frame padded crop around the smoothed box, resized to the track's
    max dimensions (reference crop_video :339-363, with the resize-transpose
    defect fixed)."""
    crops = []
    for i, fidx in enumerate(track["frame"]):
        cs = crop_scale
        bs = proc["s"][i]
        bsi = int(bs * (1 + 2 * cs))
        frame = np.pad(frames[int(fidx)],
                       ((bsi, bsi), (bsi, bsi), (0, 0)),
                       constant_values=PAD_VALUE)
        my = proc["y"][i] + bsi
        mx = proc["x"][i] + bsi
        crop = frame[int(my - bs): int(my + bs * (1 + 2 * cs)),
                     int(mx - bs * (1 + cs)): int(mx + bs * (1 + cs))]
        crops.append(crop)
    max_h = max(c.shape[0] for c in crops)
    max_w = max(c.shape[1] for c in crops)
    return [resize_bilinear(c, max_w, max_h) for c in crops]


def upper_body_crop(frames, pose_kps, padding_x: int = 25,
                    padding_y: int = -15, conf: float = 0.7):
    """Keypoint-guided crop: gesture-arm x-extents + hip waistline
    (reference adjust_bbox_kps :170-238). pose_kps: (T, 33, 3) pixel-space
    (x, y, visibility) arrays, or None -> unchanged frames."""
    if pose_kps is None or len(pose_kps) == 0:
        return frames
    LEFT = [12, 14, 16, 18, 20, 22, 24]
    RIGHT = [11, 13, 15, 17, 19, 21, 23]
    L_HIP, R_HIP = 23, 24

    left_xs, right_xs, waist_ys = [], [], []
    for kps in pose_kps:
        lk = [kps[i] for i in LEFT if kps[i][2] > conf]
        rk = [kps[i] for i in RIGHT if kps[i][2] > conf]
        if lk:
            left_xs.append(min(k[0] for k in lk))
        if rk:
            right_xs.append(max(k[0] for k in rk))
        if kps[L_HIP][2] > conf and kps[R_HIP][2] > conf:
            waist_ys.append((kps[L_HIP][1] + kps[R_HIP][1]) / 2)

    h, w = frames[0].shape[:2]
    n = len(pose_kps)
    left_x = int(min(left_xs)) - padding_x if left_xs and len(left_xs) / n > 0.7 else 0
    right_x = int(max(right_xs)) + padding_x if right_xs and len(right_xs) / n > 0.7 else w
    new_y2 = int(np.mean(waist_ys)) + padding_y if waist_ys and len(waist_ys) / n > 0.7 else h
    left_x = max(0, left_x)
    right_x = min(w, right_x)
    new_y2 = min(new_y2, h)
    return [f[:new_y2, left_x:right_x] for f in frames]


def _default_detector():
    try:
        from ultralytics import YOLO
    except ImportError as e:
        raise RuntimeError(
            "no person-detector backend installed (ultralytics YOLO); pass "
            "`detector=` explicitly") from e
    model = YOLO("yolov9c.pt")

    def detect(frame):
        results = model(frame, verbose=False)
        out = []
        for det in results[0].boxes:
            if int(det.cls[0]) == 0:  # COCO person
                x1, y1, x2, y2 = [float(v) for v in det.xyxy[0]]
                out.append((x1, y1, x2, y2, float(det.conf[0])))
        return out

    return detect


def _pose_pixel_kps(frames):
    """Holistic pose keypoints in pixel space, or None without a backend."""
    try:
        from jegal_torch.host.keypoints import extract_keypoints
    except ImportError:
        return None
    try:
        kps = extract_keypoints(frames)
    except RuntimeError:
        return None
    h, w = frames[0].shape[:2]
    out = []
    for k in kps:
        if k["pose"] is None:
            continue
        out.append(np.array([[p["x"] * w, p["y"] * h, p["visibility"]]
                             for p in k["pose"]]))
    return np.array(out) if out else None


def process_video(video_file: str, preprocessed_root: str, fps: float = 25.0,
                  sample_rate: int = 16000, detector=None,
                  keypoint_fn=_pose_pixel_kps,
                  merge_dir: str | None = None) -> dict:
    """Full L1 stage: raw video -> `<root>/preprocessed/%05d.avi/.wav` +
    tracks.pkl (reference process_video :400-476, in-memory, no temp dirs).

    merge_dir: also write `<merge_dir>/<fname>_%05d.mp4` per track with the
    crop video AND its audio muxed into one container — the reference's
    filter_and_merge visualization outputs
    (dataset/preprocess_videos.py:503-545), via the native A/V encoder
    instead of an ffmpeg two-input shell-out."""
    from jegal_torch.host import media

    fname = os.path.basename(video_file).split(".")[0]
    dest = os.path.join(preprocessed_root, fname, "preprocessed")
    if os.path.exists(dest):
        shutil.rmtree(dest)
    os.makedirs(dest)

    frames, _ = media.decode_video(video_file, target_fps=fps)
    try:
        wav = media.decode_audio(video_file, sample_rate)
    except IOError:
        wav = None  # video without an audio stream: emit crops only

    detector = detector or _default_detector()
    dets = detect_persons(frames, detector)
    with open(os.path.join(dest, "person.pkl"), "wb") as f:
        pickle.dump(dets, f)
    tracks = track_speakers([list(d) for d in dets])
    if not tracks:
        return {"tracks": 0, "dest": dest}

    vidtracks = []
    for i, track in enumerate(tracks):
        proc = smooth_track(track)
        crops = crop_track_frames(frames, track, proc)
        crops = upper_body_crop(crops, keypoint_fn(np.asarray(crops))
                                if keypoint_fn else None)
        base = os.path.join(dest, "%05d" % i)
        media.encode_video(base + ".avi", np.asarray(crops, np.uint8), fps)
        track_wav = None
        if wav is not None:
            start = int(track["frame"][0] / fps * sample_rate)
            end = int((track["frame"][-1] + 1) / fps * sample_rate)
            track_wav = wav[start:end]
            media.write_wav(base + ".wav", track_wav, sample_rate)
        if merge_dir is not None and track_wav is not None:
            os.makedirs(merge_dir, exist_ok=True)
            media.encode_av(
                os.path.join(merge_dir, f"{fname}_{i:05d}.mp4"),
                np.asarray(crops, np.uint8), track_wav, fps, sample_rate)
        vidtracks.append({"track": {"frame": track["frame"],
                                    "bbox": track["bbox"]},
                          "proc_track": proc})

    with open(os.path.join(dest, "tracks.pkl"), "wb") as f:
        pickle.dump(vidtracks, f)
    return {"tracks": len(tracks), "dest": dest}


def filter_copy(csv_path: str, initial_dir: str, final_dir: str) -> dict:
    """Copy the crops a filtered dataset CSV selects into the final tree.

    Replicates the rsync half of the reference's filter_and_merge
    (dataset/preprocess_videos.py:534-548): for each `filename` row (a
    relative path like `<video_id>/preprocessed/00000`), copy
    `<initial_dir>/<filename>.avi` and `.wav` to the same relative path
    under `final_dir` (parents created). Missing files are skipped and
    counted, like the reference's non-fatal rsync failures.
    """
    import csv as _csv

    stats = {"copied": 0, "missing": 0}
    with open(csv_path, newline="") as f:
        rows = list(_csv.DictReader(f))
    for row in rows:
        rel = row["filename"]
        for ext in (".avi", ".wav"):
            src = os.path.join(initial_dir, rel + ext)
            if not os.path.exists(src):
                stats["missing"] += 1
                continue
            dst = os.path.join(final_dir, rel + ext)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy2(src, dst)
            stats["copied"] += 1
    return stats
