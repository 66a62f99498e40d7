"""Dataset video download (L0; the JAX package's data/download.py).

Mirrors reference dataset/download_videos.py: CSV rows (video_id,
start_time, end_time) -> yt-dlp section downloads named
`<video_id>_<start>_<end>.mp4`, with validity checking and a bounded thread
pool. yt-dlp is an external tool (network access required); it is probed at
call time and a clear error is raised when unavailable, keeping the rest of
the package importable offline.

Over the reference (SURVEY.md §5.3): a structured per-file error ledger
instead of print-and-continue, and validity probing via the port's native
libav runtime instead of an ffmpeg subprocess. The CSV is read with the
stdlib (data/datasets.read_csv, typed as pandas types it), since the card
machine's image has no pandas.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor


def is_valid_video(path: str) -> bool:
    """A downloaded file is valid if the native runtime can decode a frame
    (reference download_videos.py:19-50 used an ffmpeg probe)."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return False
    try:
        from jegal_torch.host import media

        frames, _ = media.decode_video(path, target_w=64, target_h=64)
        return frames.shape[0] > 0
    except Exception:
        return False


def download_clip(video_id: str, start: float, end: float, out_dir: str,
                  ytdlp: str = "yt-dlp") -> dict:
    out = os.path.join(out_dir, f"{video_id}_{start}_{end}.mp4")
    if os.path.exists(out) and is_valid_video(out):  # idempotent resume
        return {"file": out, "status": "skipped"}
    cmd = [
        ytdlp, f"https://www.youtube.com/watch?v={video_id}",
        "--download-sections", f"*{start}-{end}",
        "-f", "mp4", "-o", out, "--quiet", "--no-warnings",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=600)
    except Exception as e:
        return {"file": out, "status": "error", "error": str(e)}
    if not is_valid_video(out):
        return {"file": out, "status": "invalid"}
    return {"file": out, "status": "done"}


def download_dataset(csv_path: str, video_root: str, workers: int = 8) -> dict:
    """CSV columns: video_id, start_time, end_time (the AVS CSV schema)."""
    from jegal_torch.data.datasets import read_csv

    if shutil.which("yt-dlp") is None:
        raise RuntimeError(
            "yt-dlp is not installed (and this environment has no network "
            "egress); dataset download requires it")
    rows = read_csv(csv_path)
    os.makedirs(video_root, exist_ok=True)
    stats = {"done": 0, "skipped": 0, "error": 0, "invalid": 0}
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [
            pool.submit(download_clip, str(r["video_id"]),
                        float(r["start_time"]), float(r["end_time"]),
                        video_root)
            for r in rows
        ]
        for f in futures:
            res = f.result()
            stats[res["status"]] = stats.get(res["status"], 0) + 1
            if res["status"] in ("error", "invalid"):
                print(json.dumps(res), file=sys.stderr)
    return stats
