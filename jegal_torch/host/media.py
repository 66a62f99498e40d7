"""ctypes bindings to the port's native host runtime: the libav media
runtime (host/csrc/decoder.cc, the JAX package's host/media.py) and the
space-to-depth repack (host/csrc/repack.cc).

In-process C++ decode and encode in place of the reference's decord and
ffmpeg subprocesses (inference_embs.py:123-151,433-473). Each shared
library is built with g++ at first use, never at import:

    g++ -O2 -shared -fPIC decoder.cc -o decoder-<digest>.so
        -lavformat -lavcodec -lavutil -lswscale -lswresample
    g++ -O2 -shared -fPIC repack.cc -o repack-<digest>.so

into build/jegal_torch_host/ at the repository root, named by a digest of
the source and the command, so an edited source is rebuilt and a stale
library is never loaded. The repack needs no libav, so it builds (and the
server repacks raw frames) where libav is absent. Every native call goes
through ctypes, which releases the GIL, so decode threads run in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "decoder.cc"
REPACK_SRC = SRC.with_name("repack.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jegal_torch_host"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lswresample")

_lock = threading.Lock()
_lib = None             # the decoder
_repack_lib = None


class _JegalVideo(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("nframes", ctypes.c_int64),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("fps", ctypes.c_double),
    ]


class _JegalAudio(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_int16)),
        ("nsamples", ctypes.c_int64),
        ("sample_rate", ctypes.c_int),
    ]


def _library_path(src: Path, libs: tuple) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + libs).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _build(src: Path, libs: tuple, what: str) -> Path:
    """Compile `src` unless an up-to-date library exists -> its path. A
    failed compile raises with g++'s output."""
    lib = _library_path(src, libs)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, str(src), "-o", str(tmp), *libs]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the {what} failed:\n"
                           f"{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, lib)
    return lib


def library_path() -> Path:
    """Where the decoder built from the present source lives."""
    return _library_path(SRC, LIBS)


def build_library() -> Path:
    """Compile the libav decoder unless an up-to-date library exists ->
    its path."""
    return _build(SRC, LIBS, "libav decoder")


def repack_library_path() -> Path:
    """Where the repack built from the present source lives."""
    return _library_path(REPACK_SRC, ())


def build_repack_library() -> Path:
    """Compile the repack (no libav) unless an up-to-date library exists
    -> its path."""
    return _build(REPACK_SRC, (), "s2d repack")


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.jegal_decode_video.restype = ctypes.POINTER(_JegalVideo)
            lib.jegal_decode_video.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double]
            lib.jegal_free_video.argtypes = [ctypes.POINTER(_JegalVideo)]
            lib.jegal_decode_audio.restype = ctypes.POINTER(_JegalAudio)
            lib.jegal_decode_audio.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.jegal_free_audio.argtypes = [ctypes.POINTER(_JegalAudio)]
            lib.jegal_encode_video.restype = ctypes.c_int
            lib.jegal_encode_video.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double]
            lib.jegal_encode_av.restype = ctypes.c_int
            lib.jegal_encode_av.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int]
            _lib = lib
    return _lib


def get_repack_lib():
    """The repack library, built and loaded at first use; a failed build
    or load raises (OSError, RuntimeError)."""
    global _repack_lib
    with _lock:
        if _repack_lib is None:
            lib = ctypes.CDLL(str(build_repack_library()))
            lib.jegal_s2d_repack.restype = ctypes.c_int
            lib.jegal_s2d_repack.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8)]
            _repack_lib = lib
    return _repack_lib


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_video(path: str, target_w: int = 0, target_h: int = 0,
                 target_fps: float = 0.0) -> tuple[np.ndarray, float]:
    """-> (frames (N, H, W, 3) uint8 RGB, fps). target dims/fps 0 = native."""
    lib = _get_lib()
    ptr = lib.jegal_decode_video(path.encode(), target_w, target_h, target_fps)
    if not ptr:
        raise IOError(f"could not decode video: {path}")
    try:
        v = ptr.contents
        n = int(v.nframes) * v.height * v.width * 3
        arr = np.ctypeslib.as_array(v.data, shape=(n,)).reshape(
            int(v.nframes), v.height, v.width, 3).copy()
        return arr, float(v.fps)
    finally:
        lib.jegal_free_video(ptr)


def decode_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    """-> mono samples at sample_rate, float32 at raw int16 scale (the
    reference's wav convention, utils/audio_utils.py:20-25)."""
    lib = _get_lib()
    ptr = lib.jegal_decode_audio(path.encode(), sample_rate)
    if not ptr:
        raise IOError(f"could not decode audio: {path}")
    try:
        a = ptr.contents
        arr = np.ctypeslib.as_array(a.data, shape=(int(a.nsamples),)).copy()
        return arr.astype(np.float32)
    finally:
        lib.jegal_free_audio(ptr)


def s2d_repack(frames: np.ndarray, cut_rows: np.ndarray | None = None
               ) -> np.ndarray:
    """The C++ twin of ops/video.s2d_repack, bit for bit: (T, H, W, 3)
    uint8 -> planar (T, H/3, 27, W/3) uint8 with c = (dh*3+dw)*3+ch, raw
    rows h < cut_rows[t] zeroed. Runs on the decode thread, the GIL
    released. Needs no libav."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, c = frames.shape
    if c != 3 or h % 3 or w % 3:
        raise ValueError(f"frames must be (T, H, W, 3) with H and W multiples "
                         f"of 3, got {frames.shape}")
    out = np.empty((t, h // 3, 27, w // 3), np.uint8)
    cuts = None
    if cut_rows is not None:
        cuts = np.ascontiguousarray(cut_rows, dtype=np.int32)
        if cuts.shape != (t,):
            raise ValueError(f"cut_rows must be ({t},), got {cuts.shape}")
    lib = get_repack_lib()
    rc = lib.jegal_s2d_repack(
        _u8(frames), t, h, w,
        None if cuts is None
        else cuts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _u8(out))
    if rc != 0:
        raise ValueError(f"s2d repack failed ({rc}): shape {frames.shape}")
    return out


def encode_video(path: str, frames: np.ndarray, fps: float = 25.0) -> None:
    """frames: (N, H, W, 3) uint8 RGB -> video file (mpeg4; .avi as the
    reference's XVID track writer)."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"frames must be RGB, got {frames.shape}")
    rc = _get_lib().jegal_encode_video(path.encode(), _u8(frames), n, w, h,
                                       fps)
    if rc != 0:
        raise IOError(f"video encode failed ({rc}): {path}")


def encode_av(path: str, frames: np.ndarray, samples: np.ndarray,
              fps: float = 25.0, sample_rate: int = 16000) -> None:
    """Mux video and mono audio into one container (mpeg4 + AAC), the
    reference's merge step (dataset/preprocess_videos.py:503-545).

    frames: (N, H, W, 3) uint8 RGB; samples: mono int16-scale audio."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    n, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"frames must be RGB, got {frames.shape}")
    rc = _get_lib().jegal_encode_av(
        path.encode(), _u8(frames), n, w, h, fps,
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(samples), sample_rate)
    if rc != 0:
        raise IOError(f"a/v encode failed ({rc}): {path}")


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 16000) -> None:
    from scipy.io import wavfile

    wavfile.write(path, sample_rate, samples.astype(np.int16))


def load_audio_any(path: str, sample_rate: int = 16000) -> np.ndarray:
    """Audio from a .wav (scipy) or any container (the native decoder)."""
    if path.endswith(".wav"):
        from jegal_torch.ops.audio import load_wav

        return load_wav(path)
    return decode_audio(path, sample_rate)
