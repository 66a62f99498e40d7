"""Build, load and count the port's CUDA kernels.

Every `.cu` file under jegal_torch/csrc/ is compiled at first use, each by
its own `nvcc` process (all started together), into a shared library with a
plain C interface under build/jegal_torch_kernels/ at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <name>-<digest>.so <name>.cu

The digest covers the source, every header in csrc/ and the flags, so an
edited source is rebuilt and a stale library is never loaded. Libraries are
loaded with ctypes; every pointer and the stream pass as c_void_p. Each
entry point returns 0 or a CUDA error code, which `check` turns into an
exception.

`LAUNCHES` holds one integer per kernel: its wrapper adds one where it
launches the kernel (on a CUDA tensor), and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "jegal_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"stem_pool": 0, "stem_pool_planar": 0, "stem_band": 0,
            "conv2": 0, "attn_sublayer": 0, "ffn_sublayer": 0,
            "encoder_stack": 0, "flash_attention": 0}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu that has no up-to-date library, all in
    parallel. -> {source stem: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {src.stem: _target(src) for src in sorted(CSRC.glob("*.cu"))}
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out[src.stem]
        if lib.exists():
            continue
        tmp = lib.parent / f"{lib.name}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, lib, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu (builds all at first
    use)."""
    with _lock:
        if not _libs:
            for stem, path in build_all().items():
                lib = ctypes.CDLL(str(path))
                lib.jt_error_string.argtypes = [ctypes.c_int]
                lib.jt_error_string.restype = ctypes.c_char_p
                _libs[stem] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.jt_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: error {rc} ({msg})")


def refuse_grad(what: str, *operands) -> None:
    """Raise when autograd would need a gradient through a kernel that has
    none: the kernels write into fresh buffers through ctypes, so their
    output would carry no grad_fn and a training step would silently train
    nothing. Inference runs under torch.no_grad() or inference_mode();
    training takes the differentiable paths (fused=False, and
    flash_attention.flash_attention_diff)."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise RuntimeError(
            f"the {what} has no backward and an operand requires grad: run "
            f"it under torch.no_grad(), or take the differentiable path")


def check_operand(name: str, t, shape, device) -> None:
    """Raise unless `t` is a contiguous float32 tensor of `shape` on
    `device`: what every kernel of this package takes."""
    import torch

    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel's input on "
                         f"{device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the kernel, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t) -> ctypes.c_void_p | None:
    """Device pointer of a tensor (None -> a null pointer)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
