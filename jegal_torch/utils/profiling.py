"""Tracing and timing utilities (the JAX package's utils/profiling.py).

`trace` records a torch.profiler trace (host activity on every thread,
where the installed torch can, and CUDA activity on the card) and writes
it into a directory as a Chrome trace (open it in Perfetto or
chrome://tracing); `annotate` opens a named span in it, the only way the
port does, and costs one flag check when no profiler runs; `time_jitted`
times a function on the card with CUDA events, and on the host clock for
CPU results.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write `<log_dir>/trace-<pid>-<n>.json`
    (Chrome trace format). CUDA activity is recorded when a card is
    present, and the spans of every thread (the prep pool's too) where
    the installed torch can record them."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_all_threads()) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace-")])
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace-{os.getpid()}-{n}.json"))


def _all_threads():
    """Kineto's setting that records the host events of every thread, or
    None (the calling thread alone) where the installed torch lacks it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named span of the running profiler's trace
    (torch.profiler.record_function), or, with no profiler running, one
    shared null context: a span then costs a flag check, not a dispatcher
    call. The flag is the process's, so a span on a worker thread opens
    too (`trace` records it; a profiler of the calling thread alone drops
    it)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _cuda_tensors(out):
    """The CUDA tensors in `out`: a tensor, or a dict / list / tuple of
    them."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_cuda else []
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _cuda_tensors(v)]
    return []


def device_sync(out) -> None:
    """Wait for the device work behind every CUDA tensor in `out`."""
    for dev in {t.device for t in _cuda_tensors(out)}:
        torch.cuda.synchronize(dev)


def time_jitted(fn, args, iters: int = 10, warmup: int = 1) -> float:
    """Steady-state seconds a call of fn(*args): `iters` calls queued back
    to back after `warmup` calls. When fn returns CUDA tensors the span is
    taken by CUDA events on their device's current stream, else on the
    host clock."""
    for _ in range(warmup):
        out = fn(*args)
    device_sync(out)
    on_card = _cuda_tensors(out)
    if on_card:
        dev = on_card[0].device
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        for _ in range(iters):
            out = fn(*args)
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters

