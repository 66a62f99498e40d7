"""Tracing and timing utilities (the JAX package's utils/profiling.py).

`trace` records a torch.profiler trace (host and, on the card, CUDA
activity) and writes it into a directory as a Chrome trace (open it in
Perfetto or chrome://tracing); `annotate` names a region inside it; the
stage timers accumulate the host pipeline's wall seconds; `time_jitted`
times a function on the card with CUDA events, and on the host clock for
CPU results.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write `<log_dir>/trace-<pid>-<n>.json`
    (Chrome trace format). CUDA activity is recorded when a card is
    present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace-")])
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace-{os.getpid()}-{n}.json"))


def annotate(name: str):
    """A named region inside a trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


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


class StageTimers:
    """Accumulating wall-clock timers for host pipeline stages.

    with timers.stage("decode"): ...
    print(timers.report())
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        return json.dumps({
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_s": round(v / max(self.counts[k], 1), 4)}
            for k, v in sorted(self.totals.items())
        })
