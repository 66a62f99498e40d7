"""torch.profiler over a measured window, and the reduction of its trace.

`profiled`, `lead_in_split` and `device_sleep` are frozen copies of
chip_smoke.py's (:483, :1167, :1249; the repository root). torch.profiler
loses the first stretch of a window's device work (up to ~36 ms late in a
long process on the H100), so each window opens on a lead-in of 2 ms spin
kernels run to completion before the work; the loss falls on them, and
the readers skip them. Without it every idle share would read wrong.

The reduction: device intervals (kernels, memcpys, memsets) inside the
window span, their union (busy seconds), the idle gaps between them named
by the innermost host op the profiler saw at each gap's middle, and the
device ops that took the most time."""

from __future__ import annotations

import contextlib
import gc
import heapq
import time

import torch

LEAD_IN_KERNELS = 64
LEAD_IN_MS = 2.0
LEAD_IN_NAME = "spin_kernel"
SETTLE_S = 0.05
WINDOW_SPAN = "bench.window"


class _Sleep:
    cycles_per_ms = None


def device_sleep(ms: float):
    """Keep the device busy for about `ms` (torch.cuda._sleep, calibrated
    once against CUDA events)."""
    if _Sleep.cycles_per_ms is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _Sleep.cycles_per_ms = 1e7 / a.elapsed_time(b)
    torch.cuda._sleep(int(ms * _Sleep.cycles_per_ms))


@contextlib.contextmanager
def profiled(settle: float = SETTLE_S):
    """torch.profiler over the body (CPU and CUDA activity), the device
    idle `settle` s at each end, LEAD_IN_KERNELS spin kernels of
    LEAD_IN_MS run to completion before the body, and the garbage
    collector run first (a collection inside a window once lost a replay's
    first kernels). The body must leave its work synchronized; it runs
    inside the WINDOW_SPAN span, whose host interval is the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    gc.collect()
    device_sleep(0)                     # calibrated outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof.lead_in = LEAD_IN_KERNELS
        time.sleep(settle)
        for _ in range(prof.lead_in):
            device_sleep(LEAD_IN_MS)
        torch.cuda.synchronize()
        time.sleep(settle)
        with record_function(WINDOW_SPAN):
            yield prof
            torch.cuda.synchronize()
        time.sleep(settle)


def _is_device(e) -> bool:
    """A device op: a kernel, memcpy or memset (not the device-side copy
    of a host span, such as the optimizer's or this window's)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _is_host(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CPU


def lead_in_split(events, lead_in: int):
    """A window's device events in launch order -> (lead-in kernels lost,
    the events after the lead-in)."""
    dev = sorted((e for e in events if _is_device(e)),
                 key=lambda e: e.time_range.start)
    k = 0
    while k < len(dev) and LEAD_IN_NAME in dev[k].name:
        k += 1
    return lead_in - k, dev[k:]


def short_name(name: str) -> str:
    """A device op's name without its template and argument lists."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        if stop in name and not name.startswith(("Memcpy", "Memset")):
            name = name.split(stop)[0]
    return name.split(" (")[0][:100]


class Trace:
    """The reduced trace of one `profiled()` window."""

    def __init__(self, prof):
        events = list(prof.events())
        self.lost, dev = lead_in_split(events, prof.lead_in)
        spans = [e for e in events if e.name == WINDOW_SPAN and _is_host(e)]
        if not spans:
            raise RuntimeError("the profiler kept no window span")
        self.t0 = spans[0].time_range.start
        self.t1 = spans[0].time_range.end
        self.device = [(e.name, max(e.time_range.start, self.t0),
                        min(e.time_range.end, self.t1)) for e in dev
                       if e.time_range.end > self.t0
                       and e.time_range.start < self.t1]
        self.host = [e for e in events if _is_host(e)
                     and e.name != WINDOW_SPAN]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def intervals(self):
        """The union of the device ops' intervals, merged, in us."""
        out: list = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e6

    def kernel_s(self, match) -> tuple[float, int]:
        """(device seconds, launches) of the ops whose name `match`es."""
        hits = [e - s for name, s, e in self.device if match(name)]
        return sum(hits) / 1e6, len(hits)

    def device_ops(self, top: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.device:
            k = short_name(name)
            by[k] = by.get(k, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The window's idle device time by what the host was doing: each
        gap between busy intervals (and at the window's ends) named by the
        innermost host op spanning its middle, summed by name."""
        bounds = [[self.t0, self.t0]] + self.intervals() + [[self.t1,
                                                             self.t1]]
        by: dict = {}
        host = sorted(((e.time_range.start, e.time_range.end, e.name)
                       for e in self.host), key=lambda h: h[0])
        active: list = []           # (duration, end, name), shortest first
        nxt = 0
        for (_, a), (b, _) in zip(bounds, bounds[1:]):
            if b <= a:
                continue
            mid = (a + b) / 2       # the gaps' middles rise, so an op that
            while nxt < len(host) and host[nxt][0] <= mid:   # ended stays out
                s, e, name = host[nxt]
                heapq.heappush(active, (e - s, e, name))
                nxt += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            name = active[0][2] if active else "host: no profiled op"
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]
