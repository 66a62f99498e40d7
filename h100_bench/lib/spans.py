"""The traced window's idle device time split by the engine's spans.

jegal_torch opens its spans on the calling thread (jegal_torch/api.py):
one a call (`jt.extract_many`, `jt.tower_many`) holding the leaves
`jt.prep`, `jt.stage`, `jt.launch` and `jt.settle`, which never overlap.
They are host events of the same trace as the device ops, on the same
clock. `idle_share(run, names)` intersects the window's idle time (the
window less the union of the device ops' intervals) exactly with the
union of the named spans, clipped to the window; child spans (a capture,
an upload wait, a sample's prep on a worker) count only through their
leaf. A trace that holds no `jt.` span, as a program without the spans
gives, reads None, never 0."""

from __future__ import annotations

PREFIX = "jt."
LEAVES = ("jt.prep", "jt.stage", "jt.launch", "jt.settle")


def _merged(intervals) -> list:
    """Intervals [start, end] -> their union, sorted and disjoint."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a: list, b: list) -> float:
    """The length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(run, names, outside: bool = False):
    """The share (%) of the traced window in which no device op ran and
    the host was inside a span named in `names` (with outside=True: inside
    none of them); None without a trace or a `jt.` span in it."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    if not any(e.name.startswith(PREFIX) for e in t.host):
        return None
    spans = _merged((max(e.time_range.start, t.t0), min(e.time_range.end,
                                                        t.t1))
                    for e in t.host if e.name in names)
    busy = t.intervals()
    window = t.t1 - t.t0
    idle_in = _length(spans) - _overlap(spans, busy)
    idle = window - _length(busy)
    return 100.0 * (idle - idle_in if outside else idle_in) / window
