"""A kernel family's share of its roofline over a traced window."""

from __future__ import annotations

from .peaks import bound_s


def share(run, family: str, match):
    """100 x the summed bound of the family's launches in the traced calls
    over the device seconds of the ops `match` selects; None without a
    trace, a launch or a device op of the family."""
    if run.trace is None:
        return None
    launches = run.traced_launches.get(family, [])
    seconds, n_ops = run.trace.kernel_s(match)
    if not launches or seconds <= 0 or n_ops == 0:
        return None
    return 100.0 * sum(bound_s(f, b) for f, b in launches) / seconds
