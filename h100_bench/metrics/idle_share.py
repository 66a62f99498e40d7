"""The share of the traced window in which no device op (kernel, memcpy,
memset) ran: 100 (1 - union of their intervals / window)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
