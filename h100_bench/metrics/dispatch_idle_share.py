"""The share of the traced window in which the device was idle while the
calling thread was in `jt.stage` or `jt.launch`: a chunk's inputs made
ready on the host (stacking, graph staging buffers, frame copies into
pinned memory), then its upload, graph replay or eager tower and the
queued fetch (lib/spans.py)."""

from h100_bench.lib import spans


def read(run):
    return spans.idle_share(run, ("jt.stage", "jt.launch"))
