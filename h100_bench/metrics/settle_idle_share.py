"""The share of the traced window in which the device was idle while the
calling thread was in `jt.settle`: the pipeline's wait for one chunk's
result and its post-processing (unpacking, L2 norms, row slicing)
(lib/spans.py)."""

from h100_bench.lib import spans


def read(run):
    return spans.idle_share(run, ("jt.settle",))
