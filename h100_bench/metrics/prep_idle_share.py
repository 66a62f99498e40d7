"""The share of the traced window in which the device was idle while the
calling thread was in `jt.prep`: the engine's per-sample host prep
(tokenizer, log-mel, pooling matrices), on its prep pool or inline
(lib/spans.py)."""

from h100_bench.lib import spans


def read(run):
    return spans.idle_share(run, ("jt.prep",))
