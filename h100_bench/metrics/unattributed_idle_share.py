"""The share of the traced window in which the device was idle while the
calling thread was in none of the engine's leaf spans: the harness, the
engine's planning of a call, anything unspanned. With the three other
`*_idle_share` readers it adds up to `idle_share` (lib/spans.py)."""

from h100_bench.lib import spans


def read(run):
    return spans.idle_share(run, spans.LEAVES, outside=True)
