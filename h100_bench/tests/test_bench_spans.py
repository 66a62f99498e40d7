"""The split of the traced window's idle time by the engine's spans
(lib/spans.py and the four `*_idle_share` readers) on a window of made-up
events: each share is the exact intersection of idle time with its spans,
clipped to the window, a child span adds nothing, the four add up to
`idle_share`, and a trace without a `jt.` span reads None."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from h100_bench.lib import cells, profiling
from h100_bench.tests.test_bench_profiling import CPU, ev, fake_prof

SPLIT = ("prep_idle_share", "dispatch_idle_share", "settle_idle_share",
         "unattributed_idle_share")


def spanned_prof():
    """A window [100, 1100] us, busy [150, 200], [520, 700] and [950,
    1100] (clipped; idle 620), and the engine's spans on the host."""
    events = [ev("spin_kernel", 0, 10), ev("spin_kernel", 10, 20),
              ev(profiling.WINDOW_SPAN, 100, 1100, CPU),
              ev("jt.stage", 90, 110, CPU),          # clipped: idle 10
              ev("bench.call", 110, 1090, CPU),
              ev("jt.extract_many", 115, 1080, CPU),
              ev("jt.prep", 120, 300, CPU),          # idle 180 - 50
              ev("jt.prep.text", 130, 290, CPU),     # a child: nothing
              ev("jt.stage", 300, 500, CPU),         # idle 200
              ev("jt.capture", 350, 400, CPU),       # a child: nothing
              ev("jt.launch", 500, 550, CPU),        # idle 50 - 30
              ev("cudaGraphLaunch", 505, 510, CPU),
              ev("jt.settle", 600, 900, CPU),        # idle 300 - 100
              ev("cudaEventSynchronize", 610, 700, CPU),
              ev("void stem_band_kernel<Src>(...)", 150, 200),
              ev("void gemm_tc_kernel<128, 64>(...)", 520, 640),
              ev("Memcpy DtoH (Device -> Pinned)", 630, 700),
              ev("void stem_band_kernel<Src>(...)", 950, 1200)]
    return SimpleNamespace(events=lambda: events, lead_in=2)


def _read(trace):
    run = SimpleNamespace(trace=trace)
    return {m: cells.reader(m)(run) for m in ("idle_share",) + SPLIT}


def test_split_adds_up_to_idle_share():
    got = _read(profiling.Trace(spanned_prof()))
    # unattributed: [110, 120] and [900, 950]
    assert got == {"idle_share": pytest.approx(62.0),
                   "prep_idle_share": pytest.approx(13.0),
                   "dispatch_idle_share": pytest.approx(23.0),
                   "settle_idle_share": pytest.approx(20.0),
                   "unattributed_idle_share": pytest.approx(6.0)}
    assert sum(got[m] for m in SPLIT) == pytest.approx(got["idle_share"])


def test_idle_gaps_name_the_spans():
    """The trace reduction's gap names need no change to show the spans:
    the innermost host op at a gap's middle is an engine span (a child
    where one is open), not bench.call."""
    gaps = dict(profiling.Trace(spanned_prof()).idle_gaps())
    assert gaps == {"jt.prep": pytest.approx(50e-6),
                    "jt.capture": pytest.approx(320e-6),
                    "jt.settle": pytest.approx(250e-6)}


def test_no_engine_span_reads_none():
    """The parent program's trace, with no `jt.` span, and no trace."""
    assert all(v is None for m, v in _read(profiling.Trace(fake_prof()))
               .items() if m in SPLIT)
    assert all(v is None for v in _read(None).values())
