"""Card tests of the benchmark (marked `cuda`; each skips in its fixture
without a card): the control at a small size, and a traced run of each
tiny cell.

    python3 -m pytest -p no:cacheprovider -q h100_bench/tests -m cuda
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from h100_bench import control
from h100_bench import run as R
from h100_bench.lib import cells

SEEDS = (2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.vta", "tiny.tower"])
def test_the_control_is_not_correct(card, tiny_root, cell):
    """The reference one precision step down (TF32) in the program's
    place fails a limit; the program passes them all, on three seeds."""
    c = cells.load(cell, tiny_root)
    for seed in SEEDS:
        row = control.read_seed(c, seed, 1, card)
        assert all(row["program"][k] <= lim for k, lim in c.limits.items())
        assert any(row["control"][k] > lim for k, lim in c.limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.vta", "tiny.tower"])
def test_a_traced_run_reads_every_metric(card, tiny_root, cell):
    args = SimpleNamespace(workload=cell, seed=SEEDS[0], seconds=0.5,
                           trace=1)
    out = R.execute(args, root=tiny_root)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    m = out["metrics"]
    assert {"idle_share", "mfu", "stem_roofline", "encoders_roofline",
            "graph_captures", "host_cpu_ms_per_frame"} <= set(m)
    for name in ("mfu", "stem_roofline", "encoders_roofline"):
        assert 0 < m[name]["value"] <= 100
    assert m["graph_captures"]["value"] == 0
    assert len(out["breakdown"]["device_ops"]) <= 10
