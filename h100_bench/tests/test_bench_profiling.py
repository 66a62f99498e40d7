"""The trace reduction on a window of made-up events: busy time, idle
gaps named by the innermost host op, device ops by name, the lead-in
skipped, and a kernel family's roofline share."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from h100_bench.lib import profiling, roofline

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def ev(name, start, end, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=False,
                           time_range=SimpleNamespace(
                               start=start, end=end,
                               elapsed_us=lambda: end - start))


def fake_prof():
    events = [ev("spin_kernel", 0, 10), ev("spin_kernel", 10, 20),
              ev(profiling.WINDOW_SPAN, 100, 1100, CPU),
              ev("bench.call", 110, 1090, CPU),
              ev("cudaEventSynchronize", 500, 700, CPU),
              ev("void stem_band_kernel<Src>(...)", 150, 350),
              ev("void gemm_tc_kernel<128, 64>(...)", 300, 400),
              ev("Memcpy HtoD (Pinned -> Device)", 800, 900),
              ev("void stem_band_kernel<Src>(...)", 1050, 1200)]
    return SimpleNamespace(events=lambda: events, lead_in=3)


def test_reduction():
    t = profiling.Trace(fake_prof())
    assert t.lost == 1
    assert t.window_s == pytest.approx(1000e-6)
    # busy: [150, 400] + [800, 900] + [1050, 1100] (clipped)
    assert t.busy_s == pytest.approx(400e-6)
    assert t.kernel_s(lambda n: "stem_band" in n) == (pytest.approx(250e-6),
                                                      2)
    ops = dict(t.device_ops())
    assert ops["stem_band_kernel"] == pytest.approx(250e-6)
    assert ops["Memcpy HtoD"] == pytest.approx(100e-6)
    gaps = dict(t.idle_gaps())
    # [100, 150] and [1000, 1050]... by the innermost host op at each
    # gap's middle: 125 and 1075 in bench.call, 600 in the sync
    assert gaps["cudaEventSynchronize"] == pytest.approx(400e-6)
    assert gaps["bench.call"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_roofline_share():
    run = SimpleNamespace(trace=profiling.Trace(fake_prof()),
                          traced_launches={"stem": [(495e12 * 125e-6, 0.0)]})
    assert roofline.share(run, "stem", lambda n: "stem_band" in n) \
        == pytest.approx(50.0)
    assert roofline.share(run, "encoders", lambda n: "gemm" in n) is None
    run.trace = None
    assert roofline.share(run, "stem", lambda n: "stem_band" in n) is None
