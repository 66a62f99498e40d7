"""Whole runs of the tiny cells on the CPU (the look for a card skipped):
the plain reference agrees with jegal_torch's CPU path, and a run whose
timed path is broken underneath comes out not correct."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from h100_bench import run as R

CPU = torch.device("cpu")


def execute(root, cell, on_call=None):
    args = SimpleNamespace(workload=cell, seed=2 ** 33 + 5, seconds=0.01,
                           trace=0)
    return R.execute(args, device=CPU, on_call=on_call, root=root)


@pytest.mark.parametrize("cell", ["tiny.vta", "tiny.tower"])
def test_reference_agrees_with_the_port_on_the_cpu(tiny_root, cell):
    out = execute(tiny_root, cell)
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(out)[-1] == "compared"
    compared = dict(out["compared"])
    assert compared.pop("failed_clips") == {"value": 0, "limit": 0}
    for c in compared.values():
        # float32 on both sides, summed in other orders: ~1e-6 of the RMS
        assert c["value"] <= 1e-4


def _broken(kind):
    def call(engine, mix, clips):
        out = _entry(mix).call(engine, mix, clips)
        if kind == "altered":
            first = out[0]
            name = next(iter(first))
            first[name] = np.array(first[name], copy=True)
            first[name][0, 0] += 5.0 * float(np.sqrt(np.mean(
                first[name] ** 2)))
        elif kind == "dropped":
            out[len(out) // 2] = None
        return out
    return call


def _entry(mix):
    from h100_bench.entries import extract_many, tower_many

    return extract_many if mix["entry"] == "extract_many" else tower_many


@pytest.mark.parametrize("cell", ["tiny.vta", "tiny.tower"])
@pytest.mark.parametrize("fault", ["altered", "dropped"])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    """An answer altered where it is produced, or a clip left out of a
    call's answers: `correct` comes out false."""
    out = execute(tiny_root, cell, on_call=_broken(fault))
    assert out["correct"] is False
    if fault == "dropped":
        assert out["failed"] > 0
