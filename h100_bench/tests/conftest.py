"""Fixtures of the benchmark's CPU tests: a checkout in a temporary folder
whose BENCHMARK.json names tiny cells (XLM-R cut to one layer and a
1,000-row vocabulary, clips of 8-12 frames, calls of 4 clips at batch 2)
beside the repository's own data files, and the look for a card made in
a fixture, never at import."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "h100_bench"
TINY = {"jegal.vta.avspeech": "tiny.vta",
        "gestsync.tower.avspeech": "tiny.tower"}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def write_tiny(root: Path) -> Path:
    """A checkout at `root` with the tiny cells; -> root."""
    for sub in ("configs", "workloads", "limits", "metrics"):
        shutil.copytree(BENCH / sub, root / "h100_bench" / sub)
    bench = _json(REPO / "BENCHMARK.json")
    configs, cells = [], []
    for w in bench["workloads"]:
        name = TINY[w["name"]]
        cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
        cfg = _json(REPO / cfg_entry["file"])
        cfg["name"] = "tiny-" + cfg["name"]
        if "xlmr" in cfg:
            cfg["xlmr"].update(vocab_size=1000, num_layers=1)
        cfg_file = f"h100_bench/configs/{cfg['name']}.json"
        (root / cfg_file).write_text(json.dumps(cfg))
        configs.append(dict(cfg_entry, name=cfg["name"], file=cfg_file))
        mix = _json(BENCH / "workloads" / f"{w['traffic']}.json")
        mix.update(name="tiny_" + w["traffic"], batch_size=2,
                   clips_per_call=4)
        mix["pool"].update(clips=2, seconds=[0.32, 0.48])
        if mix["pool"].get("content", True):
            mix["pool"]["words_per_second"] = 10
        (root / "h100_bench" / "workloads" / f"{mix['name']}.json") \
            .write_text(json.dumps(mix))
        shutil.copy(BENCH / "limits" / f"{w['name']}.json",
                    root / "h100_bench" / "limits" / f"{name}.json")
        cells.append(dict(w, name=name, config=cfg["name"],
                          traffic=mix["name"]))
    bench["configs"], bench["workloads"] = configs, cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY[n] for n in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return write_tiny(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    """The first CUDA card; the test skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda", 0)
