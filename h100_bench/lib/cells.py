"""Everything a cell needs, found by the names in BENCHMARK.json:

  configuration  BENCHMARK.json's "file" for the cell's "config" (a JSON
                 file under configs/), whose "system" names
                 systems/<system>.py (how the program is built) and whose
                 "reference" names reference/<reference>.py
  traffic        workloads/<traffic>.json, whose "entry" names
                 entries/<entry>.py (the calls the window makes)
  limits         limits/<cell name>.json: each compared number's limit
  metrics        metrics/<metric name>.py, one reader each, for every
                 metric of BENCHMARK.json that the cell reports

A later cell, configuration, traffic mix or metric is new files and new
entries in BENCHMARK.json; no file here changes."""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
PACKAGE = BENCH_DIR.name


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def system(self):
        return _module("systems", self.config["system"])

    @property
    def entry(self):
        return _module("entries", self.mix["entry"])

    @property
    def reference(self):
        return _module("reference", self.config["reference"])


def _module(kind: str, name: str):
    return importlib.import_module(f"{PACKAGE}.{kind}.{name}")


def reader(metric: str):
    """The reader of a metric: metrics/<name>.py's `read(run)`."""
    return importlib.import_module(f"{PACKAGE}.metrics.{metric}").read


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell_name: str, root: Path = ROOT) -> Cell:
    """The cell of BENCHMARK.json named `cell_name`; KeyError if none."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload named {cell_name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    from . import traffic

    mix = traffic.load(root / PACKAGE / "workloads" / f"{w['traffic']}.json")
    limits = _json(root / PACKAGE / "limits" / f"{cell_name}.json")
    return Cell(name=cell_name, chips=w["chips"], config=config, mix=mix,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, cell_name)],
                per_layer=[m for m in bench["per_layer"]
                           if reports(m, cell_name)])
