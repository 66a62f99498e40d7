"""A cell, a configuration, a traffic mix and a metric added as new files
(and new entries in BENCHMARK.json) are found by name, with no file of
the benchmark edited."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys

from h100_bench.tests.conftest import BENCH, REPO

PROBE = """
import json, sys
from h100_bench.lib import cells
cell = cells.load("new.cell")
print(json.dumps({"config": cell.config["name"], "mix": cell.mix["name"],
                  "entry": cell.entry.__name__,
                  "system": cell.system.__name__,
                  "metrics": [m["name"] for m in cell.per_layer],
                  "value": cells.reader("new_metric")(None)}))
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "h100_bench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    b = tmp_path / "h100_bench"
    cfg = json.loads((b / "configs" / "gestsync.json").read_text())
    cfg["name"] = "new-config"
    (b / "configs" / "new-config.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "workloads" / "avspeech_tower_b16.json")
                     .read_text())
    mix["name"] = "new_mix"
    mix["batch_size"] = 8
    (b / "workloads" / "new_mix.json").write_text(json.dumps(mix))
    (b / "limits" / "new.cell.json").write_text('{"features": 1e-3}')
    (b / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-config", "source": "x",
                             "file": "h100_bench/configs/new-config.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new.cell", "config": "new-config",
                               "traffic": "new_mix", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "frames_per_s",
                               "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(tmp_path),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"config": "new-config", "mix": "new_mix",
                   "entry": "h100_bench.entries.tower_many",
                   "system": "h100_bench.systems.gestsync",
                   "metrics": ["new_metric"], "value": 42.0}
