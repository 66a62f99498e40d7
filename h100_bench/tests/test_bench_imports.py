"""The check that no module of JAX or the JAX package is loaded, by whole
top-level names."""

from __future__ import annotations

import subprocess
import sys

from h100_bench.lib.imports import forbidden_modules
from h100_bench.tests.conftest import REPO


def test_whole_top_level_names():
    assert forbidden_modules({"jegal_torch": 0, "jegal_torch.api": 0,
                              "jaxtyping": 0, "numpy": 0}) == []
    assert forbidden_modules({"jax": 0, "jax.numpy": 0}) == ["jax"]
    assert forbidden_modules({"jegal_tpu.api": 0, "flax.linen": 0,
                              "jaxlib": 0}) == ["flax", "jaxlib",
                                                "jegal_tpu"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import h100_bench.run, h100_bench.control\n"
            "from h100_bench.lib import cells\n"
            "for c in ('jegal.vta.avspeech', 'gestsync.tower.avspeech'):\n"
            "    cell = cells.load(c)\n"
            "    cell.system, cell.entry, cell.reference\n"
            "import jegal_torch.api\n"
            "from h100_bench.lib.imports import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
