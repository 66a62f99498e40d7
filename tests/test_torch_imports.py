"""The port stands alone: jegal_torch and chip_smoke.py import neither JAX
nor anything of the JAX package, checked in the source and in a fresh
interpreter's sys.modules after importing every module of the port. Nor do
they import pandas, optax or orbax, which the card machine lacks (the JAX
package's training loop and checkpoints use them); safetensors and
matplotlib, which it may lack, only inside the functions that need
them."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "jegal_tpu", "pandas", "optax", "orbax")
# modules every walk of the package must reach (the training, planar, CLI
# and serving slices' too)
REQUIRED = ("jegal_torch.ops.kernels.flash_attention",
            "jegal_torch.ops.kernels.conv2", "jegal_torch.ops.video",
            "jegal_torch.training.trainer", "jegal_torch.training.data",
            "jegal_torch.training.loop", "jegal_torch.parallel.checkpoint",
            "jegal_torch.text.normalize", "jegal_torch.utils.logging",
            "jegal_torch.convert.torch_import",
            "jegal_torch.convert.checkpoints", "jegal_torch.eval.common",
            "jegal_torch.eval.retrieval", "jegal_torch.eval.spotting",
            "jegal_torch.eval.asd", "jegal_torch.eval.heatmap",
            "jegal_torch.host.media", "jegal_torch.host.masking",
            "jegal_torch.host.keypoints", "jegal_torch.host.transcribe",
            "jegal_torch.utils.profiling", "jegal_torch.data.datasets",
            "jegal_torch.verify", "jegal_torch.cli.main",
            "jegal_torch.serving", "jegal_torch.host.preprocess",
            "jegal_torch.data.download", "jegal_torch.parallel.mesh",
            "jegal_torch.parallel.collectives")
# optional packages: imported lazily, by the functions that need them
LAZY = ("pandas", "matplotlib", "safetensors")
SOURCES = sorted((ROOT / "jegal_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = sorted(n for n in _imported(path)
                 if n.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.name} imports {bad}"


def test_port_modules_leave_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import jegal_torch\n"
        "for m in pkgutil.walk_packages(jegal_torch.__path__, 'jegal_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {REQUIRED!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules if m.startswith('jegal_torch')]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 34   # every module of the port imported


def test_text_modules_import_without_tokenizers():
    """The tokenizer wrapper and the engine import with `tokenizers`
    unavailable (the card machine has no wheel); only
    WordTokenizer.from_file needs it."""
    code = (
        "import sys\n"
        "sys.modules['tokenizers'] = None\n"
        "import jegal_torch.text.tokenizer, jegal_torch.api\n"
        "try:\n"
        "    jegal_torch.text.tokenizer.WordTokenizer.from_file('x.json')\n"
        "except ImportError:\n"
        "    print('from_file needs tokenizers')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "from_file needs tokenizers"


def test_port_imports_with_optional_packages_blocked():
    """Every module of the port imports with pandas, matplotlib and
    safetensors unavailable; loading a .safetensors file then raises an
    error that names the package."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {LAZY!r}:\n"
        "    sys.modules[name] = None\n"
        "import jegal_torch\n"
        "for m in pkgutil.walk_packages(jegal_torch.__path__, 'jegal_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"missing = [m for m in {REQUIRED!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "from jegal_torch.convert.checkpoints import load_roberta\n"
        "try:\n"
        "    load_roberta('model.safetensors')\n"
        "except ImportError as e:\n"
        "    print(e)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ("loading model.safetensors needs the "
                                "safetensors package")


def test_serving_and_host_imports_build_nothing():
    """Importing the server, the preprocessing and the media bindings
    neither builds nor loads a native library (the repack is built when a
    server is created, the decoder at first decode), and pulls in no JAX,
    JAX-package or pandas module."""
    code = (
        "import sys\n"
        "import jegal_torch.serving, jegal_torch.host.preprocess\n"
        "import jegal_torch.data.download, jegal_torch.host.transcribe\n"
        "from jegal_torch.host import media\n"
        "assert media._lib is None and media._repack_lib is None\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
