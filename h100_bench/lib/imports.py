"""The check that the port runs without JAX: no loaded module's top-level
name (the part before the first dot), compared whole, is one of the JAX
stack's or the JAX package's. `jegal_torch` begins with the JAX package's
name and passes."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "jegal_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
