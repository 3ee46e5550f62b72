"""What the process that prints the result may not have loaded."""
from __future__ import annotations

import sys

#: top-level module names (the part before the first dot, compared
#: whole): JAX, its libraries, and the JAX package the port came from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    mods = sys.modules if modules is None else modules
    return sorted(name for name in mods
                  if name.split(".", 1)[0] in FORBIDDEN)
