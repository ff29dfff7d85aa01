"""The import guard: the benchmark measures the PyTorch port and nothing
of the JAX package beside it. A module counts by its top-level name, the
part before the first dot, compared whole: `edge_enhancement_tpu_torch`
begins with `edge_enhancement_tpu` and is not it."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "edge_enhancement_tpu"})


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check(where: str) -> None:
    """Exit with code 3, naming what was found on standard error, if a
    forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        print(f"benchmark: {where}: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
