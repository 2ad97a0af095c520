"""The check that no JAX code runs: by whole top-level module names, so
the port (`automerge_tpu_torch`) passes and the JAX package
(`automerge_tpu`) does not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "automerge_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
