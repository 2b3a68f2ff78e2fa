"""What no process of a run may load: JAX and the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "incremental_multimodal_medical_learning_ii_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
