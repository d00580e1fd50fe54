"""The check that a run never loaded JAX or the JAX package: module names
are compared whole, by the part before the first dot, so the port
(``spatialvla_tpu_torch``) is not taken for the JAX package
(``spatialvla_tpu``)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "spatialvla_tpu")


def loaded(modules=None) -> list:
    """The forbidden top-level packages among ``modules`` (default
    ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(t for t in FORBIDDEN if t in tops)
