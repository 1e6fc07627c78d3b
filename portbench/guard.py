"""The port is measured without JAX: no module of the JAX package, of
JAX or of Flax may be loaded in the process that reports. Names are
compared by their top-level part whole, since ``repro_torch`` begins with
``repro``."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among module names ``names``."""
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def loaded() -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    return forbidden(list(sys.modules))
