"""What the process that prints a result may not hold.

A module counts by its top-level name, the part before the first dot,
compared whole: ``repro_torch`` (the port) is allowed, ``repro`` (the JAX
package) is not.
"""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: every
    module the process has loaded)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
