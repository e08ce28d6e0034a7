"""Sharding-constraint hints usable from model code without threading a
mesh through every call — the counterpart of ``repro.distributed.hints``.

A launcher (the dry run, a DTensor training run) registers the active
``DeviceMesh`` with ``use_mesh_hints(mesh)``; model code calls
``constrain(x, *spec)``, which keeps only the axes that exist on the
registered mesh *and* divide the corresponding dimension, as the
reference does.  A spec entry is a mesh-dimension name, a tuple of names
(one ``Shard`` on each) or None.  Where the reference hands the cleaned
spec to ``with_sharding_constraint``, the port redistributes a
``DTensor`` to those placements; a plain tensor is left as it is, and
with no registered mesh (unit tests, one card) every hint is a no-op.
"""
from __future__ import annotations

import contextlib
from typing import Optional

_CURRENT = None          # the registered torch DeviceMesh, or None


@contextlib.contextmanager
def use_mesh_hints(mesh):
    """Register ``mesh`` (a ``DeviceMesh`` with dimension names) as the
    active mesh for ``constrain`` hints for the duration of the
    with-block."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = mesh
    try:
        yield
    finally:
        _CURRENT = prev


def mesh_axis_size(axis) -> int:
    """Product of the registered mesh's sizes for ``axis`` (a name or
    tuple of names); 1 when no mesh is registered."""
    if _CURRENT is None:
        return 1
    from .sharding import axis_sizes
    shape = axis_sizes(_CURRENT)
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= shape.get(a, 1)
        return out
    return shape.get(axis, 1)


def has_axis(axis) -> bool:
    """Whether every name in ``axis`` exists on the registered mesh."""
    if _CURRENT is None:
        return False
    names = set(_CURRENT.mesh_dim_names)
    if isinstance(axis, tuple):
        return all(a in names for a in axis)
    return axis in names


def clean_spec(shape, spec) -> tuple:
    """The reference's rule: an entry survives when its axes exist on the
    registered mesh, their size divides the dimension and the dimension
    is at least that size; the rest become None, padded to ``len(shape)``."""
    clean = []
    for dim, s in zip(shape, spec):
        if s is None or not has_axis(s):
            clean.append(None)
        elif dim % mesh_axis_size(s) == 0 and dim >= mesh_axis_size(s):
            clean.append(s)
        else:
            clean.append(None)
    return tuple(clean) + (None,) * (len(shape) - len(clean))


def constrain(x, *spec):
    """Best-effort sharding constraint; silently drops invalid axes.  A
    ``DTensor`` is redistributed to the cleaned spec's placements; a
    plain tensor, or any tensor with no registered mesh, is returned
    unchanged."""
    if _CURRENT is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    clean = clean_spec(x.shape, spec)
    if all(c is None for c in clean):
        return x
    from .sharding import to_placements
    placements = to_placements(clean, _CURRENT)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(_CURRENT, placements)


def dp_axes() -> Optional[object]:
    """The registered mesh's data-parallel axis name(s), or None."""
    if _CURRENT is None:
        return None
    return ("pod", "data") if "pod" in _CURRENT.mesh_dim_names else "data"
