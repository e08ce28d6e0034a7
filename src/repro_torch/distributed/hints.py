"""Sharding-constraint hints — the part of ``repro.distributed.hints``
the training step uses.  The port runs on one card with no registered
mesh, where the reference's hints are no-ops: ``constrain`` returns its
argument and ``dp_axes`` has no data-parallel axis.  The mesh-backed
forms wait for the multi-card slice (ROADMAP Queue A item 13d)."""
from __future__ import annotations


def constrain(x, *spec):
    """``x`` unchanged: no mesh is registered on one card."""
    return x


def dp_axes():
    """The registered mesh's data-parallel axis name(s): None on one
    card."""
    return None
