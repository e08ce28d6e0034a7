"""Spatio-temporal filter predicates φ : R^m -> {0,1} (paper §2.1).

Parameters are host values (numpy arrays / floats); ``contains`` evaluates
the predicate on a torch tensor of metadata on whatever device it lives,
always in fp32 (the precision the search loop and the kernels see).

Supported shapes (paper §6.1 query workloads): axis-aligned boxes, one-dim
intervals, circles / balls, simple polygons (2D, over metadata dims 0-1,
with optional box bounds on the remaining dims), and boolean compositions
(e.g. "inside box but outside circle").
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["BoxFilter", "BallFilter", "IntervalFilter", "PolygonFilter",
           "ComposeFilter", "Filter"]

# Sentinel for "unconstrained" bounding-box edges (planning only: the grid
# clips boxes to the dataset bounds, so any value >> data range works).
UNBOUNDED = 1e18


def _meta(s) -> torch.Tensor:
    return torch.as_tensor(s).to(torch.float32)


def _param(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=like.device)


class Filter:
    """Base class (interface only)."""

    def contains(self, s) -> torch.Tensor:      # [..., m] -> bool [...]
        raise NotImplementedError

    def bounding_box(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def characteristic_length(self) -> float:
        """Paper §5.1: max side length for boxes/hulls, diameter for balls."""
        lo, hi = self.bounding_box()
        return float(np.max(np.asarray(hi) - np.asarray(lo)))


@dataclasses.dataclass(frozen=True)
class BoxFilter(Filter):
    """Axis-aligned box [lo, hi] over all m metadata dims."""

    lo: np.ndarray   # [m]
    hi: np.ndarray   # [m]

    def contains(self, s):
        s = _meta(s)
        return torch.all((s >= _param(self.lo, s)) & (s <= _param(self.hi, s)),
                         dim=-1)

    def bounding_box(self):
        return np.asarray(self.lo), np.asarray(self.hi)


@dataclasses.dataclass(frozen=True)
class IntervalFilter(Filter):
    """Interval on a single metadata dim (typically time), either end open.

    A temporal half-open window ``[t0, ∞)`` is expressed directly as
    ``IntervalFilter(dim=time_dim, lo=t0)``.
    """

    dim: int
    lo: Optional[float] = None    # None = unbounded below
    hi: Optional[float] = None    # None = unbounded above

    def contains(self, s):
        s = _meta(s)
        v = s[..., self.dim]
        ok = torch.ones(v.shape, dtype=torch.bool, device=s.device)
        if self.lo is not None:
            ok = ok & (v >= _param(self.lo, s))
        if self.hi is not None:
            ok = ok & (v <= _param(self.hi, s))
        return ok

    def bounding_box(self):
        lo = np.full(self.dim + 1, -UNBOUNDED)
        hi = np.full(self.dim + 1, UNBOUNDED)
        if self.lo is not None:
            lo[self.dim] = float(np.asarray(self.lo))
        if self.hi is not None:
            hi[self.dim] = float(np.asarray(self.hi))
        return lo, hi


@dataclasses.dataclass(frozen=True)
class BallFilter(Filter):
    """Euclidean ball over the first ``len(center)`` metadata dims."""

    center: np.ndarray   # [mc] — ball applies to dims [0, mc)
    radius: float

    def contains(self, s):
        s = _meta(s)
        c = _param(self.center, s)
        mc = c.shape[-1]
        d2 = torch.sum((s[..., :mc] - c) ** 2, dim=-1)
        return d2 <= _param(self.radius, s) ** 2

    def bounding_box(self):
        c = np.asarray(self.center)
        r = float(np.asarray(self.radius))
        return c - r, c + r

    def characteristic_length(self):
        return 2.0 * float(np.asarray(self.radius))


@dataclasses.dataclass(frozen=True)
class PolygonFilter(Filter):
    """Simple polygon over metadata dims (0, 1); optional box on higher dims.

    Point-in-polygon by the crossing-number (ray casting) rule, vectorized
    over both points and edges.
    """

    vertices: np.ndarray     # [k, 2] polygon vertices in order
    rest_lo: np.ndarray      # [m-2] box bounds on remaining dims (may be empty)
    rest_hi: np.ndarray      # [m-2]

    def contains(self, s):
        s = _meta(s)
        v = _param(self.vertices, s)
        x, y = s[..., 0], s[..., 1]
        vx, vy = v[:, 0], v[:, 1]
        wx, wy = torch.roll(vx, -1), torch.roll(vy, -1)
        # Edge (v -> w) crosses the horizontal ray from (x, y) going +x?
        x_, y_ = x[..., None], y[..., None]
        cond = (vy > y_) != (wy > y_)
        # x coordinate of the edge at height y
        t = (y_ - vy) / torch.where(wy == vy, torch.ones_like(vy), wy - vy)
        xint = vx + t * (wx - vx)
        crossings = torch.sum(cond & (x_ < xint), dim=-1)
        inside = (crossings % 2) == 1
        if np.asarray(self.rest_lo).shape[-1] > 0:
            rest = s[..., 2:]
            inside = inside & torch.all((rest >= _param(self.rest_lo, s))
                                        & (rest <= _param(self.rest_hi, s)),
                                        dim=-1)
        return inside

    def bounding_box(self):
        v = np.asarray(self.vertices)
        lo2, hi2 = v.min(axis=0), v.max(axis=0)
        lo = np.concatenate([lo2, np.asarray(self.rest_lo)])
        hi = np.concatenate([hi2, np.asarray(self.rest_hi)])
        return lo, hi


@dataclasses.dataclass(frozen=True)
class ComposeFilter(Filter):
    """Boolean composition of two filters. op is 'and' | 'or' | 'andnot'."""

    a: Filter
    b: Filter
    op: str = "and"

    def contains(self, s):
        ca, cb = self.a.contains(s), self.b.contains(s)
        if self.op == "and":
            return ca & cb
        if self.op == "or":
            return ca | cb
        if self.op == "andnot":
            return ca & ~cb
        raise ValueError(f"unknown op {self.op!r}")

    def bounding_box(self):
        alo, ahi = self.a.bounding_box()
        blo, bhi = self.b.bounding_box()
        # sub-filters may constrain different dimension prefixes (e.g. a 2D
        # geo ball AND a 3D box with a time window): pad the shorter bounds
        # to "unconstrained" before combining.
        m = max(len(alo), len(blo))

        def pad(lo, hi):
            k = m - len(lo)
            if k:
                lo = np.concatenate([lo, np.full(k, -1e18)])
                hi = np.concatenate([hi, np.full(k, 1e18)])
            return lo, hi

        alo, ahi = pad(np.asarray(alo), np.asarray(ahi))
        blo, bhi = pad(np.asarray(blo), np.asarray(bhi))
        if self.op == "or":
            return np.minimum(alo, blo), np.maximum(ahi, bhi)
        if self.op == "and":
            return np.maximum(alo, blo), np.minimum(ahi, bhi)
        return alo, ahi   # andnot: bounded by a
