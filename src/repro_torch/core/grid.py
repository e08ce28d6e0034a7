"""Hierarchical grid over the spatio-temporal metadata space (paper §4.1).

Layer ``l`` (0-based) partitions the global bounding box into ``(2**(l+1))**m``
uniform cubes of side ``w_l = |B| / 2**(l+1)`` per dimension (Alg. 1 line 3-4).

All planning math here is host-side numpy: cube identification and layer
selection are query *planning* (O(3^m) work), while the search itself runs
on the device in PyTorch (see ``core/search.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "GridSpec",
    "Layer",
]


@dataclasses.dataclass(frozen=True)
class Layer:
    """One grid layer: granularity ``g`` cubes per dimension."""

    level: int
    g: int                      # cubes per dimension
    lo: np.ndarray              # [m] box lower corner
    width: np.ndarray           # [m] cube side length per dimension

    @property
    def n_cubes(self) -> int:
        return int(self.g ** len(self.lo))

    # -- cube id math ------------------------------------------------------
    def coords_of(self, s: np.ndarray) -> np.ndarray:
        """Metadata ``[n, m]`` -> integer grid coordinates ``[n, m]``."""
        c = np.floor((np.asarray(s) - self.lo) / self.width).astype(np.int64)
        return np.clip(c, 0, self.g - 1)

    def flat_of(self, coords: np.ndarray) -> np.ndarray:
        """Grid coordinates ``[n, m]`` -> flat cube ids ``[n]`` (row-major)."""
        m = coords.shape[-1]
        flat = np.zeros(coords.shape[:-1], dtype=np.int64)
        for d in range(m):
            flat = flat * self.g + coords[..., d]
        return flat

    def cube_of(self, s: np.ndarray) -> np.ndarray:
        return self.flat_of(self.coords_of(s))

    def unflatten(self, flat: np.ndarray) -> np.ndarray:
        m = len(self.lo)
        flat = np.asarray(flat)
        out = np.zeros(flat.shape + (m,), dtype=np.int64)
        for d in reversed(range(m)):
            out[..., d] = flat % self.g
            flat = flat // self.g
        return out

    def cube_bounds(self, flat: np.ndarray):
        """Flat ids -> (lo, hi) corner arrays ``[..., m]``."""
        coords = self.unflatten(flat)
        lo = self.lo + coords * self.width
        return lo, lo + self.width

    # -- adjacency ---------------------------------------------------------
    def face_neighbors(self, flat: int) -> np.ndarray:
        """Up to ``2m`` face-adjacent cube ids; -1 where out of bounds.

        Order: [dim0-, dim0+, dim1-, dim1+, ...] — fixed so cross-edge
        column blocks line up with directions (Fig. 3 layout).
        """
        m = len(self.lo)
        coords = self.unflatten(np.asarray([flat]))[0]
        out = np.full(2 * m, -1, dtype=np.int64)
        for d in range(m):
            for j, delta in enumerate((-1, +1)):
                c = coords.copy()
                c[d] += delta
                if 0 <= c[d] < self.g:
                    out[2 * d + j] = self.flat_of(c[None])[0]
        return out

    # -- filter planning ---------------------------------------------------
    def cubes_overlapping_box(self, blo: np.ndarray, bhi: np.ndarray) -> np.ndarray:
        """All flat cube ids whose cell intersects the closed box [blo, bhi]."""
        m = len(self.lo)
        lo_c = np.clip(np.floor((np.asarray(blo) - self.lo) / self.width).astype(np.int64), 0, self.g - 1)
        hi_c = np.clip(np.floor((np.asarray(bhi) - self.lo) / self.width - 1e-12).astype(np.int64), 0, self.g - 1)
        ranges = [np.arange(lo_c[d], hi_c[d] + 1) for d in range(m)]
        grids = np.meshgrid(*ranges, indexing="ij")
        coords = np.stack([g.reshape(-1) for g in grids], axis=-1)
        return self.flat_of(coords)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The full hierarchy: L layers over a global bounding box (Alg. 1)."""

    lo: np.ndarray              # [m]
    hi: np.ndarray              # [m]
    n_layers: int

    @staticmethod
    def fit(metadata: np.ndarray, n_layers: int = 4, pad: float = 1e-6) -> "GridSpec":
        """Compute the global bounding box B over the dataset (Alg. 1 line 1)."""
        s = np.asarray(metadata, dtype=np.float64)
        lo = s.min(axis=0) - pad
        hi = s.max(axis=0) + pad
        return GridSpec(lo=lo, hi=hi, n_layers=int(n_layers))

    @property
    def m(self) -> int:
        return int(len(self.lo))

    @property
    def extent(self) -> np.ndarray:
        return self.hi - self.lo

    def layer(self, level: int) -> Layer:
        g = 2 ** (level + 1)
        return Layer(level=level, g=g, lo=self.lo,
                     width=self.extent / g)

    def layers(self) -> Sequence[Layer]:
        return [self.layer(l) for l in range(self.n_layers)]

    # -- layer selection (paper §4.3 + Prop. 1) ----------------------------
    def select_layer(self, characteristic_length: float) -> int:
        """Largest-width layer with ``w <= r`` — i.e. ``r/2 < w_l* <= r`` when
        such a layer exists; clamps to [0, L-1] otherwise (filters smaller than
        the deepest cube width route to the bottom layer, §5.1)."""
        r = float(characteristic_length)
        # Use the max per-dimension width as "the" cube width (anisotropic
        # boxes: widths differ per dim; the bound argument applies per-dim).
        widths = [float(self.layer(l).width.max()) for l in range(self.n_layers)]
        for l in range(self.n_layers):          # widths decrease with l
            if widths[l] <= r:
                return l
        return self.n_layers - 1
