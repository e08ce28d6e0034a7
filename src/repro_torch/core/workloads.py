"""Synthetic datasets + query workloads mirroring the paper's Exp setup (§6.1).

Metadata distributions (Exp-8): uniform, normal, clustered, skewed, hollow.
Filter workloads: axis-aligned boxes (with ~20% edge-length fluctuation),
circles, random 3-5 vertex polygons, and composed filters ("inside box but
outside circle"), each targeting a requested filter ratio (fraction of the
metadata-space volume, §6.1 Filter Ratios).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .filters import BallFilter, BoxFilter, ComposeFilter, Filter, PolygonFilter

__all__ = [
    "make_dataset", "make_dataset_device", "make_box_filter", "make_ball_filter",
    "make_polygon_filter", "make_compose_filter", "ground_truth", "recall",
]


def make_dataset(n: int, d: int, m: int, distribution: str = "uniform",
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Vectors ~ unit-normalized gaussian mixture (SIFT-like clusterable
    embeddings); metadata in [0, 1]^m under the requested distribution."""
    rng = np.random.default_rng(seed)
    # Vectors: mixture of 32 gaussian clusters (graph-friendly structure).
    n_clusters = min(32, max(2, n // 64))
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)

    if distribution == "uniform":
        s = rng.uniform(0, 1, size=(n, m))
    elif distribution == "normal":
        s = np.clip(rng.normal(0.5, 0.15, size=(n, m)), 0, 1)
    elif distribution == "clustered":
        n_sc = 8
        sc = rng.uniform(0.1, 0.9, size=(n_sc, m))
        sa = rng.integers(0, n_sc, size=n)
        s = np.clip(sc[sa] + rng.normal(0, 0.03, size=(n, m)), 0, 1)
    elif distribution == "skewed":
        s = rng.beta(0.5, 2.0, size=(n, m))
    elif distribution == "hollow":
        # points pushed away from the center (annulus-like in every dim pair)
        s = rng.uniform(0, 1, size=(n, m))
        ctr = s - 0.5
        r = np.linalg.norm(ctr, axis=1, keepdims=True) + 1e-9
        s = 0.5 + ctr / r * np.maximum(r, 0.25 + 0.25 * rng.uniform(size=(n, 1)))
        s = np.clip(s, 0, 1)
    else:
        raise ValueError(distribution)
    return x.astype(np.float32), s.astype(np.float64)


def make_dataset_device(n: int, d: int, m: int, seed: int = 0,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`make_dataset`'s recipe (``uniform`` metadata) drawn on the
    device from a seeded ``torch.Generator`` — for sizes where a host copy
    would dominate set-up.  Returns ``(x [n, d] fp32, s [n, m] fp32)`` on
    ``device``; the numbers differ from :func:`make_dataset`'s (another
    generator), the distribution does not."""
    from ..device import resolve_device
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_clusters = min(32, max(2, n // 64))
    centers = torch.randn((n_clusters, d), generator=gen, device=dev)
    assign = torch.randint(0, n_clusters, (n,), generator=gen, device=dev)
    x = torch.empty((n, d), device=dev)
    step = 1 << 16                 # bounds the noise temporary
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        x[lo:hi] = centers[assign[lo:hi]] + 0.3 * torch.randn(
            (hi - lo, d), generator=gen, device=dev)
    s = torch.rand((n, m), generator=gen, device=dev)
    return x, s


def _box_from_ratio(rng, m, ratio, aspect: float = 1.0):
    """Box with volume ~= ratio of [0,1]^m; aspect = r_max/r_min (2D dims 0,1)."""
    side = ratio ** (1.0 / m)
    sides = np.full(m, side)
    if aspect > 1.0 and m >= 2:
        f = aspect ** 0.5
        sides[0] = min(side * f, 0.999)
        sides[1] = ratio / np.prod(np.delete(sides, 1)[:m - 1]) if m > 1 else side
        sides[1] = min(max(sides[1], 1e-4), 0.999)
    sides = sides * rng.uniform(0.9, 1.1, size=m)          # ~20% fluctuation
    sides = np.clip(sides, 1e-4, 0.999)
    lo = rng.uniform(0, 1 - sides)
    return lo, lo + sides


def make_box_filter(m: int, ratio: float, seed: int = 0,
                    aspect: float = 1.0) -> BoxFilter:
    rng = np.random.default_rng(seed)
    lo, hi = _box_from_ratio(rng, m, ratio, aspect)
    return BoxFilter(lo=lo.astype(np.float32), hi=hi.astype(np.float32))


def make_ball_filter(m: int, ratio: float, seed: int = 0) -> Filter:
    """Ball over the first two dims (geo circle), box over the rest."""
    rng = np.random.default_rng(seed)
    mc = min(m, 2)
    # volume of 2D disc = pi r^2; choose rest-dims box side so total ~= ratio
    if m > mc:
        rest_side = (ratio ** (1.0 / m))
        area2d = ratio / (rest_side ** (m - mc))
    else:
        area2d = ratio
    r = float(np.sqrt(area2d / np.pi))
    r = min(r, 0.49)
    center = rng.uniform(r, 1 - r, size=mc)
    ball = BallFilter(center=center.astype(np.float32), radius=np.float32(r))
    if m == mc:
        return ball
    lo = rng.uniform(0, 1 - rest_side, size=m - mc)
    box_lo = np.concatenate([np.zeros(mc), lo])
    box_hi = np.concatenate([np.ones(mc), lo + rest_side])
    return ComposeFilter(ball, BoxFilter(lo=box_lo.astype(np.float32),
                                         hi=box_hi.astype(np.float32)), "and")


def make_polygon_filter(m: int, ratio: float, n_vertices: int = 5,
                        seed: int = 0) -> PolygonFilter:
    """Random star-convex polygon over dims (0,1), box over the rest."""
    rng = np.random.default_rng(seed)
    if m > 2:
        rest_side = ratio ** (1.0 / m)
        area2d = ratio / (rest_side ** (m - 2))
    else:
        rest_side = None
        area2d = ratio
    # polygon ~ regular n-gon area = 1/2 n R^2 sin(2pi/n); randomize radii
    base_r = np.sqrt(2 * area2d / (n_vertices * np.sin(2 * np.pi / n_vertices)))
    base_r = min(base_r, 0.45)
    ctr = rng.uniform(base_r, 1 - base_r, size=2)
    angles = np.sort(rng.uniform(0, 2 * np.pi, size=n_vertices))
    radii = base_r * rng.uniform(0.7, 1.3, size=n_vertices)
    verts = ctr + np.stack([radii * np.cos(angles), radii * np.sin(angles)], -1)
    verts = np.clip(verts, 0, 1)
    if m == 2:
        rest_lo = np.zeros(0)
        rest_hi = np.zeros(0)
    else:
        lo = rng.uniform(0, 1 - rest_side, size=m - 2)
        rest_lo, rest_hi = lo, lo + rest_side
    return PolygonFilter(vertices=verts.astype(np.float32),
                         rest_lo=rest_lo.astype(np.float32),
                         rest_hi=rest_hi.astype(np.float32))


def make_compose_filter(m: int, ratio: float, seed: int = 0) -> ComposeFilter:
    """Paper Exp-3 'Compose': inside a box but outside a circle."""
    rng = np.random.default_rng(seed)
    lo, hi = _box_from_ratio(rng, m, min(ratio * 1.5, 0.6))
    box = BoxFilter(lo=lo.astype(np.float32), hi=hi.astype(np.float32))
    ctr2 = (lo[:2] + hi[:2]) / 2
    hole_r = 0.25 * float(np.min(hi[:2] - lo[:2]))
    hole = BallFilter(center=ctr2.astype(np.float32), radius=np.float32(hole_r))
    return ComposeFilter(box, hole, "andnot")


def ground_truth(x: np.ndarray, s: np.ndarray, queries: np.ndarray,
                 filt: Optional[Filter], k: int,
                 valid: Optional[np.ndarray] = None,
                 metric: str = "l2") -> Tuple[np.ndarray, np.ndarray]:
    """Exact filtered top-k by brute force (numpy oracle).  ``filt=None``
    means unfiltered."""
    if filt is None:
        mask = np.ones(len(s), bool)
    else:
        mask = filt.contains(torch.as_tensor(np.asarray(s))).numpy()
    if valid is not None:
        mask = mask & valid
    idx = np.nonzero(mask)[0]
    if len(idx) == 0:
        b = len(queries)
        return np.full((b, k), -1), np.full((b, k), np.inf)
    xv = x[idx]
    if metric == "l2":
        d = ((queries[:, None, :] - xv[None, :, :]) ** 2).sum(-1)
    else:
        d = -queries @ xv.T
    kk = min(k, len(idx))
    part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
    dd = np.take_along_axis(d, part, axis=1)
    order = np.argsort(dd, axis=1)
    ids = idx[np.take_along_axis(part, order, axis=1)]
    dd = np.take_along_axis(dd, order, axis=1)
    b = len(queries)
    out_i = np.full((b, k), -1)
    out_d = np.full((b, k), np.inf)
    out_i[:, :kk] = ids
    out_d[:, :kk] = dd
    return out_i, out_d


def recall(result_ids: np.ndarray, gt_ids: np.ndarray) -> float:
    """recall@k = |R ∩ A| / |R_valid| averaged over queries (paper §6.1)."""
    total, hit = 0, 0
    for r, g in zip(result_ids, gt_ids):
        gset = set(int(v) for v in g if v >= 0)
        if not gset:
            continue
        hit += len(gset & set(int(v) for v in r if v >= 0))
        total += len(gset)
    return hit / max(total, 1)
