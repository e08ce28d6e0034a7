"""Baselines the paper compares against (§6.1): PostFiltering, PreFiltering,
ACORN-γ, and Tree-Graph (KD-tree of per-leaf graph indices).

All baselines reuse the batched beam-search executor of CubeGraph
(`core/search.py`) with different graphs / routing modes, so efficiency
comparisons measure the *algorithmic* differences the paper studies, not
implementation differences.  Each index lives on ``device`` (default: the
card), like ``CubeGraphIndex.build``.

The monolithic graph's single cube holds every point, so its exact kNN
pool is scored by distance-matrix products (kernel B2,
``graph.topk_over_all``) rather than per-row gathers of all ``n``
candidates; the graph it keeps is the reference's up to fp32 ties.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .filters import Filter
from .graph import (LayerGraph, _cube_map, build_layer_graph,
                    occlusion_prune, squared_norms, topk_over_candidates)
from .grid import Layer
from .search import SearchParams, beam_search

__all__ = ["MonolithicGraphIndex", "PostFilteringIndex", "PreFilteringIndex",
           "AcornIndex", "TreeGraphIndex"]


def _monolithic_layer(lo: np.ndarray, hi: np.ndarray) -> Layer:
    """A single cube covering the whole metadata space (g = 1)."""
    return Layer(level=-1, g=1, lo=np.asarray(lo, np.float64),
                 width=np.asarray(hi, np.float64) - np.asarray(lo, np.float64))


def _points(x, s, device):
    """(device, x fp32 tensor, host fp64 metadata, device fp32 metadata)."""
    dev = resolve_device(device, x)
    xt = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
    s_np = np.asarray(s.cpu().numpy() if isinstance(s, torch.Tensor) else s,
                      np.float64)
    return dev, xt, s_np, torch.as_tensor(s_np, device=dev).float()


class MonolithicGraphIndex:
    """A single flat proximity graph over the full dataset (HNSW-equivalent
    base index for the PostFiltering / PreFiltering / ACORN baselines)."""

    def __init__(self, x, s, m_intra: int = 16, metric: str = "l2",
                 point_chunk: int = 2048, col_chunk: int = 2048,
                 device=None):
        t0 = time.perf_counter()
        dev, self.x, s_np, self.s = _points(x, s, device)
        self.norms = squared_norms(self.x)
        self.metric = metric
        self.valid = np.ones(self.x.shape[0], bool)
        layer = _monolithic_layer(s_np.min(0) - 1e-6, s_np.max(0) + 1e-6)
        self.graph: LayerGraph = build_layer_graph(
            self.x, s_np, self.norms, layer, m_intra=m_intra, m_cross=0,
            point_chunk=point_chunk, col_chunk=col_chunk, metric=metric,
            k_entry=16, dense_knn=True)
        self.build_seconds = time.perf_counter() - t0

    @property
    def device(self) -> torch.device:
        return self.x.device

    def index_bytes(self) -> int:
        return int(self.graph.nbrs.numel() * 4)

    def _search(self, queries, filt: Filter, params: SearchParams):
        seeds = np.asarray(self.graph.cubes.entry[0], np.int64)
        active = np.asarray([0], np.int64)   # the single cube is always active
        ids, dists, _ = beam_search(
            self.x, self.s, self.norms, self.valid, self.graph.cube_of_dev,
            self.graph.all_nbrs, queries, filt, active, seeds, params)
        return ids.cpu().numpy(), dists.cpu().numpy()


class PostFilteringIndex(MonolithicGraphIndex):
    """Traverse ignoring φ, apply φ post-hoc to the top-ef candidates
    (paper §2.2 — wastes distance computations; recall suffers when the
    filter is selective because the unfiltered top-ef may contain < k
    qualifying points)."""

    def query(self, queries, filt: Filter, k: int = 10, ef: int = 64,
              width: int = 4, max_iters: int = 512):
        params = SearchParams(k=ef, ef=ef, width=width, max_iters=max_iters,
                              metric=self.metric, route_mode="all",
                              collect_all=True)
        ids_np, d_np = self._search(queries, filt, params)
        safe = torch.as_tensor(np.maximum(ids_np, 0), device=self.device)
        ok = filt.contains(self.s[safe.long()]).cpu().numpy() & (ids_np >= 0)
        d_np = np.where(ok, d_np, np.inf)
        order = np.argsort(d_np, axis=1)[:, :k]
        out_i = np.take_along_axis(ids_np, order, axis=1)
        out_d = np.take_along_axis(d_np, order, axis=1)
        return np.where(np.isfinite(out_d), out_i, -1), out_d


class PreFilteringIndex(MonolithicGraphIndex):
    """Route only through φ-passing nodes (paper §2.2 — the effective
    subgraph fragments at low selectivity => catastrophic recall)."""

    def query(self, queries, filt: Filter, k: int = 10, ef: int = 64,
              width: int = 4, max_iters: int = 512):
        params = SearchParams(k=k, ef=ef, width=width, max_iters=max_iters,
                              metric=self.metric, route_mode="filter")
        return self._search(queries, filt, params)


class AcornIndex(PreFilteringIndex):
    """ACORN-γ-style baseline: a γ×-denser predicate-agnostic graph searched
    with predicate-gated traversal (Patel et al., 2024).  The emulation
    keeps the full γ·M degree at search time (ACORN-1 search over the
    ACORN-γ graph), which upper-bounds ACORN's recall."""

    def __init__(self, x, s, m_intra: int = 16, gamma: int = 4,
                 metric: str = "l2", **kw):
        super().__init__(x, s, m_intra=m_intra * gamma, metric=metric, **kw)
        self.gamma = gamma


# ---------------------------------------------------------------------------
# Tree-Graph: KD-tree over metadata with an isolated graph per leaf (§3).
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _KDNode:
    lo: np.ndarray
    hi: np.ndarray
    dim: int = -1
    split: float = 0.0
    left: Optional["_KDNode"] = None
    right: Optional["_KDNode"] = None
    leaf_id: int = -1


class TreeGraphIndex:
    """KD-tree of per-leaf graphs.  A query traverses the tree to find the
    leaves overlapping bbox(φ) and runs an *independent* graph search per
    leaf (the subquery explosion of Observation 2)."""

    def __init__(self, x, s, leaf_size: int = 512, m_intra: int = 16,
                 metric: str = "l2", point_chunk: int = 2048,
                 col_chunk: int = 2048, device=None):
        t0 = time.perf_counter()
        dev, self.x, s_np, self.s = _points(x, s, device)
        self.s_np = s_np
        self.norms = squared_norms(self.x)
        self.metric = metric
        n, m = s_np.shape
        self.valid = np.ones(n, bool)

        # ---- build KD tree (median splits, cycling dims) ------------------
        self.leaf_of = np.zeros(n, np.int64)
        self._leaves: List[_KDNode] = []

        def leaf(node: _KDNode, ids: np.ndarray) -> _KDNode:
            node.leaf_id = len(self._leaves)
            self.leaf_of[ids] = node.leaf_id
            self._leaves.append(node)
            return node

        def split(ids: np.ndarray, depth: int, lo, hi) -> _KDNode:
            node = _KDNode(lo=lo, hi=hi)
            if len(ids) <= leaf_size:
                return leaf(node, ids)
            dim = depth % m
            med = float(np.median(s_np[ids, dim]))
            node.dim, node.split = dim, med
            mask = s_np[ids, dim] <= med
            if mask.all() or (~mask).all():     # degenerate: force leaf
                node.dim = -1
                return leaf(node, ids)
            lhi, rlo = hi.copy(), lo.copy()
            lhi[dim] = med
            rlo[dim] = med
            node.left = split(ids[mask], depth + 1, lo, lhi)
            node.right = split(ids[~mask], depth + 1, rlo, hi)
            return node

        self.root = split(np.arange(n), 0,
                          s_np.min(0) - 1e-6, s_np.max(0) + 1e-6)
        self.n_leaves = len(self._leaves)

        # ---- per-leaf graphs: the layer builder's primitives, cube = leaf -
        self.cubes = _cube_map(self.leaf_of, self.x.cpu().numpy())
        members = torch.as_tensor(self.cubes.members, device=dev).long()
        nbrs = np.full((n, m_intra), -1, np.int32)
        rows = self.cubes.row_of(self.leaf_of)
        ids_all = np.arange(n, dtype=np.int64)
        k_cand = int(min(2 * m_intra, max(2, self.cubes.members.shape[1] - 1)))
        for lo_i in range(0, n, point_chunk):
            sel = torch.as_tensor(ids_all[lo_i:lo_i + point_chunk],
                                  device=dev)
            cand = members[torch.as_tensor(rows[lo_i:lo_i + point_chunk],
                                           device=dev)]
            knn_ids, knn_d = topk_over_candidates(
                self.x[sel], cand, self.x, self.norms, k_cand,
                exclude=sel, col_chunk=col_chunk, metric=metric)
            nbrs[lo_i:lo_i + point_chunk] = occlusion_prune(
                knn_ids, knn_d, self.x, m_intra).cpu().numpy()
        self.nbrs = torch.as_tensor(nbrs, device=dev)
        self.leaf_of_dev = torch.as_tensor(self.leaf_of.astype(np.int32),
                                           device=dev)
        self.build_seconds = time.perf_counter() - t0

    @property
    def device(self) -> torch.device:
        return self.x.device

    def index_bytes(self) -> int:
        return int(self.nbrs.numel() * 4 + self.cubes.members.size * 4)

    def _overlapping_leaves(self, blo, bhi) -> List[int]:
        out: List[int] = []

        def rec(node: Optional[_KDNode]):
            if node is None:
                return
            if np.any(node.hi < blo) or np.any(node.lo > bhi):
                return
            if node.leaf_id >= 0:
                out.append(node.leaf_id)
                return
            rec(node.left)
            rec(node.right)

        rec(self.root)
        return out

    def query(self, queries, filt: Filter, k: int = 10, ef: int = 32,
              width: int = 4, max_iters: int = 256,
              return_n_subqueries: bool = False):
        """One *independent* beam search per overlapping leaf, results merged
        post-hoc — the decoupled architecture of §3."""
        blo, bhi = filt.bounding_box()
        leaves = self._overlapping_leaves(np.asarray(blo), np.asarray(bhi))
        b = len(queries)
        all_ids = [np.full((b, k), -1)]
        all_d = [np.full((b, k), np.inf)]
        params = SearchParams(k=k, ef=ef, width=width, max_iters=max_iters,
                              metric=self.metric, route_mode="cube")
        for lf in leaves:
            row = self.cubes.row_of(np.asarray([lf]))[0]
            if row < 0:
                continue
            seeds = np.asarray(self.cubes.entry[row], np.int64)
            active = np.asarray([lf], np.int64)
            ids, dists, _ = beam_search(
                self.x, self.s, self.norms, self.valid, self.leaf_of_dev,
                self.nbrs, queries, filt, active, seeds, params)
            all_ids.append(ids.cpu().numpy())
            all_d.append(dists.cpu().numpy())
        ids = np.concatenate(all_ids, axis=1)
        d = np.concatenate(all_d, axis=1)
        order = np.argsort(d, axis=1)[:, :k]
        out = (np.take_along_axis(ids, order, axis=1),
               np.take_along_axis(d, order, axis=1))
        if return_n_subqueries:
            return out[0], out[1], len(leaves)
        return out
