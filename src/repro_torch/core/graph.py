"""Proximity-graph construction for CubeGraph (paper §4.2, Alg. 1 + Alg. 2).

Each cube's local graph is built from an *exact* kNN candidate set (batched
gathers and products on the device), then pruned with the occlusion
heuristic (MRNG / HNSW "select-neighbors-heuristic").  Cross-cube edges
(Alg. 2) are exact top-``M_cross`` neighbors in each face-adjacent cube.

All neighbor arrays are dense ``int32`` with ``-1`` padding and are indexed by
**original dataset ids**, so the vector / metadata / norm arrays are stored
once and shared by every layer (paper Fig. 3 memory layout).  Cube-id lookup
structures are *sparse* (sorted nonempty-cube table + searchsorted) so deep
layers in high metadata dimension (g^m cubes) never allocate O(g^m) arrays.

Top-k selections use a stable sort, so equal distances keep the lower
candidate position first — the tie order of the reference's ``top_k``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .grid import Layer

__all__ = [
    "CubeMap",
    "LayerGraph",
    "build_layer_graph",
    "topk_over_candidates",
    "topk_over_all",
    "occlusion_prune",
    "squared_norms",
]

INF = float("inf")
# Upper bound on one [rows, candidates, d] fp32 gather in
# topk_over_candidates.  Chunking the candidate axis does not change which
# neighbours are kept (the running top-k is ordered by (distance,
# position)), only the peak memory.
GATHER_BYTES = 2 << 30


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return torch.sum(x * x, dim=-1)


def _dots(xv: torch.Tensor, qv: torch.Tensor) -> torch.Tensor:
    """[b, c, d] x [b, d] -> [b, c] fp32 inner products."""
    return torch.bmm(xv, qv[:, :, None])[:, :, 0]


def _long(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                           else a, device=device).long()


# ---------------------------------------------------------------------------
# Generic primitive: running top-k over a padded candidate-id matrix.
# ---------------------------------------------------------------------------
def topk_over_candidates(
    query_vecs: torch.Tensor,       # [b, d]
    cand_ids,                       # [b, s] int, -1 padded
    x: torch.Tensor,                # [n, d] full vector store
    norms: torch.Tensor,            # [n]
    k: int,
    exclude=None,                   # [b] ids to mask (e.g. self)
    col_chunk: int = 1024,
    metric: str = "l2",
):
    """Exact top-k by (squared L2 | negated IP) among per-row candidate
    lists -> ``(ids [b, k] int32 with -1 misses, dists [b, k])``."""
    dev = x.device
    qv = query_vecs.to(dev).float()
    qn = squared_norms(qv)
    cand = _long(cand_ids, dev)
    b, width = cand.shape
    d = x.shape[1]
    exclude = (torch.full((b,), -1, dtype=torch.long, device=dev)
               if exclude is None else _long(exclude, dev))
    cc = int(min(col_chunk, max(8, width)))
    cc = max(1, min(cc, GATHER_BYTES // max(b * d * 4, 1)))
    run_ids = torch.full((b, k), -1, dtype=torch.long, device=dev)
    run_d = torch.full((b, k), INF, device=dev)
    for lo in range(0, width, cc):
        ids = cand[:, lo:lo + cc]
        safe = ids.clamp_min(0)
        ip = _dots(x[safe], qv)
        if metric == "l2":
            dd = norms[safe] - 2.0 * ip + qn[:, None]
        else:   # inner product (negated => smaller is better)
            dd = -ip
        bad = (ids < 0) | (ids == exclude[:, None])
        dd = dd.masked_fill(bad, INF)
        all_ids = torch.cat([run_ids, ids], dim=1)
        all_d = torch.cat([run_d, dd], dim=1)
        sd, order = torch.sort(all_d, dim=1, stable=True)
        run_d = sd[:, :k]
        run_ids = torch.gather(all_ids, 1, order[:, :k])
    ids = torch.where(run_d < INF, run_ids, torch.full_like(run_ids, -1))
    return ids.to(torch.int32), run_d


def topk_over_all(query_vecs: torch.Tensor, x: torch.Tensor, k: int,
                  exclude=None, col_chunk: int = 2048, metric: str = "l2"):
    """Exact top-k of each query over every row of ``x`` — the candidate
    list of a layer whose single cube holds all points.  The same running
    top-k as :func:`topk_over_candidates` (ties keep the lower row), with
    each column chunk scored by one distance matrix (kernel B2) instead of
    per-row gathers, so the cost is a product rather than ``rows * n``
    gathered vectors.  Returns ``(ids [b, k] int32, dists [b, k])``."""
    from ..kernels.ops import pairwise_dist
    dev = x.device
    qv = query_vecs.to(dev).float()
    b, n = qv.shape[0], x.shape[0]
    exclude = (torch.full((b,), -1, dtype=torch.long, device=dev)
               if exclude is None else _long(exclude, dev))
    run_ids = torch.full((b, k), -1, dtype=torch.long, device=dev)
    run_d = torch.full((b, k), INF, device=dev)
    for lo in range(0, n, max(int(col_chunk), 1)):
        hi = min(n, lo + max(int(col_chunk), 1))
        dd = pairwise_dist(qv, x[lo:hi], metric=metric)
        ids = torch.arange(lo, hi, device=dev)[None, :].expand(b, -1)
        dd = dd.masked_fill(ids == exclude[:, None], INF)
        all_ids = torch.cat([run_ids, ids], dim=1)
        all_d = torch.cat([run_d, dd], dim=1)
        sd, order = torch.sort(all_d, dim=1, stable=True)
        run_d = sd[:, :k]
        run_ids = torch.gather(all_ids, 1, order[:, :k])
    ids = torch.where(run_d < INF, run_ids, torch.full_like(run_ids, -1))
    return ids.to(torch.int32), run_d


# ---------------------------------------------------------------------------
# Occlusion pruning (HNSW select-neighbors-heuristic / MRNG rule).
# ---------------------------------------------------------------------------
def occlusion_prune(cand_ids, cand_dists, x: torch.Tensor, m_out: int,
                    backfill: bool = True) -> torch.Tensor:
    """Prune a sorted-by-distance candidate list [b, kc] to degree
    ``m_out`` (int32, -1 padded)."""
    dev = x.device
    cand = _long(cand_ids, dev)
    cand_d = torch.as_tensor(cand_dists, device=dev).float()
    b, kc = cand.shape
    cv = x[cand.clamp_min(0)]                                  # [b, kc, d]
    n2 = torch.sum(cv * cv, dim=-1)
    pd = n2[:, :, None] - 2.0 * torch.bmm(cv, cv.transpose(1, 2)) \
        + n2[:, None, :]
    valid = cand >= 0
    keep = torch.zeros((b, kc), dtype=torch.bool, device=dev)
    for j in range(kc):
        # candidate j survives if no already-kept neighbor is closer to it
        # than the query point is: keep_i and d(c_i, c_j) < d(p, c_j).
        occluded = torch.any(keep & (pd[:, :, j] < cand_d[:, j][:, None]),
                             dim=1)
        keep[:, j] = valid[:, j] & ~occluded
    # order: kept (by distance rank) first, then (optionally) pruned backfill.
    ar = torch.arange(kc, device=dev)[None, :]
    rank = ar + torch.where(keep, 0, kc if backfill else 10 * kc)
    rank = torch.where(valid, rank, torch.full_like(rank, 100 * kc))
    sel = torch.argsort(rank, dim=1, stable=True)[:, :m_out]
    out = torch.gather(cand, 1, sel)
    ok = torch.gather(rank, 1, sel) < (10 * kc if backfill else kc)
    out = torch.where(ok, out, torch.full_like(out, -1)).to(torch.int32)
    if out.shape[1] < m_out:            # fewer candidates than the degree
        out = torch.cat([out, out.new_full((b, m_out - out.shape[1]), -1)],
                        dim=1)
    return out


# ---------------------------------------------------------------------------
# Sparse cube bookkeeping (no O(g^m) allocations)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CubeMap:
    """Sorted table of nonempty flat cube ids with searchsorted row lookup."""

    uniq: np.ndarray               # [n_ne] sorted nonempty flat cube ids
    members: np.ndarray            # [n_ne, p_max] int32, -1 padded (orig ids)
    counts: np.ndarray             # [n_ne]
    entry: np.ndarray              # [n_ne, k_entry] entry points (-1 pad)

    def row_of(self, cubes: np.ndarray) -> np.ndarray:
        """Flat cube ids -> member rows; -1 for empty/unknown cubes."""
        cubes = np.asarray(cubes)
        pos = np.searchsorted(self.uniq, cubes)
        pos_c = np.clip(pos, 0, len(self.uniq) - 1)
        ok = (len(self.uniq) > 0) & (self.uniq[pos_c] == cubes) & (cubes >= 0)
        return np.where(ok, pos_c, -1)

    @property
    def n_nonempty(self) -> int:
        return len(self.uniq)


def _fps_entries(v: np.ndarray, ids: np.ndarray, k: int) -> np.ndarray:
    """Greedy farthest-point-sampled entry points, seeded at the medoid."""
    n = len(ids)
    k = min(k, n)
    c = v.mean(axis=0, keepdims=True)
    first = int(np.argmin(((v - c) ** 2).sum(axis=1)))
    chosen = [first]
    mind = ((v - v[first]) ** 2).sum(axis=1)
    for _ in range(k - 1):
        nxt = int(np.argmax(mind))
        chosen.append(nxt)
        mind = np.minimum(mind, ((v - v[nxt]) ** 2).sum(axis=1))
    out = np.full(k, -1, dtype=np.int64)
    out[: len(chosen)] = ids[chosen]
    return out


def _cube_map(cube_of: np.ndarray, x_np: np.ndarray, k_entry: int = 4) -> CubeMap:
    order = np.argsort(cube_of, kind="stable")
    sorted_cubes = cube_of[order]
    uniq, starts, counts = np.unique(sorted_cubes, return_index=True, return_counts=True)
    p_max = int(counts.max()) if len(counts) else 1
    members = np.full((max(len(uniq), 1), p_max), -1, dtype=np.int32)
    entry = np.full((max(len(uniq), 1), k_entry), -1, dtype=np.int64)
    for row, (st, ct) in enumerate(zip(starts, counts)):
        ids = order[st:st + ct]
        members[row, :ct] = ids
        e = _fps_entries(x_np[ids], ids, k_entry)
        entry[row, : len(e)] = e
    return CubeMap(uniq=uniq, members=members, counts=counts, entry=entry)


def _face_adjacent_flat(coords: np.ndarray, g: int) -> np.ndarray:
    """[n, m] integer coords -> [n, 2m] flat ids of face-adjacent cubes (-1 OOB).

    Direction order: [dim0-, dim0+, dim1-, dim1+, ...] (matches Fig. 3 blocks).
    """
    n, m = coords.shape
    out = np.full((n, 2 * m), -1, dtype=np.int64)
    weights = g ** np.arange(m - 1, -1, -1)
    base = coords @ weights
    for d in range(m):
        for j, delta in enumerate((-1, +1)):
            nd = coords[:, d] + delta
            ok = (nd >= 0) & (nd < g)
            out[:, 2 * d + j] = np.where(ok, base + delta * weights[d], -1)
    return out


# ---------------------------------------------------------------------------
# Layer graph container + construction
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LayerGraph:
    """One grid layer's stitched-graph data (all ids = original dataset ids)."""

    level: int
    layer: Layer
    cube_of: np.ndarray            # [n] flat cube id per point (host)
    cubes: CubeMap
    nbrs: torch.Tensor             # [n, m_intra] intra-cube edges (device)
    xnbrs: torch.Tensor            # [n, 2m * m_cross] cross-cube edges

    @functools.cached_property
    def all_nbrs(self) -> torch.Tensor:
        return torch.cat([self.nbrs, self.xnbrs], dim=1)

    @functools.cached_property
    def cube_of_dev(self) -> torch.Tensor:
        """``cube_of`` as an int32 tensor beside the edges."""
        return torch.as_tensor(self.cube_of.astype(np.int32),
                               device=self.nbrs.device)

    def entry_of_cubes(self, cube_ids: np.ndarray) -> np.ndarray:
        """[c] cube ids -> [c, k_entry] entry points (-1 for empty cubes)."""
        rows = self.cubes.row_of(cube_ids)
        e = self.cubes.entry[np.maximum(rows, 0)].copy()
        e[rows < 0] = -1
        return e


def build_layer_graph(
    x: torch.Tensor,               # [n, d] fp32 (device)
    s: np.ndarray,                 # [n, m] metadata (host)
    norms: torch.Tensor,           # [n]
    layer: Layer,
    m_intra: int = 16,
    m_cross: int = 4,
    point_chunk: int = 2048,
    col_chunk: int = 2048,
    metric: str = "l2",
    k_entry: int = 4,
    n_random: int = 8,
    seed: int = 0,
    dense_knn: bool = False,
) -> LayerGraph:
    """Alg. 1 (per-cube local graphs) + Alg. 2 (cross-cube edges) for one layer.

    ``n_random`` random same-cube candidates are appended to each point's
    exact-kNN pool before occlusion pruning; the surviving ones provide the
    long-range edges that incremental HNSW insertion produces implicitly.
    They are drawn with the same numpy generator calls as the reference
    package, so both draw the same candidates.

    ``dense_knn`` (a layer with one cube, as the baselines' monolithic
    graph) scores the exact kNN pool with :func:`topk_over_all`."""
    dev = x.device
    n = x.shape[0]
    m = s.shape[1]
    x_np = x.cpu().numpy()
    coords = layer.coords_of(s)
    cube_of = layer.flat_of(coords)
    cubes = _cube_map(cube_of, x_np, k_entry=k_entry)
    members = torch.as_tensor(cubes.members, device=dev).long()
    rng = np.random.default_rng(seed + 7919 * max(layer.level, 0))

    adj_flat = _face_adjacent_flat(coords, layer.g)         # [n, 2m]
    adj_rows = cubes.row_of(adj_flat)                        # [n, 2m] member rows
    own_rows = cubes.row_of(cube_of)                         # [n]

    ids_all = np.arange(n, dtype=np.int32)
    k_cand = int(min(2 * m_intra, max(2, cubes.members.shape[1] - 1)))
    nbrs_out = np.full((n, m_intra), -1, dtype=np.int32)
    xnbrs_out = np.full((n, 2 * m, m_cross), -1, dtype=np.int32)

    counts_of_row = cubes.counts
    if dense_knn and cubes.n_nonempty != 1:
        raise ValueError("dense_knn needs a layer whose points share one "
                         f"cube, not {cubes.n_nonempty}")

    for lo in range(0, n, point_chunk):
        sel = ids_all[lo:lo + point_chunk]
        sel_t = torch.as_tensor(sel, device=dev).long()
        qv = x[sel_t]
        rows_sel = own_rows[sel]
        if dense_knn:
            knn_ids, knn_d = topk_over_all(qv, x, k_cand, exclude=sel_t,
                                           col_chunk=col_chunk,
                                           metric=metric)
        else:
            cand = members[torch.as_tensor(rows_sel, device=dev)]
            knn_ids, knn_d = topk_over_candidates(
                qv, cand, x, norms, k_cand, exclude=sel_t,
                col_chunk=col_chunk, metric=metric)
        if n_random > 0:
            # random same-cube candidates -> long-range edge pool
            cnt = counts_of_row[rows_sel][:, None]           # [c, 1]
            pos = rng.integers(0, np.maximum(cnt, 1), size=(len(sel), n_random))
            rand_ids = cubes.members[rows_sel[:, None], pos].astype(np.int32)
            rand_ids = np.where(rand_ids == sel[:, None], -1, rand_ids)
            rj = torch.as_tensor(rand_ids, device=dev)
            safe = rj.long().clamp_min(0)
            ip = _dots(x[safe], qv)
            if metric == "l2":
                qn = torch.sum(qv * qv, dim=-1)
                rd = norms[safe] - 2.0 * ip + qn[:, None]
            else:
                rd = -ip
            rd = rd.masked_fill(rj < 0, INF)
            all_ids = torch.cat([knn_ids, rj], dim=1)
            all_d = torch.cat([knn_d, rd], dim=1)
            order = torch.argsort(all_d, dim=1, stable=True)
            knn_ids = torch.gather(all_ids, 1, order)
            knn_d = torch.gather(all_d, 1, order)
        pruned = occlusion_prune(knn_ids, knn_d, x, m_intra)
        nbrs_out[sel] = pruned.cpu().numpy()

        # Alg. 2: exact top-m_cross into each face-adjacent cube
        for direction in range(2 * m):
            rows = adj_rows[sel, direction]
            if np.all(rows < 0):
                continue
            cand_dir = cubes.members[np.maximum(rows, 0)].copy()
            cand_dir[rows < 0] = -1
            xids, _ = topk_over_candidates(
                qv, cand_dir, x, norms, m_cross,
                col_chunk=col_chunk, metric=metric)
            xnbrs_out[sel, direction] = xids.cpu().numpy()

    return LayerGraph(
        level=layer.level,
        layer=layer,
        cube_of=cube_of,
        cubes=cubes,
        nbrs=torch.as_tensor(nbrs_out, device=dev),
        xnbrs=torch.as_tensor(xnbrs_out.reshape(n, 2 * m * m_cross),
                              device=dev),
    )
