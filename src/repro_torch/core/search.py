"""Batched stitched-graph beam search (paper §4.3, Alg. 3 + Alg. 4).

Execution model: a loop over fixed-shape state, expanding the best ``W``
unexpanded beam nodes *per query batch* each hop.  Neighbor gathers,
distance evaluation (one batched product), predicate evaluation, and the
beam/result merges (masked top-k) are all batched over queries.  The state
keeps fixed shapes so the loop body can later be captured as a CUDA graph;
the loop condition is read on the host once per hop.

Routing modes unify the paper's method and its baselines:

* ``route_mode='cube'``   — CubeGraph: follow an edge iff the target's cube is
  in the active-cube set **or** the target satisfies φ (the latter only
  matters with ``dynamic_cubes=True``, Alg. 4's discovery rule).
* ``route_mode='all'``    — PostFiltering traversal (filter ignored while
  routing).
* ``route_mode='filter'`` — PreFiltering / ACORN-style predicate-gated
  traversal.

``collect_all=True`` makes the result set ignore φ (true post-hoc
PostFiltering; the caller applies φ afterwards).

Every top-k is a stable sort, so distance ties keep the lower buffer
position first, as the reference's ``top_k`` does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .filters import Filter

__all__ = ["beam_search", "SearchParams"]

INF = float("inf")
_I32_MAX = int(np.iinfo(np.int32).max)


def _unique_mask(ids: torch.Tensor) -> torch.Tensor:
    """Boolean mask keeping the first occurrence of each id per row. [b, k]"""
    sorted_ids, order = torch.sort(ids, dim=1, stable=True)
    first = torch.cat([torch.ones_like(sorted_ids[:, :1], dtype=torch.bool),
                       sorted_ids[:, 1:] != sorted_ids[:, :-1]], dim=1)
    out = torch.zeros_like(first)
    return out.scatter(1, order, first)


def _take(a: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, sel)


def _merge_topk(ids_a, d_a, ids_b, d_b, k):
    ids = torch.cat([ids_a, ids_b], dim=1)
    d = torch.cat([d_a, d_b], dim=1)
    sd, sel = torch.sort(d, dim=1, stable=True)
    return _take(ids, sel[:, :k]), sd[:, :k]


class SearchParams:
    """Static search configuration (hashable)."""

    def __init__(self, k: int = 10, ef: int = 64, width: int = 4,
                 max_iters: int = 512, metric: str = "l2",
                 route_mode: str = "cube", dynamic_cubes: bool = False,
                 collect_all: bool = False):
        self.k = int(k)
        self.ef = int(max(ef, k))
        self.width = int(width)
        self.max_iters = int(max_iters)
        self.metric = metric
        self.route_mode = route_mode
        self.dynamic_cubes = bool(dynamic_cubes)
        self.collect_all = bool(collect_all)

    def _key(self):
        return (self.k, self.ef, self.width, self.max_iters, self.metric,
                self.route_mode, self.dynamic_cubes, self.collect_all)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, SearchParams) and self._key() == other._key()


def _beam_search(x, s, norms, valid, cube_of, all_nbrs, q, filt: Filter,
                 active_cubes, seeds, tie_key, p: SearchParams):
    """Core loop.  Shapes (all tensors on one device):
    x [n,d], s [n,m] fp32, norms [n], valid bool[n], cube_of int32[n],
    all_nbrs int32[n, deg], q [b,d], active_cubes int64[cmax] (-1 pad,
    shared across the batch — one filter per call), seeds int64[e],
    tie_key int32[n] or None (see ``beam_search``).
    Returns (ids [b,k] int32, dists [b,k], hops) sorted ascending by
    (dist, tie key); -1/inf padded.
    """
    dev = x.device
    n, d = x.shape
    b = q.shape[0]
    k, ef, w = p.k, p.ef, p.width
    qn = torch.sum(q * q, dim=-1)
    nbrs = all_nbrs.long()
    cube_of = cube_of.long()

    def distances(cand):                               # [b, kc] ids -> dists
        safe = cand.clamp_min(0)
        ip = torch.bmm(x[safe], q[:, :, None])[:, :, 0]
        if p.metric == "l2":
            return norms[safe] - 2.0 * ip + qn[:, None]
        return -ip

    def phi(cand):                                     # [b, kc] ids -> bool
        return filt.contains(s[cand.clamp_min(0)])

    # ---- init from seed entry points (shared across batch) ----------------
    seed_b = seeds[None, :].expand(b, seeds.shape[0])
    seed_ok = (seed_b >= 0) & valid[seed_b.clamp_min(0)]
    sd = torch.where(seed_ok, distances(seed_b), INF)
    sphi = phi(seed_b) & seed_ok

    visited = torch.zeros((b, n), dtype=torch.uint8, device=dev)
    visited.scatter_reduce_(
        1, seeds.clamp_min(0)[None, :].expand(b, -1).contiguous(),
        (seed_b >= 0).to(torch.uint8), reduce="amax")

    neg1 = torch.tensor(-1, dtype=torch.long, device=dev)
    pad_i = torch.full((b, ef), -1, dtype=torch.long, device=dev)
    pad_d = torch.full((b, ef), INF, device=dev)
    beam_ids, beam_d = _merge_topk(pad_i, pad_d,
                                   torch.where(seed_ok, seed_b, neg1), sd, ef)
    beam_exp = torch.zeros((b, ef), dtype=torch.bool, device=dev)

    res_keep = sphi | (p.collect_all & seed_ok)
    res_ids, res_d = _merge_topk(
        torch.full((b, k), -1, dtype=torch.long, device=dev),
        torch.full((b, k), INF, device=dev),
        torch.where(res_keep, seed_b, neg1),
        torch.where(res_keep, sd, INF), k)
    cubes = active_cubes

    it = 0
    while it < p.max_iters:
        # cond: some unexpanded beam entry still beats the k-th result
        frontier = torch.where(beam_exp | (beam_ids < 0), INF, beam_d)
        kth = res_d[:, k - 1]
        if not bool(torch.any(frontier.min(dim=1).values < kth)):
            break

        # -- pick top-W unexpanded beam entries (Alg. 3/4 line 6) ----------
        fd, sel = torch.sort(frontier, dim=1, stable=True)
        fd, sel = fd[:, :w], sel[:, :w]
        exp_ok = fd < kth[:, None]                     # only expand improving
        exp_ids = torch.where(exp_ok, _take(beam_ids, sel), neg1)
        beam_exp = beam_exp.scatter(1, sel, True)

        # -- gather intra + cross neighbors (Fig. 3 node block) ------------
        nb = nbrs[exp_ids.clamp_min(0)]                 # [b, w, deg]
        nb = torch.where(exp_ids[:, :, None] >= 0, nb, neg1)
        cand = nb.reshape(b, -1)                        # [b, kc]
        safe = cand.clamp_min(0)

        fresh = (cand >= 0) & valid[safe]
        fresh &= torch.gather(visited, 1, safe) == 0
        fresh &= _unique_mask(cand)

        # -- predicate + cube gating (Alg. 3 l.8-11 / Alg. 4 l.7-11) --------
        phi_pass = phi(cand) & fresh
        ccube = cube_of[safe]
        if p.route_mode == "cube":
            route = fresh & (torch.isin(ccube, cubes) | phi_pass)
        elif p.route_mode == "all":
            route = fresh
        else:                                           # 'filter'
            route = fresh & phi_pass

        dval = distances(cand)
        droute = torch.where(route, dval, INF)

        # OR into visited; -1 candidates map to column 0 with value 0, so a
        # set bit there is never cleared
        visited.scatter_reduce_(1, safe, route.to(torch.uint8), reduce="amax")

        if p.dynamic_cubes:
            # Alg. 4 line 10: activate cubes of φ-passing points (set-insert
            # with dedupe; cube set is shared across the batch — one filter).
            disc = torch.where(phi_pass, ccube.long(), neg1).reshape(-1)
            comb = torch.cat([cubes, disc])
            comb = torch.sort(comb, descending=True).values
            dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                             comb[1:] == comb[:-1]])
            comb = torch.where(dup, neg1, comb)
            cubes = torch.sort(comb, descending=True).values[: cubes.shape[0]]

        # -- beam + result merges (keep top ef / top k) ---------------------
        ids = torch.cat([beam_ids, cand], dim=1)
        dd = torch.cat([beam_d, droute], dim=1)
        ee = torch.cat([beam_exp, torch.zeros_like(cand, dtype=torch.bool)],
                       dim=1)
        beam_d, bsel = torch.sort(dd, dim=1, stable=True)
        beam_d, bsel = beam_d[:, :ef], bsel[:, :ef]
        beam_ids, beam_exp = _take(ids, bsel), _take(ee, bsel)
        res_keep = phi_pass | (p.collect_all & route)
        res_ids, res_d = _merge_topk(
            res_ids, res_d, torch.where(res_keep, cand, neg1),
            torch.where(res_keep, dval, INF), k)
        it += 1

    res_ids = torch.where(torch.isfinite(res_d), res_ids, neg1)
    # Deterministic (dist, tie-key) output order: a stable sort on the key,
    # then a stable sort on the distance (the reference's lexsort).
    key = res_ids if tie_key is None else tie_key[res_ids.clamp_min(0)].long()
    key = torch.where(res_ids >= 0, key, _I32_MAX)
    order = torch.sort(key, dim=1, stable=True).indices
    order = _take(order, torch.sort(_take(res_d, order), dim=1,
                                    stable=True).indices)
    return _take(res_ids, order).to(torch.int32), _take(res_d, order), it


def beam_search(
    x: torch.Tensor, s: torch.Tensor, norms: torch.Tensor, valid,
    cube_of: torch.Tensor, all_nbrs: torch.Tensor,
    queries, filt: Filter,
    active_cubes, seeds,
    params: SearchParams, tie_key=None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Public entry point; see `_beam_search` for shapes.  Host inputs
    (queries, validity, plans, tie keys) are moved to ``x``'s device.

    ``tie_key`` (optional, int [n]) supplies a per-point sort key used only
    to break exact distance ties in the final result ordering; pass the
    segment's global ids so that duplicated vectors land in a stable
    (dist, gid) order regardless of local id assignment.  Defaults to the
    local id.  Returns ``(ids, dists, hops)``.
    """
    dev = x.device

    def put(a, dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dtype)
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)
    tk = None if tie_key is None else put(tie_key, torch.int32)
    return _beam_search(
        x.float(), s.float(), norms.float(), put(valid, torch.bool),
        put(cube_of, torch.int32), all_nbrs,
        put(queries, torch.float32), filt,
        put(active_cubes, torch.long), put(seeds, torch.long), tk, params)
