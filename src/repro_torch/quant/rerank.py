"""Exact fp32 rerank of a quantized read's over-fetched candidates.

The quantized read path returns approximate ``(gid, dist)`` candidates;
this stage looks the candidates' original fp32 vectors up in the manager's
point store, re-scores them exactly on the device, and normalizes the
result through ``host_topk`` so the output obeys the same deterministic
``(dist, gid)`` tie-break as the unquantized merge.

The scores come from kernel B4 (``kernels.graph_topk.beam_step_scores``,
the gathered-row distance of the graph read path) over the looked-up rows
as one block: its summation order depends on ``d`` alone, so a point's
exact distance is the same whatever the candidate list's width or the
batch — the deadline path's per-bucket reranks and the bulk rerank give
the same answer bit for bit on the card, as on the CPU (a library batched
product rounds differently for other shapes).
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["rerank_exact"]


def rerank_exact(queries: np.ndarray, cand_gids: np.ndarray, k: int,
                 lookup: Callable, metric: str = "l2", device=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Candidate gids ``[b, s]`` (``-1`` padded) -> exact fp32
    ``(gids [b, k], dists [b, k])``.

    ``lookup(gids) -> (x, s, present)`` supplies the original fp32 vectors
    (``SegmentManager.get_points``); candidates whose row is gone
    (``present=False``) are dropped, which matches the downstream liveness
    filter.  Per-row candidate lists are sorted by gid before the top-k so
    distance ties at the k-th boundary resolve to the smallest gid, and
    duplicated gids within a row are masked.  The scoring runs on
    ``device`` (default: the card)."""
    from ..distributed.segment_shards import host_topk
    from ..kernels.graph_topk import beam_step_scores
    from ..kernels.ops import encode_filter

    dev = resolve_device(device)
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    cand = np.atleast_2d(np.asarray(cand_gids, np.int64))
    b = queries.shape[0]
    uniq = np.unique(cand[cand >= 0])
    if len(uniq) == 0:
        return (np.full((b, k), -1, np.int64),
                np.full((b, k), np.inf, np.float32))
    x, _, present = lookup(uniq)
    pos = np.searchsorted(uniq, np.maximum(cand, 0))
    local = np.where((cand >= 0) & present[pos], pos, len(uniq))
    local.sort(axis=1)                     # ascending local id == gid order
    if local.shape[1] > 1:                 # defensive within-row dedup
        dup = local[:, 1:] == local[:, :-1]
        local[:, 1:][dup] = len(uniq)
    local = np.where(local < len(uniq), local, -1).astype(np.int32)
    xj = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    pos = torch.as_tensor(local, device=dev)
    # the looked-up rows as one block [1, U, d]; kind "none" over zero
    # metadata (the predicate is not read: only the distances are)
    meta = torch.zeros((1, xj.shape[0], 1), dtype=torch.float32, device=dev)
    params = torch.as_tensor(encode_filter(None, 1, mpad=2)[1], device=dev)
    dd, _ = beam_step_scores(torch.as_tensor(queries, device=dev), pos,
                             xj[None], meta, params, "none", metric=metric)
    # the candidates are in gid order: a stable sort keeps the smaller gid
    # first among equal distances; -1 lanes score +inf
    kk = min(k, local.shape[1])
    sd, order = torch.sort(dd, dim=1, stable=True)
    sd = sd[:, :kk]
    ids = torch.gather(pos.long(), 1, order[:, :kk])
    ids = torch.where(torch.isfinite(sd), ids, -1).cpu().numpy()
    g = np.where(ids >= 0, uniq[np.maximum(ids, 0)], -1)
    return host_topk(g, sd.cpu().numpy().astype(np.float32), k)
