"""The comparison that decides ``correct``, and recall@k.

Every answer the window returned is held against the plain reference for
its batch.  Answers to one pool entry that are identical are judged once
and counted as often as they came.  The numbers, per query row:

* ``bad_answers`` — rows with a returned id that is not live, not inside
  the box, or repeated, or with fewer ids than the reference finds (a
  left-out query, a lost block).  Limit 0: an exact comparison.
* ``dist_err`` — the widest gap between a returned distance and the fp64
  distance of the returned id, over ``max(true distance, FLOOR * |q|^2)``.
* ``rank_gap`` — the widest gap by which the returned neighbours, sorted by
  their fp64 distance, lie beyond the reference's exact neighbours of the
  same rank, on the same scale.
* ``miss_share`` — the share of the reference's neighbours left out
  (1 - recall@k).

``dist_err`` and ``rank_gap`` are relative: 1e-6 is a rounding error of
fp32 at these norms, 1e-3 a TF32 product.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import reference

FLOOR = 1e-3            # scale floor, as a share of the query's |q|^2
NUMBERS = ("bad_answers", "dist_err", "rank_gap", "miss_share")


@dataclasses.dataclass
class Truth:
    """The reference's answer to one pool batch."""

    ids: torch.Tensor          # [b, k] int64, -1 padded
    dists: torch.Tensor        # [b, k] fp64, +inf padded
    passing: torch.Tensor      # [n] bool: live and inside the box
    q: torch.Tensor            # [b, d] fp32 queries on the device
    scale: torch.Tensor        # [b] fp64: FLOOR * |q|^2


def truth_for(x, meta, alive, queries: np.ndarray, lo, hi, k: int) -> Truth:
    q = torch.as_tensor(queries, device=x.device)
    ids, dists = reference.exact_topk(x, meta, alive, q, lo, hi, k)
    passing = alive & reference.in_box(meta, lo, hi)
    scale = FLOOR * (q.double() ** 2).sum(1)
    return Truth(ids, dists, passing, q, scale)


@dataclasses.dataclass
class Tally:
    """Running totals over every judged answer."""

    rows: int = 0
    bad_rows: int = 0
    dist_err: float = 0.0
    rank_gap: float = 0.0
    hits: int = 0
    wanted: int = 0

    def numbers(self) -> Dict[str, float]:
        return {"bad_answers": float(self.bad_rows),
                "dist_err": self.dist_err, "rank_gap": self.rank_gap,
                "miss_share": 1.0 - self.hits / max(self.wanted, 1)}

    @property
    def recall(self) -> float:
        return self.hits / max(self.wanted, 1)


def judge_answer(tally: Tally, x: torch.Tensor, truth: Truth,
                 gids: np.ndarray, dists: np.ndarray, count: int = 1) -> None:
    """Add one returned ``(gids [b, k], dists [b, k])`` to ``tally``,
    ``count`` times."""
    dev = x.device
    g = torch.as_tensor(np.asarray(gids, np.int64), device=dev)
    d = torch.as_tensor(np.asarray(dists, np.float64), device=dev)
    b, k = truth.ids.shape
    if g.shape != (b, k):
        tally.rows += b * count
        tally.bad_rows += b * count
        return
    valid = g >= 0
    n = truth.passing.shape[0]
    in_range = valid & (g < n)
    ok_id = torch.zeros_like(valid)
    ok_id[in_range] = truth.passing[g[in_range]]
    srt = torch.sort(torch.where(valid, g, -1 - torch.arange(
        k, device=dev)[None, :].expand(b, k)), dim=1).values
    repeated = (srt[:, 1:] == srt[:, :-1]).any(1)
    want = (truth.ids >= 0).sum(1)
    bad = ((valid & ~ok_id).any(1) | repeated | (valid.sum(1) < want))
    true_d = reference.sq_dists64(x, truth.q, torch.where(ok_id, g, -1))
    good = ~bad
    scale = truth.scale[:, None]
    if good.any():
        err = torch.where(ok_id, (d - true_d).abs() / torch.maximum(
            true_d, scale), torch.zeros_like(true_d))
        tally.dist_err = max(tally.dist_err, float(err[good].max()))
        mine = torch.sort(true_d, dim=1).values
        ranked = truth.ids >= 0
        gap = torch.where(ranked, (mine - truth.dists) / torch.maximum(
            truth.dists, scale), torch.zeros_like(mine))
        tally.rank_gap = max(tally.rank_gap, float(gap[good].max()))
    hit = (g[:, :, None] == truth.ids[:, None, :]) & (truth.ids[:, None, :]
                                                        >= 0)
    tally.hits += int(hit.any(1).sum()) * count
    tally.wanted += int(want.sum()) * count
    tally.rows += b * count
    tally.bad_rows += int(bad.sum()) * count


def unique_answers(answers: List[Tuple[int, np.ndarray, np.ndarray]]
                   ) -> List[Tuple[int, np.ndarray, np.ndarray, int]]:
    """``(pool index, gids, dists)`` per call -> the distinct answers per
    pool index, each with how often it came."""
    seen: Dict[int, List[list]] = {}
    for i, g, d in answers:
        for entry in seen.setdefault(i, []):
            if np.array_equal(entry[0], g) and np.array_equal(entry[1], d):
                entry[2] += 1
                break
        else:
            seen[i].append([g, d, 1])
    return [(i, g, d, c) for i, lst in seen.items() for g, d, c in lst]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """``(correct, {name: {value, limit}})``: correct when every number
    that has a limit is at or under it."""
    checks = {n: {"value": numbers[n], "limit": limits[n]}
              for n in NUMBERS if n in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
