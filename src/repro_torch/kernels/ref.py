"""Plain PyTorch oracles for the hand-written kernels.

These are the semantics the CUDA kernels are held to on the card, and the
functions the CPU parity tests hold against the JAX package's own oracles.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_sq_l2", "pairwise_neg_ip", "filter_mask_ref",
           "filtered_topk_ref", "FILTER_KINDS", "PAD_META"]

FILTER_KINDS = ("none", "box", "ball", "box_not_ball", "box_ball")
_POS = 1e30
# Metadata sentinel for padding / dead rows: every filter kind (including
# "none") rejects rows whose metadata carries this value.
PAD_META = 2e30


def pairwise_sq_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[bq, d] x [n, d] -> squared L2 distances [bq, n] (fp32 accumulation),
    as ``‖q‖² − 2·q·x + ‖x‖²``."""
    qf, xf = q.float(), x.float()
    qn = torch.sum(qf * qf, dim=-1)
    xn = torch.sum(xf * xf, dim=-1)
    ip = qf @ xf.T
    return qn[:, None] - 2.0 * ip + xn[None, :]


def pairwise_neg_ip(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Negated inner product (so smaller = more similar), fp32 accumulation."""
    return -(q.float() @ x.float().T)


def filter_mask_ref(s: torch.Tensor, kind: str, params: torch.Tensor
                    ) -> torch.Tensor:
    """Evaluate the packed filter encoding the fused kernel reads.

    ``params`` layout (rows of a [4, mp] fp32 array, mp >= max(m, 2)):
      row 0: box lo       row 1: box hi
      row 2: ball center  row 3: [radius^2, ball_ndim, 0, ...]
    Rows whose first metadata column carries ``PAD_META`` fail every kind,
    ``none`` included.
    """
    s = s.float()
    m = s.shape[-1]
    params = params.float()
    in_box = torch.all((s >= params[0, :m]) & (s <= params[1, :m]), dim=-1)
    mc = int(params[3, 1].item())
    diff = s[..., :mc] - params[2, :mc]
    d2 = torch.sum(diff * diff, dim=-1)
    in_ball = d2 <= params[3, 0]
    if kind == "none":
        return s[..., 0] < _POS
    if kind == "box":
        return in_box
    if kind == "ball":
        return in_ball
    if kind == "box_not_ball":
        return in_box & ~in_ball
    if kind == "box_ball":
        return in_box & in_ball
    raise ValueError(kind)


def topk_by_dist_id(d: torch.Tensor, k: int):
    """Ascending ``(dist, column)`` top-k of each row of ``d`` — a stable
    sort, so equal distances keep the lower column first.  Rows with fewer
    than ``k`` columns are padded.  Returns ``(dists [.., k], ids [.., k])``
    with ``+inf`` / ``-1`` for misses."""
    n = d.shape[-1]
    dd, ids = torch.sort(d, dim=-1, stable=True)
    dd, ids = dd[..., :k], ids[..., :k].to(torch.int32)
    if n < k:
        pad = k - n
        dd = torch.cat([dd, dd.new_full(dd.shape[:-1] + (pad,), float("inf"))],
                       dim=-1)
        ids = torch.cat([ids, ids.new_full(ids.shape[:-1] + (pad,), -1)],
                        dim=-1)
    ids = torch.where(torch.isfinite(dd), ids, torch.full_like(ids, -1))
    dd = torch.where(torch.isfinite(dd), dd, torch.full_like(dd, float("inf")))
    return dd, ids


def filtered_topk_ref(q, x, s, kind: str, params, k: int, metric: str = "l2"):
    """Fused filtered exact top-k oracle: (dists [bq, k] ascending by
    (dist, id), ids [bq, k]); failing candidates get +inf / -1."""
    d = pairwise_sq_l2(q, x) if metric == "l2" else pairwise_neg_ip(q, x)
    ok = filter_mask_ref(s, kind, params)
    d = torch.where(ok[None, :], d, torch.full_like(d, float("inf")))
    return topk_by_dist_id(d, k)
