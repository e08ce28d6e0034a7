"""Plain PyTorch oracles for the hand-written kernels.

These are the semantics the CUDA kernels are held to on the card, and the
functions the CPU parity tests hold against the JAX package's own oracles.
"""
from __future__ import annotations

import math

import torch

__all__ = ["pairwise_sq_l2", "pairwise_neg_ip", "inner_products",
           "filter_mask_ref", "filtered_topk_ref", "quant_filtered_topk_ref",
           "beam_step_ref", "flash_decode_ref", "topk_by_dist_id",
           "FILTER_KINDS", "PAD_META"]

FILTER_KINDS = ("none", "box", "ball", "box_not_ball", "box_ball")
_POS = 1e30
# Metadata sentinel for padding / dead rows: every filter kind (including
# "none") rejects rows whose metadata carries this value.
PAD_META = 2e30
# Elements of one [bq, chunk, d] product in the CPU inner-product loop.
_CPU_PRODUCT_ELEMS = 1 << 22


def inner_products(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[bq, d] x [n, d] -> fp32 inner products [bq, n].

    On the CPU each entry is a row-wise sum of the elementwise product,
    whose summation order depends on ``d`` alone: the BLAS blocks a
    ``[bq, n]`` product differently for other ``bq`` and ``n``, and the
    port's invariants (a shard stack answers bit-for-bit like the
    monolithic scan, an incremental pack like a cold build) are checked
    on the CPU.  On the card, where the twin is only a yardstick held
    within a tolerance, it is one matrix product."""
    qf, xf = q.float(), x.float()
    if qf.device.type != "cpu":
        return qf @ xf.T
    bq, d = qf.shape
    n = xf.shape[0]
    out = qf.new_empty((bq, n))
    step = max(1, _CPU_PRODUCT_ELEMS // max(bq * d, 1))
    for c0 in range(0, n, step):
        out[:, c0:c0 + step] = (qf[:, None, :]
                                * xf[None, c0:c0 + step, :]).sum(-1)
    return out


def pairwise_sq_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[bq, d] x [n, d] -> squared L2 distances [bq, n] (fp32 accumulation),
    as ``‖q‖² − 2·q·x + ‖x‖²``."""
    qf, xf = q.float(), x.float()
    qn = torch.sum(qf * qf, dim=-1)
    xn = torch.sum(xf * xf, dim=-1)
    return qn[:, None] - 2.0 * inner_products(qf, xf) + xn[None, :]


def pairwise_neg_ip(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Negated inner product (so smaller = more similar), fp32 accumulation."""
    return -inner_products(q, x)


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


def quant_filtered_topk_ref(qs, codes, s, xsq, kind: str, params, k: int,
                            metric: str = "l2"):
    """Asymmetric int8 filtered top-k oracle (kernel B3's semantics):
    scale-folded queries ``qs [bq, d]`` against int8 ``codes [n, d]`` in
    fp32; L2 emits the partial distance ``xsq − 2·ip`` (the caller adds
    ``‖q‖²``), IP emits ``−ip``.  Returns ``(dists [bq, k], ids [bq, k])``
    ascending by (dist, id), ``+inf`` / ``-1`` for misses."""
    ip = inner_products(qs, codes.float())
    d = xsq.float()[None, :] - 2.0 * ip if metric == "l2" else -ip
    ok = filter_mask_ref(s, kind, params)
    d = torch.where(ok[None, :], d, torch.full_like(d, float("inf")))
    return topk_by_dist_id(d, k)


def beam_step_ref(q, cand_x, cand_meta, kind: str, params,
                  metric: str = "l2"):
    """One traversal hop's scores (kernel B4's semantics) over a gathered
    tile: ``q [b, d]``, ``cand_x [b, c, d]`` fp32, ``cand_meta [b, c, m]``
    -> ``(dists [b, c] raw, ok [b, c] int32 predicate mask)``.  L2 is
    ``(‖x‖² − 2·ip) + ‖q‖²`` with ‖x‖² recomputed from the gathered row."""
    qf, cx = q.float(), cand_x.float()
    ip = (cx * qf[:, None, :]).sum(-1)
    if metric == "l2":
        qn = (qf * qf).sum(-1)
        xn = (cx * cx).sum(-1)
        d = xn - 2.0 * ip + qn[:, None]
    else:
        d = -ip
    ok = filter_mask_ref(cand_meta, kind, params)
    return d, ok.to(torch.int32)


def flash_decode_ref(q, k, v, lengths, window: int = -1):
    """Oracle for the fused decode-attention kernel (B5), fp32 throughout.
    q [bkv, g, hd], k / v [bkv, smax, hd], lengths [bkv] (inclusive
    prefix) -> o [bkv, g, hd] in q's dtype.  ``window >= 0`` keeps row
    ``r`` to columns ``max(0, lengths[r] - window) .. lengths[r]``
    (the reference decode's sliding window); -1 is global."""
    qf, kf, vf = q.float(), k.float(), v.float()
    hd = q.shape[-1]
    scores = torch.einsum("bgd,bsd->bgs", qf, kf) / math.sqrt(hd)
    col = torch.arange(k.shape[1], device=q.device)[None, None, :]
    end = lengths.long()[:, None, None]
    out = col > end
    if window >= 0:
        out = out | (col < end - window)
    scores = scores.masked_fill(out, -1e30)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bgs,bsd->bgd", attn, vf).to(q.dtype)
