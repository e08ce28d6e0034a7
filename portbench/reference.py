"""The plain reference: exact filtered top-k, and the controls below it.

Plain PyTorch, run on whatever device holds the corpus, with TF32 off.
It imports nothing of the program and takes nothing the program made:
the benchmark hands it the corpus it generated, its own live set (the
rows inside the retention, less the deletes it sent) and each batch's
queries and box.

* :func:`exact_topk` — the truth: every live row inside the box is a
  candidate; squared L2 distances by the norm expansion in fp32 pick
  ``k + EXTRA`` candidates per query, which are scored again in fp64 and
  sorted.  The fp32 expansion's error (about 1e-4 at these norms) is far
  below the distance between the 10th and the 32nd neighbour, so the
  top-k is exact.
* :func:`control_topk` — the same search put in the program's place one
  precision step below the configuration: ``tf32`` (the products from
  operands rounded to TF32's 10-bit mantissa, accumulated in fp32, as a
  TF32 tensor-core GEMM does) or ``int4`` (per-dimension int4 codes,
  ``rerank_multiple * k`` over-fetched, then exact fp32 distances).
"""
from __future__ import annotations

from typing import Tuple

import torch

EXTRA = 22              # candidates beyond k that the fp64 pass re-scores
QUERY_BLOCK = 1024      # query rows per block: bounds the [b, n] matrix


def _highest_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def in_box(meta: torch.Tensor, lo, hi) -> torch.Tensor:
    """Rows whose every column lies in ``[lo, hi]`` (fp32, inclusive)."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=meta.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=meta.device)
    return ((meta >= lo) & (meta <= hi)).all(dim=1)


def candidates(meta: torch.Tensor, alive: torch.Tensor, lo, hi
               ) -> torch.Tensor:
    """Row ids of the live rows inside the box, ascending."""
    return torch.nonzero(alive & in_box(meta, lo, hi)).flatten()


def sq_dists64(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor
               ) -> torch.Tensor:
    """fp64 squared L2 distance of each query to each of its ids [b, c];
    +inf where an id is -1."""
    out = torch.full(ids.shape, float("inf"), dtype=torch.float64,
                     device=x.device)
    for lo in range(0, q.shape[0], QUERY_BLOCK):
        i = ids[lo:lo + QUERY_BLOCK]
        rows = x[i.clamp(min=0)].double()
        d = ((q[lo:lo + QUERY_BLOCK, None, :].double() - rows) ** 2).sum(-1)
        out[lo:lo + QUERY_BLOCK] = torch.where(i >= 0, d, out[lo:lo + QUERY_BLOCK])
    return out


def _pad(ids: torch.Tensor, d: torch.Tensor, k: int):
    b, c = ids.shape
    if c >= k:
        return ids, d
    pi = torch.full((b, k - c), -1, dtype=ids.dtype, device=ids.device)
    pd = torch.full((b, k - c), float("inf"), dtype=d.dtype, device=d.device)
    return torch.cat([ids, pi], 1), torch.cat([d, pd], 1)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32's 10-bit mantissa, to nearest, ties to even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _expansion(q: torch.Tensor, xs: torch.Tensor, xn: torch.Tensor
               ) -> torch.Tensor:
    return (q * q).sum(1, keepdim=True) + xn[None, :] - 2.0 * (q @ xs.T)


def exact_topk(x: torch.Tensor, meta: torch.Tensor, alive: torch.Tensor,
               q: torch.Tensor, lo, hi, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact filtered top-k: ``(ids [b, k] int64, fp64 squared distances
    [b, k])``, -1 / +inf padded where fewer than k rows pass."""
    _highest_precision()
    cand = candidates(meta, alive, lo, hi)
    b = q.shape[0]
    if len(cand) == 0:
        return _pad(torch.empty((b, 0), dtype=torch.int64, device=x.device),
                    torch.empty((b, 0), dtype=torch.float64, device=x.device),
                    k)
    xs = x[cand]
    xn = (xs * xs).sum(1)
    c = min(k + EXTRA, len(cand))
    picks = []
    for lo_q in range(0, b, QUERY_BLOCK):
        qb = q[lo_q:lo_q + QUERY_BLOCK]
        d = _expansion(qb, xs, xn)
        picks.append(cand[torch.topk(d, c, dim=1, largest=False).indices])
    ids = torch.cat(picks)
    d64 = sq_dists64(x, q, ids)
    d64, order = torch.sort(d64, dim=1, stable=True)
    ids = torch.gather(ids, 1, order)
    return _pad(ids[:, :k], d64[:, :k], k)


def control_topk(kind: str, x: torch.Tensor, meta: torch.Tensor,
                 alive: torch.Tensor, q: torch.Tensor, lo, hi, k: int,
                 rerank_multiple: int = 4
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference one precision step down, as the program would answer:
    ``(ids [b, k] int64, fp32 distances [b, k])``."""
    _highest_precision()
    cand = candidates(meta, alive, lo, hi)
    b = q.shape[0]
    if len(cand) == 0:
        return _pad(torch.empty((b, 0), dtype=torch.int64, device=x.device),
                    torch.empty((b, 0), dtype=torch.float32, device=x.device),
                    k)
    xs = x[cand]
    if kind == "int4":
        live = x[alive]
        scale = live.abs().amax(0).clamp(min=1e-12) / 7.0
        approx = torch.round(xs / scale).clamp(-7, 7) * scale
        c = min(rerank_multiple * k, len(cand))
    elif kind == "tf32":
        approx = _tf32(xs)
        c = min(k, len(cand))
    else:
        raise ValueError(f"unknown control {kind!r}")
    # a TF32 GEMM rounds only the product's operands; the norms stay fp32
    an = (xs * xs if kind == "tf32" else approx * approx).sum(1)
    ids, dd = [], []
    for lo_q in range(0, b, QUERY_BLOCK):
        qb = q[lo_q:lo_q + QUERY_BLOCK]
        if kind == "tf32":
            d = (qb * qb).sum(1, keepdim=True) + an[None, :] \
                - 2.0 * (_tf32(qb) @ approx.T)
            top = torch.topk(d, c, dim=1, largest=False)
            ids.append(cand[top.indices])
            dd.append(top.values)
            continue
        pick = torch.topk(_expansion(qb, approx, an), c, dim=1,
                          largest=False).indices
        exact = ((qb[:, None, :] - xs[pick]) ** 2).sum(-1)
        top = torch.topk(exact, min(k, c), dim=1, largest=False)
        ids.append(cand[torch.gather(pick, 1, top.indices)])
        dd.append(top.values)
    return _pad(torch.cat(ids), torch.cat(dd), k)
