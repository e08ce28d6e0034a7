"""Public wrappers around the hand-written kernels: filter encoding,
device placement and the kernel dispatch.

A wrapper runs the CUDA kernel when its tensors live on the card and the
kernel's plain PyTorch twin when they live on the CPU (``device="cpu"``);
there is no other fallback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.filters import (BallFilter, BoxFilter, ComposeFilter, Filter,
                            IntervalFilter)
from ..device import as_tensor, resolve_device
from .distance import pairwise_dist_call
from .filtered_topk import filtered_topk_call
from .ref import PAD_META

__all__ = ["pairwise_dist", "filtered_topk", "next_pow2", "round_up",
           "encode_filter", "exact_filtered_search", "PAD_META"]

_POS = 1e30


def _pad_to(a: torch.Tensor, axis: int, mult: int, value) -> torch.Tensor:
    pad = (-a.shape[axis]) % mult
    if pad == 0:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    return torch.cat([a, a.new_full(shape, value)], dim=axis)


def next_pow2(v: int) -> int:
    """Smallest power of two >= v — the rounding rule behind the kernel's
    kpad padding."""
    p = 1
    while p < v:
        p *= 2
    return p


def round_up(v: int, mult: int) -> int:
    """Smallest multiple of ``mult`` >= max(v, 1)."""
    return ((max(v, 1) + mult - 1) // mult) * mult


def pairwise_dist(q, x, metric: str = "l2", device=None) -> torch.Tensor:
    """[bq, d] x [n, d] -> [bq, n] fp32 distance matrix (kernel B2).

    numpy inputs become fp32 tensors on ``device`` (default: the card);
    fp32 or bf16 tensors keep their dtype."""
    dev = resolve_device(device, q, x)

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        return as_tensor(np.asarray(a, np.float32), dev)
    return pairwise_dist_call(put(q), put(x), metric=metric)


def _flatten_and(filt: Filter):
    """Flatten nested 'and' compositions into a list of leaf filters."""
    if isinstance(filt, ComposeFilter) and filt.op == "and":
        return _flatten_and(filt.a) + _flatten_and(filt.b)
    return [filt]


def encode_filter(filt: Optional[Filter], m: int,
                  mpad: int = 128) -> Optional[Tuple[str, np.ndarray]]:
    """Filter object -> (kind, packed [4, mpad] params) or None if the filter
    has no kernel encoding.

    Box rows default to (-1e30, +1e30) per dim, so half-open intervals
    encode without a synthetic bound: metadata padding rows carry +2e30 and
    still fail every box test.  Conjunctions of boxes/intervals fold into
    one box; one ball plus any boxes/intervals encodes as ``box_ball``.
    """
    params = np.zeros((4, mpad), np.float32)
    params[0, :] = -_POS
    params[1, :] = _POS
    params[3, 0] = _POS          # ball r^2 (pass-all by default)
    params[3, 1] = 0             # ball ndim

    def put_box(lo, hi):
        params[0, :m] = np.maximum(params[0, :m], np.asarray(lo, np.float32))
        params[1, :m] = np.minimum(params[1, :m], np.asarray(hi, np.float32))

    def put_interval(f: IntervalFilter) -> bool:
        if f.dim >= m:
            return False
        if f.lo is not None:
            params[0, f.dim] = max(params[0, f.dim],
                                   float(np.asarray(f.lo)))
        if f.hi is not None:
            params[1, f.dim] = min(params[1, f.dim],
                                   float(np.asarray(f.hi)))
        return True

    def put_ball(f: BallFilter):
        c = np.asarray(f.center, np.float32)
        params[2, : len(c)] = c
        params[3, 0] = float(np.asarray(f.radius)) ** 2
        params[3, 1] = len(c)

    if filt is None:
        return "none", params
    if isinstance(filt, BoxFilter):
        put_box(filt.lo, filt.hi)
        return "box", params
    if isinstance(filt, IntervalFilter):
        return ("box", params) if put_interval(filt) else None
    if isinstance(filt, BallFilter):
        put_ball(filt)
        return "ball", params
    if isinstance(filt, ComposeFilter):
        if filt.op == "andnot":
            # (boxes/intervals) \ ball
            b = filt.b
            parts = _flatten_and(filt.a)
            if isinstance(b, BallFilter) and all(
                    isinstance(p, (BoxFilter, IntervalFilter)) for p in parts):
                for p in parts:
                    if isinstance(p, BoxFilter):
                        put_box(p.lo, p.hi)
                    elif not put_interval(p):
                        return None
                put_ball(b)
                return "box_not_ball", params
            return None
        if filt.op == "and":
            parts = _flatten_and(filt)
            balls = [p for p in parts if isinstance(p, BallFilter)]
            rest = [p for p in parts if not isinstance(p, BallFilter)]
            if len(balls) > 1 or not all(
                    isinstance(p, (BoxFilter, IntervalFilter)) for p in rest):
                return None
            for p in rest:
                if isinstance(p, BoxFilter):
                    put_box(p.lo, p.hi)
                elif not put_interval(p):
                    return None
            if not balls:
                return "box", params
            put_ball(balls[0])
            return "box_ball", params
    return None


def filtered_topk(q, x, s, filt: Optional[Filter], k: int,
                  metric: str = "l2", device=None):
    """Fused brute-force filtered top-k (exact, kernel B1): returns
    ``(ids [bq, k] int32 with -1 misses, dists [bq, k] ascending)`` as
    tensors on ``device`` (default: the card, or the inputs' device when
    they are tensors).

    A filter without a kernel encoding (polygons, 'or' compositions) is
    evaluated with the filter object; rows it rejects get ``PAD_META``
    metadata and the same kernel scans them with kind ``none``, so every
    distance is computed one way whatever the filter.
    """
    dev = resolve_device(device, q, x, s)
    q = as_tensor(q, dev, torch.float32)
    x = as_tensor(x, dev, torch.float32)
    s = as_tensor(s, dev, torch.float32)
    m = s.shape[1]
    mp = max(m, 2)
    enc = encode_filter(filt, m, mpad=mp)
    if enc is None:
        ok = filt.contains(s)
        s = torch.where(ok[:, None], s, torch.full_like(s, PAD_META))
        kind, params = encode_filter(None, m, mpad=mp)
    else:
        kind, params = enc
    kpad = next_pow2(max(k, 8))
    dd, ids = filtered_topk_call(q[None], x[None], s[None],
                                 as_tensor(params, dev)[None], kind, kpad,
                                 metric=metric)
    return ids[0, :, :k], dd[0, :, :k]


def exact_filtered_search(q, x, s, filt: Optional[Filter], k: int,
                          metric: str = "l2", device=None):
    """Ground-truth generator: exact filtered top-k at kernel speed."""
    return filtered_topk(q, x, s, filt, k, metric=metric, device=device)
