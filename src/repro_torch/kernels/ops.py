"""Public wrappers around the hand-written kernels: filter encoding,
device placement and the kernel dispatch.

A wrapper runs the CUDA kernel when its tensors live on the card and the
kernel's plain PyTorch twin when they live on the CPU (``device="cpu"``);
there is no other fallback.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.filters import (BallFilter, BoxFilter, ComposeFilter, Filter,
                            IntervalFilter)
from ..device import as_tensor, resolve_device
from .distance import pairwise_dist_call
from .filtered_topk import filtered_topk_call, filtered_topk_grouped_call
from .quant_topk import quant_topk_call
from .ref import PAD_META

__all__ = ["pairwise_dist", "filtered_topk", "next_pow2", "round_up",
           "encode_filter", "exact_filtered_search", "PAD_META",
           "block_layout", "sharded_filtered_topk",
           "sharded_filtered_topk_grouped", "sharded_quant_filtered_topk",
           "warm_sharded_shapes", "kernels_loaded"]

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
    kind, params, s = _encode_stack(filt, s, s.shape[1])
    kpad = next_pow2(max(k, 8))
    dd, ids = filtered_topk_call(q[None], x[None], s[None], params[None],
                                 kind, kpad, metric=metric)
    return ids[0, :, :k], dd[0, :, :k]


def exact_filtered_search(q, x, s, filt: Optional[Filter], k: int,
                          metric: str = "l2", device=None):
    """Ground-truth generator: exact filtered top-k at kernel speed."""
    return filtered_topk(q, x, s, filt, k, metric=metric, device=device)


# ---------------------------------------------------------------------------
# Shard-stack dispatch: block layouts, launch bookkeeping, warming
# ---------------------------------------------------------------------------
def block_layout(mode: str, rows: int, cap: int, d: int, m: int
                 ) -> Dict[str, Tuple[tuple, torch.dtype, object]]:
    """The device block layout of one bucket of the shard pack — the
    shared rule between the pack and the kernels (the port's stand-in for
    the reference's ``quant_meta_rows``).  ``{name: (shape, dtype, fill)}``:

    - ``"fp32"``: ``x [rows, cap, d]`` fp32 and ``s [rows, cap, m]`` fp32;
    - ``"int8"``: ``codes [rows, cap, d]`` int8 row-major, ``s [rows, cap,
      m]`` fp32, ``xsq [rows, cap]`` fp32 dequantized squared norms and
      ``scales [rows, d]`` fp32 per-row (per-segment) scales;

    plus ``gids [rows, cap]`` int32 in both.  Padding and dead rows carry
    ``PAD_META`` metadata, so every predicate rejects them.  No lane or
    sublane padding: a point costs ``4d + 4m + 4`` bytes (fp32) or
    ``d + 4m + 8`` (int8)."""
    out = {"s": ((rows, cap, m), torch.float32, PAD_META),
           "gids": ((rows, cap), torch.int32, -1)}
    if mode == "fp32":
        out["x"] = ((rows, cap, d), torch.float32, 0.0)
    elif mode == "int8":
        out["codes"] = ((rows, cap, d), torch.int8, 0)
        out["xsq"] = ((rows, cap), torch.float32, 0.0)
        out["scales"] = ((rows, d), torch.float32, 0.0)
    else:
        raise ValueError(f"unknown block mode {mode!r}")
    return out


def _encode_stack(filt: Optional[Filter], ss: torch.Tensor, m: int):
    """Filter -> ``(kind, params tensor, metadata stack)``.  A filter
    without a kernel encoding is evaluated with the filter object and the
    rows it rejects get ``PAD_META`` (kind ``none``): the single route,
    so every distance comes from the same kernel."""
    mp = max(m, 2)
    enc = encode_filter(filt, m, mpad=mp)
    if enc is None:
        ok = filt.contains(ss[..., :m])
        ss = torch.where(ok[..., None], ss, torch.full_like(ss, PAD_META))
        enc = encode_filter(None, m, mpad=mp)
    kind, params = enc
    return kind, as_tensor(params, ss.device), ss


def sharded_filtered_topk(q, xs, ss, filt: Optional[Filter], k: int,
                          metric: str = "l2", m: Optional[int] = None):
    """Shard-parallel fused filtered top-k: kernel B1 over a ``[g, n, d]``
    / ``[g, n, m]`` stack of ``g`` equal-capacity shard rows (the shard
    axis is B1's batch axis), one launch for the whole stack.  Ragged
    rows are padded with ``PAD_META`` metadata, which fails every
    predicate.  Returns ``(ids [g, bq, k], dists [g, bq, k])`` with
    shard-local ids (``-1`` misses) ascending by (distance, id)."""
    dev = xs.device
    q = as_tensor(q, dev, torch.float32)
    m = ss.shape[2] if m is None else int(m)
    kind, params, ss = _encode_stack(filt, ss, m)
    kpad = next_pow2(max(int(k), 8))
    dd, ids = filtered_topk_call(q[None], xs, ss, params[None], kind, kpad,
                                 metric=metric)
    return ids[:, :, :k], dd[:, :, :k]


def sharded_filtered_topk_grouped(groups, xs, ss, metric: str = "l2",
                                  m: Optional[int] = None):
    """Heterogeneous-filter shard-stack scan: several ``(q, filt, k)``
    request groups against ONE ``[g, n, d]`` / ``[g, n, m]`` shard stack.

    Groups whose filters share a kernel encoding class — the same filter
    ``kind`` and the same ``kpad = next_pow2(max(k, 8))`` — go into one
    grouped B1 launch per class (queries zero-padded to the class's
    widest group, one packed parameter block per group), which reads the
    stack in place once for the whole class.  Singleton classes and
    filters without a kernel encoding go through
    :func:`sharded_filtered_topk` unchanged.

    Returns a list of ``(ids [g, bq_i, k_i], dists [g, bq_i, k_i])``
    aligned with ``groups``, each bit for bit what
    ``sharded_filtered_topk(q_i, xs, ss, filt_i, k_i)`` returns alone: the
    kernel computes every query row independently, and a candidate's
    distance and the (distance, id) list order do not depend on the
    launch's grouping or splits."""
    groups = list(groups)
    dev = xs.device
    m = ss.shape[2] if m is None else int(m)
    mp = max(m, 2)
    out: list = [None] * len(groups)
    classes: Dict[Tuple[str, int], list] = {}
    for i, (q, filt, k) in enumerate(groups):
        enc = encode_filter(filt, m, mpad=mp)
        if enc is None:
            out[i] = sharded_filtered_topk(q, xs, ss, filt, int(k),
                                           metric=metric, m=m)
            continue
        kind, params = enc
        kpad = next_pow2(max(int(k), 8))
        classes.setdefault((kind, kpad), []).append((i, q, params, int(k)))
    for (kind, kpad), members in classes.items():
        if len(members) == 1:
            i, q, _, k = members[0]
            out[i] = sharded_filtered_topk(q, xs, ss, groups[i][1], k,
                                           metric=metric, m=m)
            continue
        qs = [as_tensor(q, dev, torch.float32) for _, q, _, _ in members]
        bq = max(q.shape[0] for q in qs)
        qp = torch.zeros((len(qs), bq, xs.shape[2]), dtype=torch.float32,
                         device=dev)
        for gi, q in enumerate(qs):
            qp[gi, :q.shape[0]] = q
        params = as_tensor(np.stack([p for _, _, p, _ in members]), dev)
        dd, ids = filtered_topk_grouped_call(qp, xs, ss, params, kind, kpad,
                                             metric=metric)
        for gi, (i, _, _, k) in enumerate(members):
            b = qs[gi].shape[0]
            out[i] = (ids[gi, :, :b, :k], dd[gi, :, :b, :k])
    return out


def sharded_quant_filtered_topk(q, codes, ss, xsq, scales,
                                filt: Optional[Filter], k: int,
                                metric: str = "l2", m: Optional[int] = None):
    """Shard-parallel asymmetric-distance filtered top-k over int8 codes
    (kernel B3).  ``codes [g, n, d]`` int8, ``ss [g, n, m]``, ``xsq [g,
    n]``, ``scales [g, d]``: each shard row's scales are folded into the
    query (``(q * scale) . code == q . dequantize(code)``), so the block
    is only read at int8.  For L2 the kernel's partial ``xsq − 2·ip`` gets
    ``‖q‖²`` added here, which makes the distances those to the
    dequantized vectors.  Returns ``(ids [g, bq, k], dists [g, bq, k])``
    — an over-fetched candidate list for the exact rerank."""
    dev = codes.device
    q = as_tensor(q, dev, torch.float32)
    m = ss.shape[2] if m is None else int(m)
    kind, params, ss = _encode_stack(filt, ss, m)
    qn = torch.sum(q * q, dim=1)
    qs = q[None, :, :] * scales[:, None, :]          # scale-folded queries
    kpad = next_pow2(max(int(k), 8))
    dd, ids = quant_topk_call(qs, codes, ss, xsq, params, kind, kpad,
                              metric=metric)
    if metric == "l2":
        dd = torch.where(torch.isfinite(dd), dd + qn[None, :, None], dd)
    return ids[:, :, :k], dd[:, :, :k]


# The library each bucket block mode scans with.
_SCAN_LIBRARY = {"fp32": "filtered_topk", "int8": "quant_topk"}


def kernels_loaded(mode: str) -> bool:
    """Whether the scan kernel of a bucket block mode (``"fp32"`` or
    ``"int8"``) is built and loaded in this process (``BucketStats``'
    ``cache_hit``).  A CUDA launch costs the same on every block shape,
    so loading the library is the only first-use cost."""
    from ._build import loaded
    return loaded(_SCAN_LIBRARY[mode])


def warm_sharded_shapes(mode: str, device, graph: bool = False) -> int:
    """Build and load the kernels a pack of this block mode reads with —
    its scan kernel, plus B4 when ``graph`` — off the query path.  Does
    nothing for a CPU pack (the twins need no build).  Returns the
    libraries loaded by this call."""
    if torch.device(device).type != "cuda":
        return 0
    from ._build import load, loaded
    names = [_SCAN_LIBRARY[mode]] + (["graph_step"] if graph else [])
    fresh = [name for name in names if not loaded(name)]
    for name in fresh:
        load(name)
    return len(fresh)
