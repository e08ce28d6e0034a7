"""Beam-step kernel (B4) + stitched per-bucket graph traversal.

The graph read path for sealed segments: a bucketed shard pack can carry,
next to its fp32 or int8 scan blocks, a ``[rows, cap, degp]`` adjacency
block of *flattened bucket positions* (``row * cap + col``) staged from
each sealed segment's CubeGraph layers.  :func:`bucket_graph_topk`
traverses it with a batched best-first beam search whose hot step is
:func:`beam_step_scores`:

  1. the host loop (one device sync per hop, like ``core/search.py``)
     keeps fixed-shape beam / result / visited tensors, picks the top-W
     frontier's neighbour positions and masks, before scoring, every lane
     it would drop (a free slot, a visited position, a repeat in the row);
  2. the kernel (``csrc/graph_step.cu``) compacts the lanes left, reads
     each of their rows straight from the bucket block — dequantizing int8
     codes on load — and emits its raw distance (for routing) and
     predicate mask (for collection); a masked lane costs one store;
  3. beam and result merges are stable ``(distance, position)`` top-k over
     fixed shapes, so ties resolve to the lower position exactly as the
     reference's ``top_k`` does.

Stitching rule: the beam is seeded with the union of entry points of every
temporally active segment in the bucket (``bucket_graph_seeds``), so a
bucket holding many segments is traversed in ONE pass.  Quantized buckets
traverse the same way; the caller reranks their results exactly at fp32.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..obs.metrics import NULL_REGISTRY, count_h2d
from . import ref
from ._hopper import MAX_SMEM
from .filtered_topk import FILTER_KINDS

__all__ = ["beam_step_scores", "beam_step_plain", "bucket_graph_topk",
           "launch_config", "launch_count", "launch_counts_by_device",
           "reset_launch_count"]

_KIND_CODE = {k: i for i, k in enumerate(FILTER_KINDS)}
_MAX_M = 16
INF = float("inf")
_I32_MAX = int(np.iinfo(np.int32).max)

# csrc/graph_step.cu's constants: threads per block, lanes compacted at
# once, lanes per candidate, and the largest [rows, d] scale block staged
# in shared memory (phase 5b's largest int8 bucket, [16, 768], takes 48 KB;
# three blocks of 256 threads still share an SM)
THREADS = 256
CHUNK = 4 * THREADS
GROUP = 8
STAGE_MAX = 64 * 1024

_LAUNCHES = [0]
# launches per CUDA device index (a shard mesh launches on each card)
_BY_DEVICE: dict = {}
_LAUNCH_LOCK = threading.Lock()


def launch_count() -> int:
    """CUDA launches of this kernel in this process (the twin never
    counts)."""
    return _LAUNCHES[0]


def launch_counts_by_device() -> dict:
    """:func:`launch_count`'s launches by CUDA device index."""
    with _LAUNCH_LOCK:
        return dict(_BY_DEVICE)


def reset_launch_count() -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES[0] = 0
        _BY_DEVICE.clear()


def _gather(pos, x, s, scales):
    """Rows of the bucket block at flattened positions (the twin's
    gather): ``(cand_x [b, c, d] fp32, cand_meta [b, c, m])``."""
    rows, cap, d = x.shape
    safe = pos.long().clamp_min(0)
    cx = x.reshape(rows * cap, d)[safe]
    if x.dtype == torch.int8:
        cx = cx.float() * scales[safe // cap]
    cm = s.reshape(rows * cap, s.shape[-1])[safe]
    return cx, cm


def beam_step_plain(q, pos, x, s, params, kind: str, metric: str = "l2",
                    scales=None):
    """Plain PyTorch twin of :func:`beam_step_scores`: gathers the
    ``[b, c, d]`` candidate tile in torch, then the same expression."""
    cx, cm = _gather(pos, x, s, scales)
    d, ok = ref.beam_step_ref(q, cx, cm, kind, params, metric=metric)
    miss = pos < 0
    return (d.masked_fill(miss, INF),
            ok.masked_fill(miss, 0))


def _check(q, pos, x, s, params, kind, metric, scales):
    if kind not in _KIND_CODE:
        raise ValueError(f"unknown filter kind {kind!r}")
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if x.dim() != 3 or s.dim() != 3 or q.dim() != 2 or pos.dim() != 2:
        raise ValueError("beam_step_scores takes q [b, d], pos [b, c], "
                         "x [rows, cap, d], s [rows, cap, m]")
    rows, cap, d = x.shape
    if s.shape[:2] != (rows, cap) or q.shape[1] != d \
            or pos.shape[0] != q.shape[0]:
        raise ValueError(f"shapes q {tuple(q.shape)}, pos {tuple(pos.shape)}"
                         f", x {tuple(x.shape)}, s {tuple(s.shape)} disagree")
    if params.dim() != 2 or params.shape[0] != 4 \
            or params.shape[1] < max(s.shape[2], 2):
        raise ValueError(f"params shape {tuple(params.shape)} must be "
                         "[4, >=max(m, 2)]")
    if x.dtype == torch.int8:
        if scales is None or tuple(scales.shape) != (rows, d) \
                or scales.dtype != torch.float32:
            raise ValueError("an int8 block needs scales [rows, d] float32")
    elif x.dtype != torch.float32:
        raise TypeError(f"x must be float32 or int8, got {x.dtype}")
    tensors = (q, pos, x, s, params) + ((scales,) if scales is not None
                                        else ())
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def smem_bytes(d: int, quantized: bool, rows_staged: int) -> int:
    """csrc/graph_step.cu's shared-memory layout (``layout``): staged
    scales [rows_staged, dp] and the query row [dp] (dp = d rounded up to
    whole pieces), its norm (16 bytes), the live list of a chunk (two ints
    a lane), the position sort's 256 bins with 48 ints of warp sums,
    starts and total, and two metadata rows of 16 floats per group."""
    dp = -(-d // (16 if quantized else 4)) * (16 if quantized else 4)
    return ((rows_staged + 1) * dp * 4 + 16 + CHUNK * 8 + (THREADS + 48) * 4
            + (THREADS // GROUP) * 2 * _MAX_M * 4)


def launch_config(b: int, d: int, rows: int, quantized: bool, x_ptr: int,
                  sc_ptr: int) -> dict:
    """The launch configuration of ``csrc/graph_step.cu``: one block per
    query (``blocks``; a block compacts its c lanes ``CHUNK`` at a time,
    so c does not enter), whether an int8 block's scales are staged in
    shared memory (``stage``: up to ``STAGE_MAX`` bytes; larger ones are
    read from global memory), the 16-byte row loads (``vec``: whole pieces
    and 16-byte aligned rows, and scales for an unstaged int8 block; else
    element loads in the same order), the dynamic shared memory and the
    threads."""
    w = 16 if quantized else 4
    dp = -(-d // w) * w
    stage = quantized and rows * dp * 4 <= STAGE_MAX
    smem = smem_bytes(d, quantized, rows if stage else 0)
    if smem > MAX_SMEM:
        raise ValueError(f"graph_step: a query row of d={d} does not fit "
                         "one block's shared memory")
    vec = int(d % w == 0 and x_ptr % 16 == 0
              and (not quantized or stage or sc_ptr % 16 == 0))
    return dict(blocks=b, stage=int(stage), vec=vec, smem=smem,
                threads=THREADS)


def beam_step_scores(q, pos, x, s, params, kind: str, metric: str = "l2",
                     scales=None):
    """Score one traversal hop with the gather fused in: ``q [b, d]``
    fp32, ``pos [b, c]`` flattened bucket positions (``-1`` = none), the
    bucket block ``x [rows, cap, d]`` (fp32, or int8 codes with
    ``scales [rows, d]``), its metadata ``s [rows, cap, m]`` and packed
    ``params [4, mp]`` -> ``(dists [b, c] fp32 raw, ok [b, c] int32)``;
    ``+inf`` / ``0`` where ``pos < 0``.

    CPU tensors run :func:`beam_step_plain`; CUDA tensors launch the
    kernel or raise."""
    _check(q, pos, x, s, params, kind, metric, scales)
    if x.device.type == "cpu":
        return beam_step_plain(q, pos, x, s, params, kind, metric, scales)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows, cap, d = x.shape
    b, c = pos.shape
    m, mp = s.shape[2], params.shape[1]
    if m > _MAX_M:
        raise ValueError(f"the CUDA kernel reads at most {_MAX_M} metadata "
                         f"columns, got {m}")
    dev = x.device
    out_d = torch.empty((b, c), dtype=torch.float32, device=dev)
    out_ok = torch.empty((b, c), dtype=torch.int32, device=dev)
    if b == 0 or c == 0:
        return out_d, out_ok
    q, x, s, params = (t.contiguous() for t in (q, x, s, params))
    pos = pos.to(torch.int32).contiguous()
    quantized = x.dtype == torch.int8
    sc = scales.contiguous() if quantized else s
    cfg = launch_config(b, d, rows, quantized, x.data_ptr(), sc.data_ptr())
    from ._build import load
    lib = load("graph_step")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_graph_step(
            q.data_ptr(), pos.data_ptr(), x.data_ptr(), sc.data_ptr(),
            s.data_ptr(), params.data_ptr(), out_d.data_ptr(),
            out_ok.data_ptr(), b, c, d, cap, rows, m, mp, _KIND_CODE[kind],
            0 if metric == "l2" else 1, int(quantized), cfg["stage"],
            cfg["vec"], cfg["smem"], stream)
    if err != 0:
        raise RuntimeError(f"graph_step CUDA launch failed: cudaError {err}")
    with _LAUNCH_LOCK:
        _LAUNCHES[0] += 1
        _BY_DEVICE[dev.index] = _BY_DEVICE.get(dev.index, 0) + 1
    return out_d, out_ok


# ---------------------------------------------------------------------------
# Traversal (host loop over fixed-shape device tensors)
# ---------------------------------------------------------------------------
def _smallest(d: torch.Tensor, k: int):
    """Ascending top-k by (value, column): a stable sort, so equal values
    keep the lower column first — the tie order of the reference's
    ``top_k``."""
    sd, sel = torch.sort(d, dim=1, stable=True)
    return sd[:, :k], sel[:, :k]


def _unique_mask(ids: torch.Tensor) -> torch.Tensor:
    """[b, c] bool: first occurrence of each id in its row."""
    sorted_ids, order = torch.sort(ids, dim=1, stable=True)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    return torch.zeros_like(first).scatter_(1, order, first)


def _merge_topk(ids_a, d_a, ids_b, d_b, k: int):
    ids = torch.cat([ids_a, ids_b], dim=1)
    d = torch.cat([d_a, d_b], dim=1)
    sd, sel = _smallest(d, k)
    return torch.gather(ids, 1, sel), sd


def _traverse(q, gids, nbr_at, score, seeds, k: int, ef: int, width: int,
              max_iters: int):
    """Stitched best-first traversal over one bucket block.  ``gids
    [npos]`` is the flattened gid block, ``nbr_at(pos)`` reads the
    adjacency block (``[..., degp]``) at non-negative flattened
    positions, ``score(pos [b, c]) -> (dists, ok)`` is the hop kernel,
    ``seeds [S]`` flattened positions shared by the batch.  Returns
    ``(gids [b, k], dists [b, k], hops)`` ascending by (dist, gid)."""
    dev = q.device
    b = q.shape[0]
    npos = gids.shape[0]
    # ef-wide internal result list (classic ef-search); the caller gets
    # the top-k slice
    kc = max(k, ef)
    rows_b = torch.arange(b, device=dev)[:, None]

    # B4 is handed only the lanes the traversal keeps (the rest are -1,
    # which read no row and score +inf / 0), so the masks come first
    seed_b = seeds[None, :].expand(b, -1)
    valid0 = ((seed_b >= 0) & (gids[seed_b.clamp_min(0)] >= 0)
              & _unique_mask(seed_b))
    live0 = torch.where(valid0, seed_b, -1)
    droute0, ok0 = score(live0)
    dres0 = torch.where(ok0.bool(), droute0, INF)

    visited = torch.zeros((b, npos), dtype=torch.bool, device=dev)
    visited[:, seeds[seeds >= 0]] = True

    neg = torch.full((b, 1), -1, dtype=torch.long, device=dev)
    inf = torch.full((b, 1), INF, device=dev)
    beam_pos, beam_d = _merge_topk(
        neg.expand(b, ef), inf.expand(b, ef),
        live0, droute0, ef)
    beam_exp = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    res_pos, res_d = _merge_topk(
        neg.expand(b, kc), inf.expand(b, kc),
        torch.where(torch.isfinite(dres0), seed_b, -1), dres0, kc)

    hops = 0
    while hops < max_iters:
        frontier = torch.where(beam_exp | (beam_pos < 0), INF, beam_d)
        kth = res_d[:, kc - 1]
        if not bool((frontier.min(dim=1).values < kth).any()):
            break
        fsel, sel = _smallest(frontier, width)
        exp_ok = fsel < kth[:, None]                 # only expand improving
        exp_pos = torch.where(exp_ok, torch.gather(beam_pos, 1, sel), -1)
        beam_exp = beam_exp.scatter(1, sel, True)

        nb = nbr_at(exp_pos.clamp_min(0)).long()     # [b, w, degp]
        nb = torch.where(exp_pos[:, :, None] >= 0, nb, -1)
        cand = nb.reshape(b, -1)

        safe = cand.clamp_min(0)
        fresh = (cand >= 0) & (gids[safe] >= 0)
        fresh &= ~torch.gather(visited, 1, safe)
        fresh &= _unique_mask(cand)
        live = torch.where(fresh, cand, -1)
        droute, ok = score(live)
        dres = torch.where(ok.bool(), droute, INF)
        visited[rows_b.expand_as(cand)[fresh], cand[fresh]] = True

        ids2 = torch.cat([beam_pos, live], dim=1)
        dd2 = torch.cat([beam_d, droute], dim=1)
        ee2 = torch.cat([beam_exp, torch.zeros_like(fresh)], dim=1)
        beam_d, sel2 = _smallest(dd2, ef)
        beam_pos = torch.gather(ids2, 1, sel2)
        beam_exp = torch.gather(ee2, 1, sel2)

        res_pos, res_d = _merge_topk(
            res_pos, res_d, torch.where(torch.isfinite(dres), cand, -1),
            dres, kc)
        hops += 1

    res_pos = torch.where(torch.isfinite(res_d), res_pos, -1)
    g = torch.where(res_pos >= 0, gids[res_pos.clamp_min(0)].long(), -1)
    # deterministic (dist, gid) output order: the scan path's host_topk
    # invariant (a lexsort by two stable sorts)
    key = torch.where(g >= 0, g, _I32_MAX)
    o1 = torch.argsort(key, dim=1, stable=True)
    o2 = torch.argsort(torch.gather(res_d, 1, o1), dim=1, stable=True)
    order = torch.gather(o1, 1, o2)[:, :k]
    return torch.gather(g, 1, order), torch.gather(res_d, 1, order), hops


class _MeshBlocks:
    """A mesh bucket's per-card blocks, read at global flattened positions
    (``row * cap + col``) from the home card: the mesh says which card
    owns row ``row`` and at which local row (``ShardMesh.owner``).  A read
    splits the positions by owning card, sends each card its local
    positions (the others as ``-1`` for B4, or 0 for a gather, masked
    afterwards), runs there, and takes each lane's value from its owner
    on the home card.  The gids are read from a home-card copy made once
    per traversal (4 bytes a point), so a hop splits two reads: the
    adjacency and B4."""

    def __init__(self, bv, q, params):
        self.mesh = bv.mesh
        self.home = bv.mesh.home
        self.cap = bv.cap
        cards = list(enumerate(self.mesh.devices))
        self.q = [q.to(dev, non_blocking=True) for _, dev in cards]
        self.params = [params.to(dev, non_blocking=True) for _, dev in cards]

    def split(self, pos):
        """Owning card and local position of non-negative positions."""
        card, row = self.mesh.owner(pos // self.cap)
        return card, row * self.cap + pos % self.cap

    def _combine(self, owner, outs):
        res = outs[0].to(self.home, non_blocking=True)
        for c in range(1, len(outs)):
            mask = owner == c
            o = outs[c].to(self.home, non_blocking=True)
            res = torch.where(mask.reshape(mask.shape
                                           + (1,) * (o.dim() - mask.dim())),
                              o, res)
        return res

    def take(self, parts, pos):
        """``parts[card][local]`` at non-negative global positions."""
        owner, local = self.split(pos)
        outs = [parts[c][torch.where(owner == c, local, 0).to(
                    dev, non_blocking=True)]
                for c, dev in enumerate(self.mesh.devices)]
        return self._combine(owner, outs)

    def score(self, pos, block, s, scales, kind, metric):
        """B4 on every card over the lanes it owns (``-1`` elsewhere)."""
        owner, local = self.split(pos.clamp_min(0))
        outs = []
        for c, dev in enumerate(self.mesh.devices):
            lp = torch.where((pos >= 0) & (owner == c), local, -1)
            outs.append(beam_step_scores(
                self.q[c], lp.to(dev, non_blocking=True), block[c], s[c],
                self.params[c], kind, metric,
                scales=None if scales is None else scales[c]))
        return (self._combine(owner, [d for d, _ in outs]),
                self._combine(owner, [ok for _, ok in outs]))


def bucket_graph_topk(queries, bv, seeds, filt, k: int, *, m: int,
                      metric: str = "l2", ef: int = 64, width: int = 4,
                      max_iters: int = 128, registry=NULL_REGISTRY
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Traverse one bucket's stitched graph block.

    ``queries [b, d]``; ``bv`` a ``BucketView`` carrying ``nbrs``;
    ``seeds`` the flattened positions from ``bucket_graph_seeds``; ``m``
    the true metadata width.  Returns ``(gids [b, k] int64 with -1
    misses, dists [b, k] fp32 ascending, hops)`` — fp32 buckets emit exact
    distances, quantized buckets distances to the dequantized vectors that
    the caller reranks.  Returns ``None`` when the filter has no kernel
    encoding or the bucket has no usable graph / seeds (the caller falls
    back to the scan path).

    On a shard mesh of several entries (``bv.mesh``) the beam, its merges
    and the host loop stay on the home card; each hop's adjacency reads
    and B4 launches go to the cards owning the positions
    (:class:`_MeshBlocks`).
    B4's per-lane sum depends on ``d`` alone, so the traversal is the
    single-card one bit for bit.  ``registry`` counts the copies of the
    queries, the filter parameters and the seeds (``h2d_bytes_total``)."""
    from .ops import encode_filter
    if bv.nbrs is None or len(seeds) == 0:
        return None
    enc = encode_filter(filt, m, mpad=max(m, 2))
    if enc is None:
        return None
    kind, params = enc
    mesh = bv.mesh
    dev = mesh.home
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    seeds = np.asarray(seeds, np.int64)
    q = torch.as_tensor(queries, device=dev)
    k = int(k)
    ef = max(int(ef), k)
    pj = torch.as_tensor(params, device=dev)
    count_h2d(registry, "scan_queries", queries.nbytes)
    count_h2d(registry, "other", params.nbytes + seeds.nbytes)
    block = bv.codes if bv.quantized else bv.x
    nbrs = [nb.reshape(-1, nb.shape[-1]) for nb in bv.nbrs]
    if mesh.size == 1:
        def nbr_at(pos):
            return nbrs[0][pos]

        def score(pos):
            return beam_step_scores(q, pos, block[0], bv.s[0], pj, kind,
                                    metric, scales=None if bv.scales is None
                                    else bv.scales[0])
    else:
        mb = _MeshBlocks(bv, q, pj)

        def nbr_at(pos):
            return mb.take(nbrs, pos)

        def score(pos):
            return mb.score(pos, block, bv.s, bv.scales, kind, metric)
    g, dd, hops = _traverse(
        q, bv.block("gids").reshape(-1), nbr_at, score,
        torch.as_tensor(seeds, device=dev),
        k, ef, int(width), int(max_iters))
    return (g.cpu().numpy().astype(np.int64),
            dd.cpu().numpy().astype(np.float32), hops)
