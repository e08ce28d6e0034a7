"""Streaming segments: mutable delta buffer + immutable sealed segments.

LSM-style write path for the temporal workload.  Fresh points land in an
append-only host ``DeltaBuffer`` answered by the fused filtered top-k
kernel (exact, and fast while the buffer is small).  When the buffer hits
the seal policy it freezes into a ``SealedSegment``: a time-range
partitioned ``CubeGraphIndex`` answered by the stitched-graph beam search.
Both speak *global* point ids so results from any mix of segments merge
directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import CubeGraphConfig, CubeGraphIndex, Filter
from ..device import resolve_device
from ..kernels import filtered_topk
from ..obs.metrics import NULL_REGISTRY, count_h2d

__all__ = ["DeltaBuffer", "DeltaSnapshot", "PointStore", "SealedSegment",
           "SegmentGraph", "SegmentQueryStats", "grow_rows",
           "scan_filtered_topk"]


# Per-segment seed budget for the stitched traversal (see _live_graph):
# dense all-layer cube entries below this, an even-stride subsample above.
_MAX_SEED_ENTRIES = 256


@dataclasses.dataclass(frozen=True)
class SegmentGraph:
    """Live-row adjacency + entry points of a sealed segment's CubeGraph
    index (the union of every layer's edges), re-indexed to the live-row
    subset that :meth:`SealedSegment.live_snapshot` returns.

    ``nbrs`` is ``[n_live, deg] int32`` (-1 padded; neighbours pointing at
    deleted rows are dropped — a packed graph block only carries live
    rows).  ``entries`` is ``[e] int32`` live-local entry ids — the
    per-cube entry points of the index's layers (capped at
    ``_MAX_SEED_ENTRIES``), the seeds the stitched traversal starts this
    segment's component from.
    """

    nbrs: np.ndarray
    entries: np.ndarray


def grow_rows(need: int, *pairs):
    """Amortized-doubling row growth for parallel arrays.

    ``pairs`` are ``(array, fill_value)``; all arrays share axis-0 length.
    Returns the grown arrays (unchanged objects if capacity suffices).
    """
    cap = len(pairs[0][0])
    if need <= cap:
        return tuple(a for a, _ in pairs)
    while cap < need:
        cap *= 2
    return tuple(
        np.concatenate([a, np.full((cap - len(a),) + a.shape[1:], fill,
                                   a.dtype)])
        for a, fill in pairs)


class PointStore:
    """Chunked append-only (vector, metadata) host ledger keyed by global id.

    Off the query hot path: it serves point lookups and is
    garbage-collectable.  Rows live in fixed-size chunks; :meth:`gc` frees
    every chunk whose ids are all dead (deleted or expired).
    """

    def __init__(self, d: int, m: int, chunk: int = 4096):
        self.d = int(d)
        self.m = int(m)
        self.chunk = max(int(chunk), 16)
        self._chunks: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.n_total = 0                 # ids handed out so far

    def append(self, x: np.ndarray, s: np.ndarray) -> np.ndarray:
        """Append a batch of rows; returns their (sequential) global ids."""
        x = np.atleast_2d(np.asarray(x, np.float32))
        s = np.atleast_2d(np.asarray(s, np.float64))
        n_add = x.shape[0]
        gids = np.arange(self.n_total, self.n_total + n_add, dtype=np.int64)
        lo = 0
        while lo < n_add:
            gid = int(gids[lo])
            ci, off = divmod(gid, self.chunk)
            if ci not in self._chunks:
                self._chunks[ci] = (np.zeros((self.chunk, self.d), np.float32),
                                    np.zeros((self.chunk, self.m), np.float64))
            take = min(self.chunk - off, n_add - lo)
            cx, cs = self._chunks[ci]
            cx[off:off + take] = x[lo:lo + take]
            cs[off:off + take] = s[lo:lo + take]
            lo += take
        self.n_total += n_add
        return gids

    def get(self, gids: Sequence[int]
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rows by global id -> ``(x, s, present)``; ``present`` is False
        (and the row zero) for ids whose chunk has been freed."""
        g = np.asarray(gids, np.int64)
        x = np.zeros((len(g), self.d), np.float32)
        s = np.zeros((len(g), self.m), np.float64)
        present = np.zeros(len(g), bool)
        ci_of = g // self.chunk
        for ci in np.unique(ci_of):
            if int(ci) not in self._chunks:
                continue
            sel = np.nonzero(ci_of == ci)[0]
            cx, cs = self._chunks[int(ci)]
            off = g[sel] - ci * self.chunk
            x[sel] = cx[off]
            s[sel] = cs[off]
            present[sel] = True
        return x, s, present

    def dead_chunks(self, alive: np.ndarray) -> np.ndarray:
        """Resident chunk indices with no live id left (GC candidates)."""
        out = []
        for ci in sorted(self._chunks):
            lo = ci * self.chunk
            hi = min(lo + self.chunk, self.n_total)
            if hi <= lo or not alive[lo:hi].any():
                out.append(ci)
        return np.asarray(out, np.int64)

    def free_chunks(self, chunk_ids: Sequence[int]) -> int:
        """Release the given resident chunks; returns #rows freed."""
        freed = 0
        for ci in np.asarray(chunk_ids, np.int64):
            ci = int(ci)
            if ci not in self._chunks:
                continue
            lo = ci * self.chunk
            hi = min(lo + self.chunk, self.n_total)
            freed += max(hi - lo, 0)
            del self._chunks[ci]
        return freed

    def gc(self, alive: np.ndarray) -> int:
        """Free every chunk with no live id left; returns #rows freed."""
        return self.free_chunks(self.dead_chunks(alive))

    @property
    def resident_points(self) -> int:
        """Rows currently backed by an allocated chunk."""
        out = 0
        for ci in self._chunks:
            out += min(self.chunk, self.n_total - ci * self.chunk)
        return out

    @property
    def nbytes(self) -> int:
        """Host bytes held by resident chunks."""
        return sum(cx.nbytes + cs.nbytes for cx, cs in self._chunks.values())


@dataclasses.dataclass
class SegmentQueryStats:
    """Per-segment accounting for one fan-out query (returned to callers)."""

    segment_id: int
    kind: str                   # "delta" | "sealed"
    n_live: int
    t_min: float
    t_max: float
    pruned: bool = False        # skipped by temporal range pruning
    search_ms: float = 0.0


def scan_filtered_topk(queries: np.ndarray, xl: np.ndarray, sl: np.ndarray,
                       gl: np.ndarray, filt: Optional[Filter], k: int,
                       metric: str = "l2", device=None,
                       registry=NULL_REGISTRY
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact filtered top-k (kernel B1 on ``device``) over copied live rows
    -> padded host global-id blocks ``(gids [b, k], dists [b, k])`` — the
    shared scan behind both :class:`DeltaBuffer` and :class:`DeltaSnapshot`.
    ``registry`` counts the copies to the device: the queries, rows and
    metadata under ``h2d_bytes_total{site="delta"}``, the filter's
    parameters under ``other``.
    """
    b = np.atleast_2d(queries).shape[0]
    if len(gl) == 0:
        return (np.full((b, k), -1, np.int64),
                np.full((b, k), np.inf, np.float32))
    q, xl, sl = (np.asarray(a, np.float32)
                 for a in (np.atleast_2d(queries), xl, sl))
    count_h2d(registry, "delta", q.nbytes + xl.nbytes + sl.nbytes)
    ids, dd = filtered_topk(q, xl, sl, filt, min(k, len(gl)), metric=metric,
                            device=device, registry=registry)
    ids = ids.cpu().numpy()
    dd = dd.cpu().numpy().astype(np.float32)
    out_i = np.full((b, k), -1, np.int64)
    out_d = np.full((b, k), np.inf, np.float32)
    out_i[:, : ids.shape[1]] = np.where(ids >= 0, gl[np.maximum(ids, 0)], -1)
    out_d[:, : ids.shape[1]] = np.where(ids >= 0, dd, np.inf)
    return out_i, out_d


@dataclasses.dataclass
class DeltaSnapshot:
    """Frozen copy of a delta buffer's live rows.

    Taken under the manager lock (:meth:`DeltaBuffer.freeze`) and scanned
    lock-free afterwards.  Time bounds cover the *live* rows only.
    """

    x: np.ndarray                # [n_live, d] copied live vectors
    s: np.ndarray                # [n_live, m] copied live metadata
    gids: np.ndarray             # [n_live] global ids
    t_min: float
    t_max: float
    device: Optional[torch.device] = None   # where the scan runs

    @property
    def n_live(self) -> int:
        """Live rows captured by this snapshot."""
        return len(self.gids)

    def query(self, queries: np.ndarray, filt: Optional[Filter], k: int,
              metric: str = "l2", registry=NULL_REGISTRY
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact filtered top-k over the frozen rows (global ids); the
        copies to the device count in ``registry``."""
        return scan_filtered_topk(queries, self.x, self.s, self.gids, filt,
                                  k, metric=metric, device=self.device,
                                  registry=registry)

    def stats(self, segment_id: int = -1) -> SegmentQueryStats:
        """Fresh per-query accounting row for this snapshot."""
        return SegmentQueryStats(segment_id=segment_id, kind="delta",
                                 n_live=self.n_live, t_min=self.t_min,
                                 t_max=self.t_max)


class DeltaBuffer:
    """Append-only host write buffer with lazy deletion and exact filtered
    top-k.

    Arrays grow amortized-doubling; deletes flip a validity mask.  Queries
    scan only live rows through ``filtered_topk`` on ``device``, so delta
    answers are exact.  Concurrent readers must go through :meth:`freeze`
    (under the owner's lock).
    """

    def __init__(self, d: int, m: int, time_dim: int, capacity: int = 1024,
                 device=None):
        self.d = int(d)
        self.m = int(m)
        self.time_dim = int(time_dim)
        self.device = resolve_device(device)
        cap = max(int(capacity), 16)
        self.x = np.zeros((cap, d), np.float32)
        self.s = np.zeros((cap, m), np.float64)
        self.gids = np.full(cap, -1, np.int64)
        self.valid = np.zeros(cap, bool)
        self.size = 0
        self.t_min = np.inf
        self.t_max = -np.inf

    def __len__(self) -> int:
        return self.size

    @property
    def n_live(self) -> int:
        """Rows appended and not yet deleted/expired."""
        return int(self.valid[: self.size].sum())

    def append(self, x: np.ndarray, s: np.ndarray, gids: np.ndarray) -> None:
        """Append rows (vectors, metadata, their global ids) to the tail."""
        x = np.asarray(x, np.float32)
        s = np.asarray(s, np.float64)
        n_add = x.shape[0]
        self.x, self.s, self.gids, self.valid = grow_rows(
            self.size + n_add, (self.x, 0.0), (self.s, 0.0),
            (self.gids, -1), (self.valid, False))
        lo = self.size
        self.x[lo:lo + n_add] = x
        self.s[lo:lo + n_add] = s
        self.gids[lo:lo + n_add] = np.asarray(gids, np.int64)
        self.valid[lo:lo + n_add] = True
        self.size += n_add
        t = s[:, self.time_dim]
        self.t_min = min(self.t_min, float(t.min()))
        self.t_max = max(self.t_max, float(t.max()))

    def delete(self, gids: Sequence[int]) -> int:
        """Flip validity for any of ``gids`` present here; returns #hits."""
        if self.size == 0:
            return 0
        hit = np.isin(self.gids[: self.size], np.asarray(gids, np.int64))
        hit &= self.valid[: self.size]
        self.valid[: self.size][hit] = False
        return int(hit.sum())

    def expire_before(self, cutoff: float) -> np.ndarray:
        """Invalidate live rows with timestamp < cutoff; returns their
        global ids (so the caller can retire them in its liveness ledger)."""
        if self.size == 0:
            return np.empty(0, np.int64)
        old = self.valid[: self.size] & (self.s[: self.size, self.time_dim]
                                         < cutoff)
        self.valid[: self.size][old] = False
        return self.gids[: self.size][old].copy()

    def live_points(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(x, s, gids) of live rows — copied, safe to hand to a builder."""
        keep = np.nonzero(self.valid[: self.size])[0]
        return (self.x[keep].copy(), self.s[keep].copy(),
                self.gids[keep].copy())

    def freeze(self) -> DeltaSnapshot:
        """Copy the live rows into an immutable :class:`DeltaSnapshot`
        (call under the owning manager's lock)."""
        xl, sl, gl = self.live_points()
        t = sl[:, self.time_dim]
        return DeltaSnapshot(xl, sl, gl,
                             float(t.min()) if len(gl) else np.inf,
                             float(t.max()) if len(gl) else -np.inf,
                             device=self.device)

    def reset(self) -> None:
        """Empty the buffer (after its live points were sealed away)."""
        self.valid[: self.size] = False
        self.size = 0
        self.t_min = np.inf
        self.t_max = -np.inf

    def query(self, queries: np.ndarray, filt: Optional[Filter], k: int,
              metric: str = "l2") -> Tuple[np.ndarray, np.ndarray]:
        """Exact filtered top-k over live rows -> (global ids, dists)."""
        xl, sl, gl = self.live_points()
        return scan_filtered_topk(queries, xl, sl, gl, filt, k,
                                  metric=metric, device=self.device)

    def stats(self, segment_id: int = -1) -> SegmentQueryStats:
        """Fresh per-query accounting row for this buffer."""
        return SegmentQueryStats(segment_id=segment_id, kind="delta",
                                 n_live=self.n_live, t_min=self.t_min,
                                 t_max=self.t_max)


class SealedSegment:
    """Immutable time-range partition backed by a ``CubeGraphIndex``.

    The index speaks segment-local ids; ``gids`` maps them back to global
    ids.  Deletion is the index's lazy validity mask; the segment itself is
    never restructured in place — compaction replaces it wholesale.
    """

    def __init__(self, seg_id: int, index: CubeGraphIndex, gids: np.ndarray,
                 time_dim: int, quant=None):
        self.seg_id = int(seg_id)
        self.index = index
        self.gids = np.asarray(gids, np.int64)
        self.time_dim = int(time_dim)
        # int8 codec payload (repro_torch.quant.SegmentQuant, rows parallel
        # to index.x) — fit exactly once, at seal or compaction-publish,
        # and round-tripped through segment artifacts
        self.quant = quant
        # durable-artifact bookkeeping: persistence root -> artifact dir
        # name, filled in by streaming.persistence when this segment is
        # written to (or restored from) a snapshot directory
        self.artifacts: Dict[str, str] = {}
        t = self.index.s_np[:, time_dim]
        self.t_min = float(t.min()) if len(t) else np.inf
        self.t_max = float(t.max()) if len(t) else -np.inf
        # sorted view for O(log n) global -> local id translation
        self._order = np.argsort(self.gids)
        self._sorted_gids = self.gids[self._order]

    @classmethod
    def from_points(cls, seg_id: int, x: np.ndarray, s: np.ndarray,
                    gids: np.ndarray, time_dim: int,
                    cfg: CubeGraphConfig, device=None,
                    quantize: Optional[str] = None) -> "SealedSegment":
        """Build the segment's CubeGraphIndex over the given points; with
        ``quantize`` set, also fit the per-dimension scales and encode the
        int8 codec payload (a seal or compaction-publish — the only times a
        segment's content is written, hence the only times scales are
        fit)."""
        index = CubeGraphIndex.build(np.asarray(x, np.float32),
                                     np.asarray(s, np.float64), cfg,
                                     device=device)
        quant = None
        if quantize is not None:
            from ..quant import encode_segment
            quant = encode_segment(np.asarray(x, np.float32), quantize)
        return cls(seg_id, index, gids, time_dim, quant=quant)

    @property
    def n(self) -> int:
        """Total rows in the segment (live + lazily deleted)."""
        return self.index.n

    @property
    def n_live(self) -> int:
        """Rows not yet deleted."""
        return int(self.index.valid.sum())

    def deleted_fraction(self) -> float:
        """Fraction of this segment's rows lazily deleted so far."""
        return self.index.deleted_fraction()

    def overlaps(self, t_lo: float, t_hi: float) -> bool:
        """Whether this segment's time span intersects ``[t_lo, t_hi]``."""
        return self.t_max >= t_lo and self.t_min <= t_hi

    def live_points(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(x, s, gids) of live rows as fresh host copies — the inputs of a
        merge or GC rebuild.  All three derive from one read of the
        validity mask, so a racing delete cannot misalign them."""
        return self.live_snapshot()[:3]

    def locate(self, gids: Sequence[int]) -> np.ndarray:
        """Global ids -> local ids (-1 where not in this segment)."""
        g = np.asarray(gids, np.int64)
        pos = np.searchsorted(self._sorted_gids, g)
        pos_c = np.clip(pos, 0, len(self._sorted_gids) - 1)
        ok = (len(self._sorted_gids) > 0) & (self._sorted_gids[pos_c] == g)
        return np.where(ok, self._order[pos_c], -1)

    def delete(self, gids: Sequence[int]) -> int:
        """Lazy-delete by global id; returns the number present here."""
        local = self.locate(gids)
        local = local[local >= 0]
        if len(local):
            self.index.delete(local)
        return len(local)

    def live_snapshot(self, with_graph: bool = False):
        """``(x, s, gids, quant)`` of the live rows, all derived from ONE
        read of the validity mask — the input a lock-free reader (the cold
        shard-pack build) must use, so a racing delete can never yield
        vectors and codec rows of different lengths.  ``quant`` is the
        row-subset :class:`~repro_torch.quant.codec.SegmentQuant` payload,
        or ``None`` when the segment carries no codec.

        With ``with_graph=True`` a fifth element is appended: the
        :class:`SegmentGraph` re-indexed to the same live-row subset, which
        the graph read path stages into the bucketed pack.  The default
        4-tuple shape is pinned by callers and tests — never change it."""
        keep = np.nonzero(self.index.valid)[0]
        quant = self.quant.take(keep) if self.quant is not None else None
        x = self.index.x[torch.as_tensor(keep, device=self.index.device)]
        out = (x.cpu().numpy(), self.index.s_np[keep],
               self.gids[keep].copy(), quant)
        if with_graph:
            out = out + (self._live_graph(keep),)
        return out

    def _live_graph(self, keep: np.ndarray) -> SegmentGraph:
        # Flatten the hierarchical index into one navigable adjacency: the
        # union, per point, of every layer's edges (intra + cross) — coarse
        # layers contribute the long-range links greedy routing needs,
        # fine layers the local links that make the last hops exact.
        # Edges are re-indexed to live-local ids; edges into deleted rows
        # are dropped (compaction restores their connectivity).
        inv = np.full(self.index.n, -1, np.int32)
        inv[keep] = np.arange(len(keep), dtype=np.int32)
        keep_t = torch.as_tensor(keep, device=self.index.device)
        nb = np.concatenate([lg.all_nbrs[keep_t].cpu().numpy()
                             for lg in self.index.layers], axis=1)
        nb = np.where(nb >= 0, inv[np.maximum(nb, 0)], -1).astype(np.int32)
        # per-row dedupe, valid edges first: sort descending so duplicates
        # are adjacent and -1 padding sinks to the tail
        nb = -np.sort(-nb, axis=1)
        dup = np.zeros_like(nb, dtype=bool)
        dup[:, 1:] = nb[:, 1:] == nb[:, :-1]
        nb = np.where(dup, -1, nb)
        nbrs = -np.sort(-nb, axis=1)
        # Entry points: the per-cube entries of EVERY layer.  Each sealed
        # segment is its own connected component inside a shared bucket
        # and the stitched beam is shared across components, so dense
        # per-cube seeds start every component's search next to the query.
        ents = []
        for lg in self.index.layers:
            e = np.asarray(lg.cubes.entry).reshape(-1)
            e = e[e >= 0]
            if len(e):
                ents.append(inv[e])
        entries = (np.unique(np.concatenate(ents)) if ents
                   else np.empty(0, np.int32))
        entries = entries[entries >= 0].astype(np.int32)
        if len(entries) > _MAX_SEED_ENTRIES:
            # bounded seed-init cost: an even-stride subsample keeps seeds
            # spread across a big (compacted) segment
            idx = np.linspace(0, len(entries) - 1, _MAX_SEED_ENTRIES)
            entries = entries[idx.astype(np.int64)]
        if len(entries) == 0 and len(keep):
            # all designated entries were deleted: fall back to the first
            # few live rows so the segment stays reachable until compaction
            entries = np.arange(min(len(keep), 4), dtype=np.int32)
        return SegmentGraph(nbrs=nbrs, entries=entries)

    def compacted(self, quantize: Optional[str] = None) -> "SealedSegment":
        """GC lazy deletions: rebuild over live points (same seg id/gids).
        A quantized segment re-fits its scales over the surviving rows (a
        content rewrite, exactly when the codec contract allows
        re-encoding); ``quantize`` (the owner's codec) also lets a segment
        without a codec gain one here.  Index, gid map and codec all derive
        from ONE :meth:`live_snapshot`, so a racing delete cannot misalign
        them."""
        x, s, gids, _ = self.live_snapshot()
        kind = quantize if quantize is not None else \
            (self.quant.kind if self.quant is not None else None)
        quant = None
        if kind is not None:
            from ..quant import encode_segment
            quant = encode_segment(x, kind)
        index = CubeGraphIndex.build(x, s, self.index.cfg,
                                     device=self.index.device)
        return SealedSegment(self.seg_id, index, gids, self.time_dim,
                             quant=quant)

    def query(self, queries: np.ndarray, filt: Optional[Filter], k: int,
              ef: int = 64, **kw) -> Tuple[np.ndarray, np.ndarray]:
        """Graph search -> (global ids [b, k], dists [b, k]).  ``filt=None``
        becomes a pass-all box over this segment's grid bounds (the core
        index requires a predicate for planning)."""
        if filt is None:
            from ..core import BoxFilter
            g = self.index.grid
            filt = BoxFilter(lo=np.asarray(g.lo, np.float32),
                             hi=np.asarray(g.hi, np.float32))
        kw.setdefault("tie_gids", self.gids)   # stable (dist, gid) ordering
        ids, dd = self.index.query(np.atleast_2d(queries), filt, k=k, ef=ef,
                                   **kw)
        gids = np.where(ids >= 0, self.gids[np.maximum(ids, 0)], -1)
        return gids, np.asarray(dd, np.float32)

    def stats(self) -> SegmentQueryStats:
        """Fresh per-query accounting row for this segment."""
        return SegmentQueryStats(segment_id=self.seg_id, kind="sealed",
                                 n_live=self.n_live, t_min=self.t_min,
                                 t_max=self.t_max)
