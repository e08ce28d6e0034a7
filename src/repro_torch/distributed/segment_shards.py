"""Sharded sealed-segment search: segments x shards, bucketed by size.

Each sealed segment's live point set is partitioned round-robin into
``n_shards`` equal-capacity shards and answered by a fused filtered top-k
kernel over a stacked ``[rows, cap, ·]`` device block — B1 for fp32
blocks, B3 for int8 blocks, the shard axis being the kernel's batch axis —
followed by an exact merge of the shard-local ``(gid, dist)`` top-k lists.

Two pack layouts exist:

* :class:`BucketedShardPack` (the serving structure) groups segments into
  **capacity buckets** — power-of-two multiples of ``cap_multiple`` — so a
  jumbo post-compaction segment pads only its own bucket.  The pack is
  **incrementally maintained**: a seal appends one segment's rows into its
  bucket, a compaction publish removes the merged inputs and inserts the
  output, an expiry tombstones rows without touching device data, and
  deletes write the ``PAD_META`` sentinel into the metadata block.  Every
  device update is **copy-on-write**: the touched block is cloned, written
  and swapped in under the owner's lock, never edited in place, so an
  in-flight query holding a :class:`PackView` keeps reading the tensors it
  captured (the reference gets this from XLA's functional updates).
* :class:`ShardPack` — the monolithic layout (one block, every shard
  padded to the largest shard's capacity), rebuilt whole per epoch.  Kept
  for ``StreamConfig(incremental_pack=False)`` and as the simplest
  exactness oracle.

On one card the shard axis is a batch axis of the kernels
(:func:`make_shard_mesh` refuses more than one device).

Exactness: every shard computes the same fp32 distance the monolithic
kernel would for the same point (the kernels' per-candidate sums do not
depend on the candidate's position), each true global top-k member is
inside its own shard's top-k, and global ids are disjoint across shards —
so concatenating the per-shard (and per-bucket) lists and taking the
global top-k by ``(dist, position)`` reproduces the monolithic result bit
for bit.

Layouts (``kernels.ops.block_layout``): fp32 buckets hold ``x [rows, cap,
d]`` and ``s [rows, cap, m]``; int8 buckets hold row-major ``codes [rows,
cap, d]``, ``s``, ``xsq [rows, cap]`` and per-row ``scales [rows, d]``;
with the graph read path on, ``nbrs [rows, cap, degp]`` int32 flattened
positions (``row * cap + col``) ride along.  No lane or sublane padding.

Residency (tiered storage, ``streaming/tiering.py``): a bucket is either
**resident** (its blocks are device tensors) or **cold** (its blocks are
byte-identical page-locked host tensors).  :meth:`BucketedShardPack.
evict_bucket` demotes a block; a cold dispatch copies the block into a
transient device buffer from the pinned copy (``non_blocking``) and
launches the same kernel at the same shapes, so cold answers are the
resident ones bit for bit.  An admission is staged under the owner's lock,
uploaded on a side CUDA stream off the lock (an event marks its end) and
installed under the lock, where the pack's consuming stream waits on that
event.  The budget counts the CUDA bytes of resident blocks
(``numel * element_size``); the transient cold buffer is not counted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import Filter
from ..device import resolve_device
from ..kernels.ops import (PAD_META, block_layout, next_pow2, round_up,
                           kernels_loaded, sharded_filtered_topk,
                           sharded_filtered_topk_grouped,
                           sharded_quant_filtered_topk)
from ..obs.trace import NULL_TRACE, block_ready

__all__ = ["BucketView", "BucketedShardPack", "PackView", "PAD_META",
           "SegmentShardSource", "ShardPack", "bucket_cap_for",
           "bucket_graph_seeds", "build_bucketed_pack", "build_shard_pack",
           "host_topk", "make_shard_mesh", "pack_search",
           "pack_search_blocks", "pack_search_blocks_grouped",
           "stage_bucket"]


@dataclasses.dataclass(frozen=True)
class SegmentShardSource:
    """One segment's live points, ready to be sharded (plain numpy arrays,
    field for field the reference's, so a parity test can build both
    packages' packs from identical sources).

    ``codes`` / ``scales`` / ``xsq`` carry the segment's int8 codec payload
    (rows parallel to ``x``) when the owner runs the quantized read path;
    a quantized pack encodes on the fly when they are absent.  ``nbrs`` /
    ``entries`` carry the live-local adjacency and entry points for the
    graph read path.
    """

    seg_id: int
    x: np.ndarray                # [n, d] fp32 live vectors
    s: np.ndarray                # [n, m] metadata
    gids: np.ndarray             # [n] int64 global ids
    t_min: float
    t_max: float
    codes: Optional[np.ndarray] = None    # [n, d] int8 segment codes
    scales: Optional[np.ndarray] = None   # [d] fp32 per-dim scales
    xsq: Optional[np.ndarray] = None      # [n] fp32 dequantized sq. norms
    nbrs: Optional[np.ndarray] = None     # [n, deg] int32 local adjacency
    entries: Optional[np.ndarray] = None  # [e] int32 local entry points


def make_shard_mesh(n_devices: Optional[int] = None, device=None):
    """The shard placement of the pack: one card, so the shard axis is a
    batch axis of the kernels.  Returns ``(device,)``.  More than one
    device is out of scope of the port and raises."""
    if n_devices is not None and int(n_devices) > 1:
        raise NotImplementedError(
            "a multi-GPU shard mesh is out of scope of repro_torch: on one "
            "card the shard axis is a batch axis of the kernels")
    return (resolve_device(device),)


def _put(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


@dataclasses.dataclass
class ShardPack:
    """Stacked, padded, device-resident shards of a set of sealed segments
    (monolithic layout, rebuilt whole per segment-list generation).
    Deletions between rebuilds are applied with :meth:`mark_dead`
    (metadata sentinel overwrite + lazy re-upload) — no restacking."""

    epoch: int
    n_shards: int                    # shards per segment
    m: int                           # metadata dimension
    seg_ids: np.ndarray              # [g] owning segment id per pack row
    t_min: np.ndarray                # [g] owning segment's time span
    t_max: np.ndarray
    x: torch.Tensor                  # [g, cap, d] device stack
    gids_dev: torch.Tensor           # [g, cap] int32 (-1 padding)
    _s_host: np.ndarray              # [g, cap, m] fp32 host master copy
    _gid_sorted: np.ndarray          # sorted live gids (for mark_dead)
    _gid_flat_pos: np.ndarray        # flat (row*cap + col) per sorted gid
    _s_dev: Optional[torch.Tensor] = None

    @property
    def n_rows(self) -> int:
        """Pack rows = segments x shards-per-segment."""
        return int(self.x.shape[0])

    @property
    def cap(self) -> int:
        """Padded per-shard point capacity."""
        return int(self.x.shape[1])

    @property
    def nbytes(self) -> int:
        """Device bytes held by the pack (vectors + metadata + gids)."""
        return int(self.x.numel() * 4 + self._s_host.size * 4
                   + self.gids_dev.numel() * 4)

    @property
    def s_dev(self) -> torch.Tensor:
        """Device metadata stack, re-uploaded lazily after `mark_dead`."""
        if self._s_dev is None:
            self._s_dev = _put(self._s_host, self.x.device)
        return self._s_dev

    def mark_dead(self, gids: Sequence[int]) -> int:
        """Mask points by global id: their metadata rows become
        ``PAD_META``.  Returns the number of pack rows touched; the device
        copy refreshes on the next query."""
        g = np.asarray(gids, np.int64)
        if len(g) == 0 or len(self._gid_sorted) == 0:
            return 0
        pos = np.searchsorted(self._gid_sorted, g)
        pos_c = np.clip(pos, 0, len(self._gid_sorted) - 1)
        ok = self._gid_sorted[pos_c] == g
        flat = self._gid_flat_pos[pos_c[ok]]
        if len(flat) == 0:
            return 0
        rows, cols = np.divmod(flat, self.cap)
        self._s_host = self._s_host.copy()
        self._s_host[rows, cols, :] = PAD_META
        self._s_dev = None
        return len(flat)

    def sync_alive(self, alive: np.ndarray) -> int:
        """Mask every packed point whose gid is dead in ``alive``."""
        dead = self._gid_sorted[~alive[self._gid_sorted]]
        return self.mark_dead(dead)

    def active_rows(self, t_lo: float, t_hi: float) -> np.ndarray:
        """[g] bool — pack rows whose segment span overlaps [t_lo, t_hi]."""
        return (self.t_max >= t_lo) & (self.t_min <= t_hi)


def build_shard_pack(sources: Sequence[SegmentShardSource], n_shards: int,
                     epoch: int = 0, cap_multiple: int = 256,
                     device=None) -> ShardPack:
    """Partition each segment round-robin into ``n_shards`` shards and
    stack all of them into one padded device pack on ``device`` (default:
    the card)."""
    n_shards = max(int(n_shards), 1)
    if not sources:
        raise ValueError("build_shard_pack needs at least one segment")
    dev = resolve_device(device)
    m = sources[0].s.shape[1]
    d = sources[0].x.shape[1]
    per_row: List[Tuple[int, np.ndarray, SegmentShardSource]] = []
    for src in sources:
        order = np.arange(len(src.gids))
        for sh in range(n_shards):
            per_row.append((src.seg_id, order[sh::n_shards], src))
    g = len(per_row)
    cap = round_up(max(len(idx) for _, idx, _ in per_row), cap_multiple)
    x = np.zeros((g, cap, d), np.float32)
    s = np.full((g, cap, m), PAD_META, np.float32)
    gid = np.full((g, cap), -1, np.int32)
    seg_ids = np.zeros(g, np.int64)
    t_min = np.zeros(g, np.float64)
    t_max = np.zeros(g, np.float64)
    for row, (sid, idx, src) in enumerate(per_row):
        nn = len(idx)
        x[row, :nn] = src.x[idx]
        s[row, :nn] = src.s[idx]
        gid[row, :nn] = src.gids[idx]
        seg_ids[row] = sid
        t_min[row], t_max[row] = src.t_min, src.t_max
    flat_gid = gid.reshape(-1).astype(np.int64)
    live = np.nonzero(flat_gid >= 0)[0]
    order = np.argsort(flat_gid[live])
    return ShardPack(epoch=epoch, n_shards=n_shards, m=m, seg_ids=seg_ids,
                     t_min=t_min, t_max=t_max, x=_put(x, dev),
                     gids_dev=_put(gid, dev), _s_host=s,
                     _gid_sorted=flat_gid[live][order],
                     _gid_flat_pos=live[order])


# ---------------------------------------------------------------------------
# Size-bucketed, incrementally maintained pack
# ---------------------------------------------------------------------------
def bucket_cap_for(n_points: int, n_shards: int,
                   cap_multiple: int = 256) -> int:
    """Padded per-shard row capacity class for a segment of ``n_points``
    live rows: the smallest power-of-two multiple of ``cap_multiple`` that
    fits the segment's largest round-robin shard (padding waste stays
    below 2x; the number of distinct block shapes is O(log segment))."""
    n_shards = max(int(n_shards), 1)
    shard_rows = -(-max(int(n_points), 1) // n_shards)
    return cap_multiple * next_pow2(-(-shard_rows // cap_multiple))


@dataclasses.dataclass
class _SegEntry:
    """Where one segment's points live inside the pack (host bookkeeping
    for deltas and deletions)."""

    seg_id: int
    cap: int                     # owning bucket key
    slot: int                    # slot index inside the bucket
    gid_sorted: np.ndarray       # sorted gids of the segment's packed rows
    rows_sorted: np.ndarray      # bucket row per sorted gid
    cols_sorted: np.ndarray      # bucket column per sorted gid
    entry_pos: Optional[np.ndarray] = None  # flattened graph entry positions


@dataclasses.dataclass
class _Bucket:
    """One capacity class: padded ``[rows, cap, ·]`` blocks whose rows are
    allocated in slots of ``n_shards`` consecutive rows.

    ``blk`` maps block names (``kernels.ops.block_layout`` plus ``nbrs``)
    to tensors: device tensors while the bucket is ``resident``, page-
    locked host tensors once it is evicted.  A mutation replaces ``blk``
    with a new dict whose touched tensors are fresh copies (on whichever
    tier the bucket lives), so a :class:`BucketView` captured before it
    keeps reading the pre-mutation tensors.  ``gen`` counts mutations and
    tier transitions, so an admission uploaded off the lock can tell that
    it went stale before installing."""

    cap: int
    seg_ids: np.ndarray          # [rows] int64 owning segment (-1 = free)
    t_min: np.ndarray            # [rows] owning segment's span (+inf free)
    t_max: np.ndarray            # [rows] (-inf free)
    free_slots: List[int]
    gids_h: np.ndarray           # [rows, cap] int32 host mirror (-1 pad)
    blk: Dict[str, torch.Tensor]
    resident: bool = True
    gen: int = 0

    @property
    def n_rows(self) -> int:
        """Allocated rows (live + free) in this bucket's block."""
        return int(self.gids_h.shape[0])

    @property
    def full_nbytes(self) -> int:
        """Bytes of this bucket's blocks on whichever tier they live —
        also the upload size of admitting it."""
        return sum(t.numel() * t.element_size() for t in self.blk.values())

    @property
    def nbytes(self) -> int:
        """Device bytes held by this bucket (0 when evicted)."""
        return self.full_nbytes if self.resident else 0

    @property
    def host_nbytes(self) -> int:
        """Host bytes of this bucket's cold copy (0 when resident)."""
        return 0 if self.resident else self.full_nbytes


@dataclasses.dataclass
class _Upload:
    """An admission's device blocks, copied on a side stream whose end
    ``event`` marks (None on the CPU, where the copy is synchronous)."""

    blk: Dict[str, torch.Tensor]
    event: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class BucketView:
    """Immutable per-bucket snapshot handed to the lock-free query path.

    The tensors are captured by reference (copy-on-write updates never
    edit them); the host-side row metadata is copied because delta
    application edits it in place.  Quantized buckets expose ``codes`` /
    ``xsq`` / ``scales`` instead of ``x``; both expose ``s``.  ``fill``
    counts filled slots per row (the planner's live-point estimate) and
    ``stage_bytes`` the bucket's block bytes (what admitting it uploads).

    A **cold** view (``resident=False``) holds the bucket's page-locked
    host tensors in the same fields; :func:`stage_bucket` copies them to
    the device for one dispatch."""

    cap: int
    gids: torch.Tensor
    seg_ids: np.ndarray
    t_min: np.ndarray
    t_max: np.ndarray
    s: torch.Tensor
    x: Optional[torch.Tensor] = None
    codes: Optional[torch.Tensor] = None
    xsq: Optional[torch.Tensor] = None
    scales: Optional[torch.Tensor] = None
    nbrs: Optional[torch.Tensor] = None   # [rows, cap, degp] int32
    # per-packed-segment graph entry points for the stitched traversal:
    # ((row0, flattened positions), ...) — row0 is the owning slot's first
    # bucket row, so the temporal active mask decides seed inclusion
    entries: Tuple[Tuple[int, np.ndarray], ...] = ()
    resident: bool = True
    stage_bytes: int = 0
    fill: Optional[np.ndarray] = None

    @property
    def quantized(self) -> bool:
        """Whether this bucket holds int8 codes instead of fp32 blocks."""
        return self.codes is not None

    @property
    def graph_ready(self) -> bool:
        """Whether this bucket carries a graph block with at least one
        segment exposing entry points (the graph read path's gate)."""
        return self.nbrs is not None and any(
            len(pos) for _, pos in self.entries)

    def active_rows(self, t_lo: float, t_hi: float) -> np.ndarray:
        """[rows] bool — allocated rows whose segment span overlaps the
        query window.  All-False prunes the whole block."""
        return ((self.seg_ids >= 0) & (self.t_max >= t_lo)
                & (self.t_min <= t_hi))


@dataclasses.dataclass(frozen=True)
class PackView:
    """Consistent snapshot of a :class:`BucketedShardPack` at one epoch —
    what queries search while deltas keep mutating the pack.  ``device``
    is where the pack's kernels run (cold buckets' host blocks are copied
    there per dispatch)."""

    epoch: int
    n_shards: int
    m: int
    buckets: Tuple[BucketView, ...]
    nbytes: int                           # device bytes of the pack
    quantize: Optional[str] = None
    host_nbytes: int = 0                  # cold (evicted) bucket bytes
    device: torch.device = torch.device("cpu")

    @property
    def n_rows(self) -> int:
        """Total allocated pack rows across buckets."""
        return sum(int(b.gids.shape[0]) for b in self.buckets)


def stage_bucket(bv: BucketView, device: torch.device) -> BucketView:
    """The view a dispatch reads: a resident view as is; a cold view's
    blocks copied to ``device`` (``non_blocking`` from pinned memory, on
    the current stream, so the kernel launched after it reads the copy).
    The transient buffer is released when the returned view is dropped."""
    if bv.resident:
        return bv
    names = ("gids", "s", "x", "codes", "xsq", "scales", "nbrs")
    moved = {name: getattr(bv, name).to(device, non_blocking=True)
             for name in names if getattr(bv, name) is not None}
    return dataclasses.replace(bv, resident=True, **moved)


class BucketedShardPack:
    """Size-bucketed, delta-maintained device pack of sealed segments.

    Segments land in capacity buckets (:func:`bucket_cap_for`); each bucket
    owns padded ``[rows, cap, ·]`` device blocks that grow geometrically
    in slots of ``n_shards`` rows.  Mutations — :meth:`add_segment`,
    :meth:`remove_segment`, :meth:`mark_dead` — are copy-on-write, so a
    :class:`PackView` captured before a mutation keeps answering from the
    pre-mutation state.  The owner (``SegmentManager``) serializes
    mutations and view capture under its lock and stamps ``epoch`` after
    each applied delta.  Blocks live on ``device`` (default: the card)
    while resident and in page-locked host memory once evicted; new
    buckets start resident iff ``resident_default``.  ``fault_hook`` (a
    plain callable, default None) fires at ``admission.stage`` /
    ``admission.upload`` / ``admission.install``.
    """

    def __init__(self, n_shards: int, d: int, m: int, epoch: int = 0,
                 cap_multiple: int = 256, quantize: Optional[str] = None,
                 metrics=None, graph_degree: Optional[int] = None,
                 device=None, resident_default: bool = True):
        from ..obs.metrics import NULL_REGISTRY
        self.metrics = NULL_REGISTRY if metrics is None else metrics
        self.device = resolve_device(device)
        self.resident_default = bool(resident_default)
        self.fault_hook = None
        # host copies of a card pack's blocks are page-locked, so a cold
        # dispatch or an admission copies them asynchronously
        self._pin = self.device.type == "cuda"
        # the stream the pack's kernels are launched on (the owner's
        # queries), which waits on every admission's upload event, and the
        # side stream admissions upload on
        self._consumer = (torch.cuda.current_stream(self.device)
                          if self._pin else None)
        self._side = None
        self.n_shards = max(int(n_shards), 1)
        self.d = int(d)
        self.m = int(m)
        # graph read path: when set, every bucket also carries a
        # [rows, cap, degp] adjacency block of flattened bucket positions
        self.graph_degree = None if not graph_degree else int(graph_degree)
        self.degp = (round_up(max(self.graph_degree, 1), 8)
                     if self.graph_degree else 0)
        self.epoch = int(epoch)
        self.cap_multiple = max(int(cap_multiple), 8)
        self.quantize = quantize
        self.mode = "int8" if quantize else "fp32"
        self.buckets: Dict[int, _Bucket] = {}
        self._entries: Dict[int, _SegEntry] = {}

    # -- geometry ------------------------------------------------------
    @property
    def n_segments(self) -> int:
        """Segments currently packed."""
        return len(self._entries)

    @property
    def n_rows(self) -> int:
        """Total allocated pack rows (live + free) across buckets."""
        return sum(b.n_rows for b in self.buckets.values())

    @property
    def nbytes(self) -> int:
        """Device bytes held by resident bucket blocks."""
        return sum(b.nbytes for b in self.buckets.values())

    @property
    def host_nbytes(self) -> int:
        """Host bytes held by evicted (cold) bucket blocks."""
        return sum(b.host_nbytes for b in self.buckets.values())

    def bucket_stats(self) -> Dict[int, Dict[str, int]]:
        """Per-bucket occupancy:
        ``{cap: {rows, live_rows, segments, resident}}``."""
        out = {}
        for cap, b in sorted(self.buckets.items()):
            out[cap] = {"rows": b.n_rows,
                        "live_rows": int((b.seg_ids >= 0).sum()),
                        "segments": int(len({int(s) for s in b.seg_ids
                                             if s >= 0})),
                        "resident": int(b.resident)}
        return out

    # -- placement -----------------------------------------------------
    def _home(self, resident: bool) -> torch.device:
        """Where a bucket's blocks live: the pack's device or the host."""
        return self.device if resident else torch.device("cpu")

    def _own(self, resident: bool, t: torch.Tensor) -> torch.Tensor:
        """``t`` made fit for a bucket's blocks: page-locked when it is a
        cold block of a card pack."""
        if resident or not self._pin or t.is_pinned():
            return t
        return t.pin_memory()

    def _clone(self, b: _Bucket, t: torch.Tensor) -> torch.Tensor:
        """A copy-on-write copy of one of ``b``'s blocks, on its tier."""
        if b.resident or not self._pin:
            return t.clone()
        out = torch.empty_like(t, pin_memory=True)
        out.copy_(t)
        return out

    def _new_block(self, rows: int, cap: int, resident: bool = True
                   ) -> Dict[str, torch.Tensor]:
        """Fresh zero / ``PAD_META`` blocks for ``rows`` bucket rows in the
        pack's layout, plus the adjacency block when the graph read path
        is on — on the device, or page-locked on the host for a cold
        bucket."""
        home = self._home(resident)
        layout = block_layout(self.mode, rows, cap, self.d, self.m)
        if self.graph_degree:
            layout["nbrs"] = ((rows, cap, self.degp), torch.int32, -1)
        return {name: self._own(resident, torch.full(
                    shape, fill, dtype=dtype, device=home))
                for name, (shape, dtype, fill) in layout.items()}

    def _bucket_for(self, cap: int) -> _Bucket:
        b = self.buckets.get(cap)
        if b is None:
            rows = self.n_shards
            res = self.resident_default
            b = _Bucket(cap, seg_ids=np.full(rows, -1, np.int64),
                        t_min=np.full(rows, np.inf, np.float64),
                        t_max=np.full(rows, -np.inf, np.float64),
                        free_slots=[0],
                        gids_h=np.full((rows, cap), -1, np.int32),
                        blk=self._new_block(rows, cap, res), resident=res)
            self.buckets[cap] = b
        return b

    def _alloc_slot(self, b: _Bucket) -> int:
        """Pop the lowest free slot, doubling the block when none is left
        (geometric growth keeps appends amortized O(changed segment))."""
        if not b.free_slots:
            old_slots = b.n_rows // self.n_shards
            add_rows = old_slots * self.n_shards
            add = self._new_block(add_rows, b.cap, b.resident)
            b.blk = {name: self._own(b.resident, torch.cat([t, add[name]]))
                     for name, t in b.blk.items()}
            b.gids_h = np.concatenate(
                [b.gids_h, np.full((add_rows, b.cap), -1, np.int32)])
            b.seg_ids = np.concatenate(
                [b.seg_ids, np.full(add_rows, -1, np.int64)])
            b.t_min = np.concatenate(
                [b.t_min, np.full(add_rows, np.inf, np.float64)])
            b.t_max = np.concatenate(
                [b.t_max, np.full(add_rows, -np.inf, np.float64)])
            b.free_slots.extend(range(old_slots, 2 * old_slots))
            b.gen += 1
        b.free_slots.sort()
        return b.free_slots.pop(0)

    # -- delta protocol ------------------------------------------------
    def _shard_rows(self, n: int):
        return [np.arange(sh, n, self.n_shards) for sh in range(self.n_shards)]

    def _stage_fp32(self, src: SegmentShardSource, cap: int):
        """Host-stage one segment's fp32 rows as ``[n_shards, cap, ·]``
        blocks ready for the delta write."""
        xb = np.zeros((self.n_shards, cap, self.d), np.float32)
        sb = np.full((self.n_shards, cap, self.m), PAD_META, np.float32)
        for sh, idx in enumerate(self._shard_rows(len(src.gids))):
            xb[sh, : len(idx)] = src.x[idx]
            sb[sh, : len(idx)] = src.s[idx]
        return dict(x=xb, s=sb)

    def _stage_quant(self, src: SegmentShardSource, cap: int):
        """Host-stage one segment's int8 codes in the row-major layout.
        Uses the segment's sealed codec payload when present; otherwise
        encodes on the fly."""
        from ..quant import encode_segment
        if src.codes is not None:
            codes, scales, xsq = src.codes, src.scales, src.xsq
        else:
            q = encode_segment(src.x, self.quantize)
            codes, scales, xsq = q.codes, q.scales, q.xsq
        cb = np.zeros((self.n_shards, cap, self.d), np.int8)
        sb = np.full((self.n_shards, cap, self.m), PAD_META, np.float32)
        xb = np.zeros((self.n_shards, cap), np.float32)
        scb = np.tile(np.asarray(scales, np.float32)[None, :],
                      (self.n_shards, 1))
        for sh, idx in enumerate(self._shard_rows(len(src.gids))):
            cb[sh, : len(idx)] = codes[idx]
            sb[sh, : len(idx)] = src.s[idx]
            xb[sh, : len(idx)] = xsq[idx]
        return dict(codes=cb, s=sb, xsq=xb, scales=scb)

    def _stage_graph(self, src: SegmentShardSource, cap: int, row0: int):
        """Host-stage one segment's adjacency as a ``[n_shards, cap, degp]``
        block of flattened bucket positions (``row * cap + col``), plus
        the segment's entry points in the same coordinates.  Positions
        bake in the slot's ``row0``, so they survive later block doubling
        (growth only appends rows).  A segment without a graph payload
        stages an all ``-1`` block and no entries — the planner then keeps
        the bucket on the scan path."""
        n = len(src.gids)
        nb = np.full((self.n_shards, cap, self.degp), -1, np.int32)
        entry_pos = np.empty(0, np.int64)
        if src.nbrs is not None and n:
            loc = np.arange(n)
            pos_of = ((row0 + loc % self.n_shards) * cap
                      + loc // self.n_shards).astype(np.int64)
            deg = min(src.nbrs.shape[1], self.degp)
            nbr = np.asarray(src.nbrs[:, :deg], np.int64)
            npos = np.where(nbr >= 0, pos_of[np.minimum(np.maximum(nbr, 0),
                                                        n - 1)],
                            -1).astype(np.int32)
            for sh, idx in enumerate(self._shard_rows(n)):
                nb[sh, : len(idx), :deg] = npos[idx]
            if src.entries is not None and len(src.entries):
                e = np.asarray(src.entries, np.int64)
                e = e[(e >= 0) & (e < n)]
                entry_pos = pos_of[e]
        return nb, entry_pos

    def add_segment(self, src: SegmentShardSource) -> None:
        """Append one segment's live points into its capacity bucket:
        O(segment) host staging, then one copy-on-write block write per
        device block — other segments' rows are copied, never edited."""
        n = len(src.gids)
        if n == 0:
            return
        if src.seg_id in self._entries:
            raise ValueError(f"segment {src.seg_id} is already packed")
        cap = bucket_cap_for(n, self.n_shards, self.cap_multiple)
        b = self._bucket_for(cap)
        slot = self._alloc_slot(b)
        row0 = slot * self.n_shards
        rows = slice(row0, row0 + self.n_shards)
        staged = (self._stage_quant(src, cap) if self.quantize
                  else self._stage_fp32(src, cap))
        entry_pos = None
        if self.graph_degree:
            staged["nbrs"], entry_pos = self._stage_graph(src, cap, row0)
        gb = np.full((self.n_shards, cap), -1, np.int32)
        for sh, idx in enumerate(self._shard_rows(n)):
            gb[sh, : len(idx)] = src.gids[idx]
        staged["gids"] = gb
        if b.resident:
            # delta upload volume: what this seal/publish shipped to the
            # device (a cold bucket takes the delta in its host copy)
            self.metrics.counter("pack_delta_bytes_total").inc(
                sum(arr.nbytes for arr in staged.values()))
        home = self._home(b.resident)
        blk = dict(b.blk)
        for name, block in staged.items():
            t = self._clone(b, blk[name])
            t[rows] = _put(block, home)
            blk[name] = t
        b.blk = blk
        b.gen += 1
        b.gids_h = b.gids_h.copy()
        b.gids_h[rows] = gb
        b.seg_ids[rows] = src.seg_id
        b.t_min[rows] = src.t_min
        b.t_max[rows] = src.t_max
        order = np.argsort(src.gids, kind="stable")
        self._entries[src.seg_id] = _SegEntry(
            int(src.seg_id), cap, slot,
            np.asarray(src.gids, np.int64)[order],
            (row0 + order % self.n_shards).astype(np.int64),
            (order // self.n_shards).astype(np.int64),
            entry_pos=entry_pos)

    def remove_segment(self, seg_id: int) -> bool:
        """Tombstone one segment (compaction victim or expiry): host-only —
        the slot is freed and its rows drop out of every later view's
        active mask; the stale device rows are overwritten when the slot
        is reused.  A bucket whose last slot empties is released."""
        e = self._entries.pop(int(seg_id), None)
        if e is None:
            return False
        b = self.buckets[e.cap]
        rows = slice(e.slot * self.n_shards, (e.slot + 1) * self.n_shards)
        b.seg_ids[rows] = -1
        b.t_min[rows] = np.inf
        b.t_max[rows] = -np.inf
        b.free_slots.append(e.slot)
        b.gen += 1
        if not (b.seg_ids >= 0).any():
            del self.buckets[e.cap]
        return True

    def mark_dead(self, gids: Sequence[int]) -> int:
        """Mask points by global id: their metadata rows become
        ``PAD_META`` (a copy-on-write write into each touched bucket's
        metadata block), so every later view's predicate rejects them.
        Returns the number of pack positions masked."""
        g = np.asarray(gids, np.int64)
        if len(g) == 0:
            return 0
        g_lo, g_hi = int(g.min()), int(g.max())
        per_bucket: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
        total = 0
        for e in self._entries.values():
            if len(e.gid_sorted) == 0 or e.gid_sorted[-1] < g_lo \
                    or e.gid_sorted[0] > g_hi:
                continue
            pos = np.searchsorted(e.gid_sorted, g)
            pos_c = np.clip(pos, 0, len(e.gid_sorted) - 1)
            ok = e.gid_sorted[pos_c] == g
            if not ok.any():
                continue
            sel = pos_c[ok]
            per_bucket.setdefault(e.cap, []).append(
                (e.rows_sorted[sel], e.cols_sorted[sel]))
            total += int(sel.size)
        for cap, hits in per_bucket.items():
            b = self.buckets[cap]
            rows = np.concatenate([r for r, _ in hits])
            cols = np.concatenate([c for _, c in hits])
            home = self._home(b.resident)
            s = self._clone(b, b.blk["s"])
            s[_put(rows, home), _put(cols, home)] = PAD_META
            b.blk = dict(b.blk, s=s)
            b.gen += 1
        return total

    def sync_alive(self, alive: np.ndarray) -> int:
        """Mask every packed point whose gid is dead in ``alive`` (the
        manager's liveness bitmap) — used once at cold-build installation
        to catch deletions that raced the build."""
        dead = [e.gid_sorted[~alive[e.gid_sorted]]
                for e in self._entries.values()]
        dead = np.concatenate(dead) if dead else np.empty(0, np.int64)
        return self.mark_dead(dead) if len(dead) else 0

    # -- tier transitions (tiered storage, streaming/tiering.py) -------
    def evict_bucket(self, cap: int) -> int:
        """Demote one resident bucket's device blocks to page-locked host
        copies (call under the owner's lock).  In-flight views keep the
        device tensors they captured alive; new views of this bucket read
        the byte-identical host copy.  Returns the device bytes released
        (the allocator frees them once no view holds them)."""
        b = self.buckets.get(cap)
        if b is None or not b.resident:
            return 0
        freed = b.nbytes
        host = {}
        for name, t in b.blk.items():
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=self._pin)
            h.copy_(t)
            host[name] = h
        b.blk = host
        b.resident = False
        b.gen += 1
        return freed

    def _fault(self, point: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(point)

    def stage_admission(self, cap: int):
        """Host half of an admission: snapshot a cold bucket's host blocks
        (call under the owner's lock).  Returns ``(gen, blocks)`` or None
        when the bucket is missing or already resident.  Fault point
        ``admission.stage`` fires first — a crash here mutates nothing."""
        self._fault("admission.stage")
        b = self.buckets.get(cap)
        if b is None or b.resident:
            return None
        return b.gen, dict(b.blk)

    def upload_admission(self, staged):
        """Device half of an admission, off the owner's lock: copy the
        staged page-locked blocks to the device on the pack's side stream
        and record an event at the end of the copies.  Returns ``(gen,
        upload)`` for :meth:`install_admission`.  Fault point
        ``admission.upload`` fires first — a crash strands nothing (the
        host copy still lives in the bucket)."""
        self._fault("admission.upload")
        gen, blocks = staged
        if not self._pin:
            return gen, _Upload({name: t.to(self.device, copy=True)
                                 for name, t in blocks.items()})
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._side):
            dev = {name: t.to(self.device, non_blocking=True)
                   for name, t in blocks.items()}
            event = torch.cuda.Event()
            event.record(self._side)
        return gen, _Upload(dev, event)

    def install_admission(self, cap: int, gen: int, upload: _Upload) -> int:
        """Publish an uploaded admission iff the bucket is still cold and
        unchanged since :meth:`stage_admission` (call under the owner's
        lock).  The consuming stream waits on the upload's event (on the
        device, not the host), and every uploaded tensor is recorded on
        that stream for the caching allocator.  Returns the admitted
        device bytes; 0 means the upload went stale (a delta landed
        mid-upload) and was discarded.  Fault point
        ``admission.install`` fires first — a crash leaves the bucket
        cold, consistent and admittable again."""
        self._fault("admission.install")
        b = self.buckets.get(cap)
        if b is None or b.resident or b.gen != gen:
            return 0
        if upload.event is not None:
            self._consumer.wait_event(upload.event)
            for t in upload.blk.values():
                t.record_stream(self._consumer)
        b.blk = dict(upload.blk)
        b.resident = True
        b.gen += 1
        return b.nbytes

    def admit_bucket(self, cap: int) -> int:
        """Synchronous admission (the owner's lock held throughout):
        stage, upload and install one cold bucket.  Returns the admitted
        device bytes (0 = missing or already resident)."""
        staged = self.stage_admission(cap)
        if staged is None:
            return 0
        return self.install_admission(cap, *self.upload_admission(staged))

    # -- read side -----------------------------------------------------
    def _bucket_view(self, cap: int, b: _Bucket) -> BucketView:
        entries = tuple(
            (e.slot * self.n_shards, e.entry_pos)
            for e in self._entries.values()
            if e.cap == cap and e.entry_pos is not None
            and len(e.entry_pos))
        fill = (b.gids_h >= 0).sum(axis=1).astype(np.int64)
        blk = b.blk
        return BucketView(cap, blk["gids"], seg_ids=b.seg_ids.copy(),
                          t_min=b.t_min.copy(), t_max=b.t_max.copy(),
                          s=blk["s"], x=blk.get("x"),
                          codes=blk.get("codes"), xsq=blk.get("xsq"),
                          scales=blk.get("scales"), nbrs=blk.get("nbrs"),
                          entries=entries, resident=b.resident,
                          stage_bytes=b.full_nbytes, fill=fill)

    def bucket_view(self, cap: int) -> Optional[BucketView]:
        """Fresh snapshot of one bucket (e.g. right after an admission, so
        the in-flight query dispatches the resident block)."""
        b = self.buckets.get(cap)
        if b is None or not (b.seg_ids >= 0).any():
            return None
        return self._bucket_view(cap, b)

    def view(self) -> PackView:
        """Immutable snapshot for one query (capture under the owner's
        lock).  Buckets with no live slot are dropped; cold buckets are
        kept, their host blocks dispatched through the same kernels."""
        views = [self._bucket_view(cap, self.buckets[cap])
                 for cap in sorted(self.buckets)
                 if (self.buckets[cap].seg_ids >= 0).any()]
        return PackView(self.epoch, self.n_shards, self.m, tuple(views),
                        self.nbytes, quantize=self.quantize,
                        host_nbytes=self.host_nbytes, device=self.device)


def build_bucketed_pack(sources: Sequence[SegmentShardSource], n_shards: int,
                        epoch: int = 0, cap_multiple: int = 256,
                        quantize: Optional[str] = None, metrics=None,
                        graph_degree: Optional[int] = None,
                        device=None, resident_default: bool = True
                        ) -> BucketedShardPack:
    """Cold-build a :class:`BucketedShardPack`: the same
    :meth:`~BucketedShardPack.add_segment` delta applied once per
    segment, so an incrementally maintained pack and a from-scratch build
    of the same segments answer identically.  ``resident_default=False``
    builds every bucket in host memory (no device upload): a budgeted
    tier then admits only the buckets that fit."""
    if not sources:
        raise ValueError("build_bucketed_pack needs at least one segment")
    pack = BucketedShardPack(n_shards, sources[0].x.shape[1],
                             sources[0].s.shape[1], epoch=epoch,
                             cap_multiple=cap_multiple, quantize=quantize,
                             metrics=metrics, graph_degree=graph_degree,
                             device=device,
                             resident_default=resident_default)
    for src in sources:
        pack.add_segment(src)
    return pack


def bucket_graph_seeds(bv: BucketView, t_lo: float, t_hi: float
                       ) -> np.ndarray:
    """Flattened seed positions for one bucket's stitched traversal: the
    union of graph entry points of every temporally active packed segment
    (the stitching rule — one beam, seeded in every unpruned segment's
    component)."""
    if bv.nbrs is None or not bv.entries:
        return np.empty(0, np.int64)
    active = bv.active_rows(t_lo, t_hi)
    parts = [pos for row0, pos in bv.entries
             if row0 < len(active) and active[row0]]
    return np.concatenate(parts) if parts else np.empty(0, np.int64)


def host_topk(g: np.ndarray, d: np.ndarray, k: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact host-side top-k over concatenated ``(gid, dist)`` candidate
    rows: ``argpartition`` narrows each row to ``k`` candidates, then one
    ``lexsort`` orders the slice by ``(dist, gid)``.  Rows where a finite
    distance tie straddles the k-th position are re-selected by the full
    ``(dist, gid)`` order, so the result does not depend on block order.
    Returns ``(gids [b, k] int64, dists [b, k] fp32)`` padded with
    ``-1`` / ``+inf``."""
    d = np.where(g >= 0, np.asarray(d, np.float32), np.inf)
    g = np.asarray(g, np.int64)
    if d.shape[1] > k:
        part = np.argpartition(d, k - 1, axis=1)
        g_sel = np.take_along_axis(g, part[:, :k], axis=1)
        d_sel = np.take_along_axis(d, part[:, :k], axis=1)
        kth = d_sel.max(axis=1)
        d_rest = np.take_along_axis(d, part[:, k:], axis=1)
        # +inf boundary ties are harmless (every +inf selection emits
        # gid -1 below); finite ones get the rare full-sort path
        amb = np.isfinite(kth) & (d_rest == kth[:, None]).any(axis=1)
        if amb.any():
            full = np.lexsort((g[amb], d[amb]))[:, :k]
            g_sel[amb] = np.take_along_axis(g[amb], full, axis=1)
            d_sel[amb] = np.take_along_axis(d[amb], full, axis=1)
        g, d = g_sel, d_sel
    order = np.lexsort((g, d))           # per-row: dist, then gid
    out_g = np.take_along_axis(g, order, axis=1)
    out_d = np.take_along_axis(d, order, axis=1)
    out_g = np.where(np.isfinite(out_d), out_g, -1)
    b, w = out_g.shape
    if w < k:
        out_g = np.concatenate(
            [out_g, np.full((b, k - w), -1, np.int64)], axis=1)
        out_d = np.concatenate(
            [out_d, np.full((b, k - w), np.inf, np.float32)], axis=1)
    return out_g, out_d.astype(np.float32)


def _merge_shard_topk(ids, dd, gid_stack, active, k: int):
    """Shard-local (ids, dists) [g, b, k'] -> exact global (gids, dists)
    [b, k] on the device.  Inactive rows and misses are masked to +inf
    before one stable sort over the concatenated shard axis (ties keep
    the lower position, the order of the reference's ``top_k``)."""
    g, b, kk = ids.shape
    gl = torch.gather(gid_stack.long(), 1,
                      ids.long().clamp_min(0).reshape(g, b * kk))
    gl = gl.reshape(g, b, kk)
    valid = (ids >= 0) & active[:, None, None]
    dd = torch.where(valid, dd, float("inf"))
    alld = dd.permute(1, 0, 2).reshape(b, g * kk)
    allg = gl.permute(1, 0, 2).reshape(b, g * kk)
    sd, sel = torch.sort(alld, dim=1, stable=True)
    out_d = sd[:, :k]
    out_g = torch.gather(allg, 1, sel[:, :k])
    return torch.where(torch.isfinite(out_d), out_g, -1), out_d


def pack_search_blocks(view: PackView, queries: np.ndarray,
                       filt: Optional[Filter], k: int,
                       t_lo: float = -np.inf, t_hi: float = np.inf,
                       metric: str = "l2", trace=None, observe=None,
                       on_cold=None
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One fused-kernel launch per non-empty, temporally unpruned bucket.

    A bucket whose segment spans all miss ``[t_lo, t_hi]`` is skipped
    entirely.  Each fp32 bucket contributes one exact ``(gids [b, k_b],
    dists [b, k_b])`` candidate block for the caller's exact ``(gid,
    dist)`` merge; quantized buckets launch B3 instead and their blocks
    carry distances to the dequantized vectors — the caller over-fetches
    (``k = rerank_multiple * final_k``) and reranks the union exactly at
    fp32 (``repro_torch.quant.rerank_exact``).

    ``trace`` opens one span per dispatched bucket, stopped only after
    the bucket's device results are ready; ``observe``
    (``BucketStats.observe``) receives one observation per bucket —
    ``cache_hit`` meaning the scan kernel was already loaded.

    A cold bucket (``resident=False``) is copied to the view's device for
    its dispatch (:func:`stage_bucket`) and scanned by the same kernel at
    the same shapes, so its answers are the resident block's bit for bit;
    ``on_cold(cap, stage_bytes)`` fires once per dispatched cold bucket
    (tier-miss accounting)."""
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    trace = NULL_TRACE if trace is None else trace
    want_obs = observe is not None or trace.enabled
    blocks: List[Tuple[np.ndarray, np.ndarray]] = []
    q = None
    for bv in view.buckets:
        active = bv.active_rows(t_lo, t_hi)
        rows = int(bv.gids.shape[0])
        n_active = int(active.sum())
        if n_active == 0:
            if observe is not None:       # whole-block temporal prune
                observe(bv.cap, rows=rows, active_rows=0)
            continue
        dev = view.device
        cold = not bv.resident
        if cold and on_cold is not None:
            on_cold(bv.cap, bv.stage_bytes)
        if q is None or q.device != dev:
            q = torch.as_tensor(queries, device=dev)
        kk = min(k, bv.cap)               # per-shard list length
        # merged width: for k > cap the per-shard lists (= whole shards)
        # still hold up to rows * kk candidates, so the top-k stays exact
        k_out = min(k, rows * kk)
        mode = "int8" if bv.quantized else "fp32"
        cache_hit = kernels_loaded(mode) if want_obs else False
        with trace.span("bucket_dispatch", cap=bv.cap, rows=rows,
                        active_rows=n_active, k_out=k_out,
                        quantized=bv.quantized, resident=not cold) as sp:
            bv = stage_bucket(bv, dev)
            if bv.quantized:
                ids, dd = sharded_quant_filtered_topk(
                    q, bv.codes, bv.s, bv.xsq, bv.scales, filt, kk,
                    metric=metric, m=view.m)
            else:
                ids, dd = sharded_filtered_topk(q, bv.x, bv.s, filt, kk,
                                                metric=metric, m=view.m)
            out_g, out_d = _merge_shard_topk(
                ids, dd, bv.gids, torch.as_tensor(active, device=dev), k_out)
            out_g = out_g.cpu().numpy()
            out_d = out_d.cpu().numpy().astype(np.float32)
        if want_obs:
            n_cand = int((out_g >= 0).sum())
            sp.annotate(candidates=n_cand, cache_hit=cache_hit)
            if observe is not None:
                observe(bv.cap, rows=rows, active_rows=n_active,
                        candidates=n_cand,
                        candidate_slots=queries.shape[0] * k_out,
                        cache_hit=cache_hit)
        blocks.append((out_g, out_d))
    return blocks


def pack_search_blocks_grouped(view: PackView, groups,
                               metric: str = "l2", trace=None,
                               observe=None, on_cold=None,
                               deadlines=None, on_expired=None,
                               fault=None, observe_group=None
                               ) -> List[List[Tuple[np.ndarray, np.ndarray]]]:
    """Heterogeneous-request sibling of :func:`pack_search_blocks`: several
    ``(queries, filt, k, t_lo, t_hi)`` request groups scan the pack's fp32
    buckets in ONE pass, sharing each bucket's device block across every
    group temporally active there.

    Per bucket, the groups whose window meets it (exactly the groups for
    which a solo :func:`pack_search_blocks` call would dispatch it) go
    through one :func:`repro_torch.kernels.ops.sharded_filtered_topk_grouped`
    call — one B1 launch per filter class over the bucket's block, read in
    place — and each group's shard-local lists are merged with the group's
    own temporal ``active`` mask and ``k``.  Every group's candidate block
    is bit for bit its solo call's, so callers merge the returned blocks
    as if each group had scanned alone.  A cold bucket is copied to the
    device once (:func:`stage_bucket`) for all its groups, and
    ``on_cold(cap, stage_bytes)`` fires once for it.

    ``deadlines`` (parallel to ``groups``: objects with ``expired()`` or
    None) drops a group from all remaining buckets once its deadline
    passes, reporting ``on_expired(group_idx, buckets_remaining)`` once;
    ``fault()`` fires before each bucket's dispatch (the owner's
    ``query.bucket`` fault point); ``observe`` gets one union observation
    per bucket, ``observe_group(group_idx, cap, rows=, active_rows=,
    candidates=, candidate_slots=, cache_hit=)`` the same dispatch per
    group (per-tenant ``BucketStats``).  Returns one candidate-block list
    per group (a dropped group keeps the blocks gathered before its
    deadline passed)."""
    trace = NULL_TRACE if trace is None else trace
    groups = [(np.atleast_2d(np.asarray(q, np.float32)), f, int(k),
               float(t_lo), float(t_hi)) for q, f, k, t_lo, t_hi in groups]
    want_obs = (observe is not None or observe_group is not None
                or trace.enabled)
    blocks: List[List[Tuple[np.ndarray, np.ndarray]]] = \
        [[] for _ in groups]
    expired = [False] * len(groups)
    buckets = list(view.buckets)
    dev = view.device
    qt: Dict[int, torch.Tensor] = {}
    for bi, bv in enumerate(buckets):
        if deadlines is not None:
            for gi, dl in enumerate(deadlines):
                if not expired[gi] and dl is not None and dl.expired():
                    expired[gi] = True
                    if on_expired is not None:
                        on_expired(gi, len(buckets) - bi)
        rows = int(bv.gids.shape[0])
        actives = {}
        live: List[int] = []
        for gi, (_, _, _, t_lo, t_hi) in enumerate(groups):
            if expired[gi]:
                continue
            act = bv.active_rows(t_lo, t_hi)
            if act.any():
                actives[gi] = act
                live.append(gi)
            elif observe_group is not None:   # whole-block temporal prune
                observe_group(gi, bv.cap, rows=rows, active_rows=0)
        if not live:
            if observe is not None:
                observe(bv.cap, rows=rows, active_rows=0)
            continue
        if fault is not None:
            fault()
        cold = not bv.resident
        if cold and on_cold is not None:
            on_cold(bv.cap, bv.stage_bytes)
        union_active = int(np.logical_or.reduce(
            [actives[gi] for gi in live]).sum())
        cache_hit = kernels_loaded("fp32") if want_obs else False
        with trace.span("bucket_dispatch_grouped", cap=bv.cap, rows=rows,
                        active_rows=union_active, n_groups=len(live),
                        resident=not cold) as sp:
            bv = stage_bucket(bv, dev)
            for gi in live:
                if gi not in qt:
                    qt[gi] = torch.as_tensor(groups[gi][0], device=dev)
            sub = [(qt[gi], groups[gi][1], min(groups[gi][2], bv.cap))
                   for gi in live]
            results = sharded_filtered_topk_grouped(sub, bv.x, bv.s,
                                                    metric=metric, m=view.m)
            merged = []
            for (ids, dd), gi in zip(results, live):
                kk = min(groups[gi][2], bv.cap)
                k_out = min(groups[gi][2], rows * kk)
                out_g, out_d = _merge_shard_topk(
                    ids, dd, bv.gids,
                    torch.as_tensor(actives[gi], device=dev), k_out)
                merged.append((out_g.cpu().numpy(),
                               out_d.cpu().numpy().astype(np.float32)))
        n_cand_total = 0
        for (out_g, out_d), gi in zip(merged, live):
            blocks[gi].append((out_g, out_d))
            if want_obs:
                n_cand = int((out_g >= 0).sum())
                n_cand_total += n_cand
                if observe_group is not None:
                    observe_group(
                        gi, bv.cap, rows=rows,
                        active_rows=int(actives[gi].sum()),
                        candidates=n_cand,
                        candidate_slots=out_g.shape[0] * out_g.shape[1],
                        cache_hit=cache_hit)
        if want_obs:
            sp.annotate(candidates=n_cand_total, cache_hit=cache_hit)
            if observe is not None:
                observe(bv.cap, rows=rows, active_rows=union_active,
                        candidates=n_cand_total,
                        candidate_slots=sum(
                            g.shape[0] * g.shape[1] for g, _ in merged),
                        cache_hit=cache_hit)
    return blocks


def pack_search(pack, queries: np.ndarray, filt: Optional[Filter],
                k: int, t_lo: float = -np.inf, t_hi: float = np.inf,
                metric: str = "l2", lookup=None,
                rerank_multiple: int = 4, trace=None, observe=None,
                on_cold=None) -> Tuple[np.ndarray, np.ndarray]:
    """Fan one query batch out over every active shard of the pack and
    merge the shard-local top-k exactly.

    ``pack`` is a :class:`ShardPack`, a :class:`BucketedShardPack` or a
    :class:`PackView`.  A quantized pack also needs ``lookup(gids) -> (x,
    s, present)`` (the manager's point-store getter) for the exact fp32
    rerank of its over-fetched (``rerank_multiple * k``) candidates.
    Returns ``(gids [b, k] int64, dists [b, k] fp32)`` with ``-1`` /
    ``+inf`` padding."""
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    b = queries.shape[0]
    trace = NULL_TRACE if trace is None else trace
    if isinstance(pack, (BucketedShardPack, PackView)):
        view = pack.view() if isinstance(pack, BucketedShardPack) else pack
        quantized = view.quantize is not None
        k_fetch = max(k * max(int(rerank_multiple), 1), k) if quantized \
            else k
        blocks = pack_search_blocks(view, queries, filt, k_fetch, t_lo=t_lo,
                                    t_hi=t_hi, metric=metric, trace=trace,
                                    observe=observe, on_cold=on_cold)
        if not blocks:
            return (np.full((b, k), -1, np.int64),
                    np.full((b, k), np.inf, np.float32))
        g = np.concatenate([bg for bg, _ in blocks], axis=1)
        if quantized:
            # the approximate distances are never read past this point —
            # the rerank re-scores candidates from their gids alone
            if lookup is None:
                raise ValueError("a quantized pack needs lookup= for the "
                                 "exact fp32 rerank")
            from ..quant import rerank_exact
            with trace.span("rerank_fp32", overfetch=int(g.shape[1]),
                            k=k) as sp:
                out = rerank_exact(queries, g, k, lookup, metric=metric,
                                   device=view.device)
                sp.annotate(candidates=int((out[0] >= 0).sum()))
            return out
        d = np.concatenate([bd for _, bd in blocks], axis=1)
        return host_topk(g, d, k)
    kk = min(k, pack.cap)                 # per-shard list length
    k_out = min(k, pack.n_rows * kk)
    with trace.span("pack_dispatch", rows=pack.n_rows, cap=pack.cap,
                    k_out=k_out):
        dev = pack.x.device
        ids, dd = sharded_filtered_topk(torch.as_tensor(queries, device=dev),
                                        pack.x, pack.s_dev, filt, kk,
                                        metric=metric, m=pack.m)
        active = torch.as_tensor(pack.active_rows(t_lo, t_hi), device=dev)
        out_g, out_d = _merge_shard_topk(ids, dd, pack.gids_dev, active,
                                         k_out)
        block_ready((out_g, out_d))
    gids = np.full((b, k), -1, np.int64)
    dists = np.full((b, k), np.inf, np.float32)
    gids[:, :k_out] = out_g.cpu().numpy()
    dists[:, :k_out] = out_d.cpu().numpy()
    return gids, dists
