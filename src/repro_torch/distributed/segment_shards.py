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

On one card the shard axis is a batch axis of the kernels.  On a
:class:`ShardMesh` (:func:`make_shard_mesh`) one process drives several
cards: bucket row ``r`` lives on card ``r % n`` of the mesh's ``n``
devices (local row ``r // n``; :meth:`ShardMesh.owner`), so every block
(``x``, ``s``, ``codes``, ``xsq``, ``scales``, ``nbrs``, ``gids``) is a
tuple of per-card tensors — of one tensor without a shard mesh, whose
pack lives on a one-entry mesh.
Each card scans its own rows with the same kernel, only the ``[rows_c, b,
k']`` candidate lists cross to the mesh's **home** card (its first
device), and the merge there reads them in global row order, so a mesh
answers bit for bit like one card.  A mutation clones and writes only the
owning cards' tensors; residency moves each card's rows between that card
and page-locked host memory.

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
(``numel * element_size``), summed over every card of a mesh; the
transient cold buffer is not counted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import Filter
from ..device import resolve_device
from ..kernels.ops import (PAD_META, block_layout, next_pow2, round_up,
                           kernels_loaded, sharded_filtered_topk,
                           sharded_filtered_topk_grouped,
                           sharded_quant_filtered_topk)
from ..obs.metrics import NULL_REGISTRY, count_h2d
from ..obs.trace import NULL_TRACE, block_ready

__all__ = ["BucketView", "BucketedShardPack", "PackView", "PAD_META",
           "SegmentShardSource", "ShardMesh", "ShardPack", "bucket_cap_for",
           "bucket_graph_seeds", "build_bucketed_pack", "build_shard_pack",
           "host_topk", "make_shard_mesh", "pack_search",
           "pack_search_blocks", "pack_search_blocks_grouped",
           "resolve_mesh", "stage_bucket"]


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


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The devices a pack's bucket rows are spread over, in order; the
    first is the **home** device, where queries enter, candidate lists
    are merged and a traversal's beam lives.  Repeats are allowed (a mesh
    of several entries on one card, or ``("cpu",) * 4`` for the CPU
    tests), and every entry must be of one device type.

    The row -> card map is written here and nowhere else: bucket row
    ``r`` lives on card ``r % n`` at local row ``r // n`` (:meth:`owner`,
    :meth:`deal`).  A pack without a mesh uses a one-entry mesh, on which
    the map is the identity."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a ShardMesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a ShardMesh spans one device type, got "
                             f"{[str(d) for d in devs]}")
        if devs[0].type == "cuda":
            devs = tuple(torch.device("cuda", torch.cuda.current_device()
                                      if d.index is None else d.index)
                         for d in devs)
        object.__setattr__(self, "devices", devs)

    @property
    def home(self) -> torch.device:
        """Where queries enter and candidate lists are merged."""
        return self.devices[0]

    @property
    def size(self) -> int:
        """Entries of the mesh (the row -> card map's modulus)."""
        return len(self.devices)

    def owner(self, rows):
        """``(card, local row)`` of bucket rows (an int, numpy array or
        tensor)."""
        return rows % self.size, rows // self.size

    def deal(self, a) -> tuple:
        """A ``[rows, ...]`` array's (numpy or tensor) per-card shares, in
        card order: card ``c`` gets rows ``c, c + n, ...``."""
        return tuple(a[c::self.size] for c in range(self.size))

    def split(self, row0: int, n: int):
        """Global rows ``[row0, row0 + n)`` split by owning card: ``[(card,
        local slice, slice of the n rows)]``.  A card's rows in a
        contiguous global range are contiguous locally."""
        out = []
        for sel in self.deal(range(row0, row0 + n)):
            if len(sel):
                card, loc = self.owner(sel[0])
                out.append((card, slice(loc, loc + len(sel)),
                            slice(sel[0] - row0, None, self.size)))
        return out

    def order(self, rows: int) -> np.ndarray:
        """Permutation taking the cards' rows concatenated in card order
        (card 0's local rows, then card 1's, ...) to global row order."""
        return np.argsort(np.concatenate(self.deal(np.arange(rows))),
                          kind="stable")


def make_shard_mesh(n_devices: Optional[int] = None) -> ShardMesh:
    """A :class:`ShardMesh` over (up to) ``n_devices`` distinct CUDA cards,
    all visible cards when ``n_devices`` is None (the reference's
    contract).  Raises like ``resolve_device`` when no card is present;
    build a mesh over named devices with ``ShardMesh(devices)``."""
    if not torch.cuda.is_available():
        resolve_device("cuda:0")                  # raises: no card
    avail = torch.cuda.device_count()
    n = avail if n_devices is None else min(int(n_devices), avail)
    return ShardMesh(tuple(torch.device("cuda", i) for i in range(n)))


def resolve_mesh(device, mesh: Optional[ShardMesh]) -> ShardMesh:
    """The mesh a pack lives on: ``mesh``, whose home ``device`` must then
    name, or a one-entry mesh on ``device`` (default: the card)."""
    if mesh is None:
        return ShardMesh((resolve_device(device),))
    if device is not None and ShardMesh((device,)).home != mesh.home:
        raise ValueError(f"device {str(device)!r} is not the shard mesh's "
                         f"home {str(mesh.home)!r}")
    return mesh


def _put(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def _place_rows(a: np.ndarray, mesh: ShardMesh) -> tuple:
    """A host ``[rows, ...]`` stack dealt out to the mesh's cards."""
    return tuple(_put(p, d) for p, d in zip(mesh.deal(a), mesh.devices))


@dataclasses.dataclass
class ShardPack:
    """Stacked, padded, device-resident shards of a set of sealed segments
    (monolithic layout, rebuilt whole per segment-list generation).
    Deletions between rebuilds are applied with :meth:`mark_dead`
    (metadata sentinel overwrite + lazy re-upload) — no restacking.  The
    device stacks are tuples of per-card rows of ``mesh`` (one entry
    without a shard mesh)."""

    epoch: int
    n_shards: int                    # shards per segment
    m: int                           # metadata dimension
    seg_ids: np.ndarray              # [g] owning segment id per pack row
    t_min: np.ndarray                # [g] owning segment's time span
    t_max: np.ndarray
    x: tuple                         # per card [g_c, cap, d] device stack
    gids_dev: tuple                  # per card [g_c, cap] int32 (-1 pad)
    _s_host: np.ndarray              # [g, cap, m] fp32 host master copy
    _gid_sorted: np.ndarray          # sorted live gids (for mark_dead)
    _gid_flat_pos: np.ndarray        # flat (row*cap + col) per sorted gid
    mesh: ShardMesh
    _s_dev: Optional[tuple] = None

    @property
    def n_rows(self) -> int:
        """Pack rows = segments x shards-per-segment."""
        return int(self._s_host.shape[0])

    @property
    def cap(self) -> int:
        """Padded per-shard point capacity."""
        return int(self._s_host.shape[1])

    @property
    def device(self) -> torch.device:
        """Where queries enter: the mesh's home."""
        return self.mesh.home

    @property
    def nbytes(self) -> int:
        """Device bytes held by the pack (vectors + metadata + gids)."""
        return int(sum(t.numel() for t in self.x) * 4
                   + self._s_host.size * 4
                   + sum(t.numel() for t in self.gids_dev) * 4)

    @property
    def s_dev(self) -> tuple:
        """Device metadata stack, re-uploaded lazily after `mark_dead`."""
        if self._s_dev is None:
            self._s_dev = _place_rows(self._s_host, self.mesh)
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
                     device=None, mesh: Optional[ShardMesh] = None
                     ) -> ShardPack:
    """Partition each segment round-robin into ``n_shards`` shards and
    stack all of them into one padded device pack on ``device`` (default:
    the card), or dealt out to the cards of ``mesh``."""
    n_shards = max(int(n_shards), 1)
    if not sources:
        raise ValueError("build_shard_pack needs at least one segment")
    mesh = resolve_mesh(device, mesh)
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
                     t_min=t_min, t_max=t_max, x=_place_rows(x, mesh),
                     gids_dev=_place_rows(gid, mesh), _s_host=s,
                     _gid_sorted=flat_gid[live][order],
                     _gid_flat_pos=live[order], mesh=mesh)


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
    to tuples of per-card tensors (one entry without a shard mesh):
    device tensors while the bucket is ``resident``, page-locked host
    tensors once it is evicted.  A mutation replaces ``blk``
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
    blk: Dict[str, tuple]
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
        return sum(p.numel() * p.element_size()
                   for t in self.blk.values() for p in t)

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
    ``events`` mark, one per card, each on that card's side stream (None
    on the CPU, where the copy is synchronous)."""

    blk: Dict[str, tuple]
    events: Optional[tuple] = None


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
    the device for one dispatch.  Every block field is a tuple of the
    ``mesh``'s per-card tensors (one entry without a shard mesh; card
    ``c`` holds the rows :meth:`ShardMesh.deal` gives it); :meth:`block`
    assembles one in global row order."""

    cap: int
    gids: tuple
    seg_ids: np.ndarray
    t_min: np.ndarray
    t_max: np.ndarray
    s: tuple
    mesh: ShardMesh
    x: Optional[tuple] = None
    codes: Optional[tuple] = None
    xsq: Optional[tuple] = None
    scales: Optional[tuple] = None
    nbrs: Optional[tuple] = None          # per card [rows_c, cap, degp] int32
    # per-packed-segment graph entry points for the stitched traversal:
    # ((row0, flattened positions), ...) — row0 is the owning slot's first
    # bucket row, so the temporal active mask decides seed inclusion
    entries: Tuple[Tuple[int, np.ndarray], ...] = ()
    resident: bool = True
    stage_bytes: int = 0
    fill: Optional[np.ndarray] = None

    @property
    def n_rows(self) -> int:
        """Allocated rows (live + free) of the bucket."""
        return int(len(self.seg_ids))

    def block(self, name: str) -> Optional[torch.Tensor]:
        """One block field as a single tensor in global row order: the
        one card's tensor, or a mesh's per-card rows interleaved back on
        the home card (on the host for a cold view)."""
        t = getattr(self, name)
        if t is None or len(t) == 1:
            return None if t is None else t[0]
        home = self.mesh.home if self.resident else torch.device("cpu")
        cat = torch.cat([p.to(home) for p in t])
        perm = torch.as_tensor(self.mesh.order(self.n_rows), device=home)
        return cat.index_select(0, perm)

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
    mesh: Optional[ShardMesh] = None      # the pack's (set by view())

    @property
    def n_rows(self) -> int:
        """Total allocated pack rows across buckets."""
        return sum(b.n_rows for b in self.buckets)


_BLOCK_FIELDS = ("gids", "s", "x", "codes", "xsq", "scales", "nbrs")


def stage_bucket(bv: BucketView, device: torch.device,
                 registry=NULL_REGISTRY) -> BucketView:
    """The view a dispatch reads: a resident view as is; a cold view's
    blocks copied to ``device`` (``non_blocking`` from pinned memory, on
    the current stream, so the kernel launched after it reads the copy) —
    each card's rows to that card of the view's mesh, whose home is
    ``device``; their bytes count in ``registry``.  The transient buffer
    is released when the returned view is dropped."""
    if bv.resident:
        return bv
    moved = {name: tuple(p.to(dev, non_blocking=True) for p, dev in
                         zip(getattr(bv, name), bv.mesh.devices))
             for name in _BLOCK_FIELDS if getattr(bv, name) is not None}
    count_h2d(registry, "cold_stage", sum(
        t.numel() * t.element_size() for ts in moved.values() for t in ts))
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

    With a ``mesh`` (:class:`ShardMesh`) each block is a tuple of the
    cards' shares of the rows (:meth:`ShardMesh.owner`); without one it is
    a tuple of one tensor on ``device``.  Every bucket's row count divides
    the mesh's size (:meth:`_init_slots`), so each card holds an equal
    share and doubling appends the same number of rows on every card.
    """

    def __init__(self, n_shards: int, d: int, m: int, epoch: int = 0,
                 cap_multiple: int = 256, quantize: Optional[str] = None,
                 metrics=None, graph_degree: Optional[int] = None,
                 device=None, resident_default: bool = True,
                 mesh: Optional[ShardMesh] = None):
        from ..obs.metrics import NULL_REGISTRY
        self.metrics = NULL_REGISTRY if metrics is None else metrics
        self.mesh = resolve_mesh(device, mesh)
        self.device = self.mesh.home
        self.resident_default = bool(resident_default)
        self.fault_hook = None
        # host copies of a card pack's blocks are page-locked, so a cold
        # dispatch or an admission copies them asynchronously
        self._pin = self.device.type == "cuda"
        # per card: the stream the pack's kernels are launched on (the
        # owner's queries), which waits on every admission's upload event,
        # and the side stream admissions upload on
        self._consumer = (tuple(torch.cuda.current_stream(d)
                                for d in self.mesh.devices)
                          if self._pin else None)
        self._side: Dict[torch.device, object] = {}
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
    def _home(self, resident: bool, card: int) -> torch.device:
        """Where a card's share of a bucket's blocks lives: that card or
        the host."""
        return self.mesh.devices[card] if resident else torch.device("cpu")

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

    def _new_block(self, rows: int, cap: int, resident: bool = True,
                   row0: int = 0) -> Dict[str, object]:
        """Fresh zero / ``PAD_META`` blocks for bucket rows ``[row0, row0 +
        rows)`` in the pack's layout, plus the adjacency block when the
        graph read path is on — on the device (each card's share of the
        rows on that card), or page-locked on the host for a cold
        bucket."""
        per_card = {c: loc.stop - loc.start
                    for c, loc, _ in self.mesh.split(row0, rows)}
        cards = []
        for c in range(self.mesh.size):
            home = self._home(resident, c)
            layout = block_layout(self.mode, per_card.get(c, 0), cap,
                                  self.d, self.m)
            if self.graph_degree:
                layout["nbrs"] = ((per_card.get(c, 0), cap, self.degp),
                                  torch.int32, -1)
            cards.append({name: self._own(resident, torch.full(
                              shape, fill, dtype=dtype, device=home))
                          for name, (shape, dtype, fill) in layout.items()})
        return {name: tuple(blk[name] for blk in cards) for name in cards[0]}

    def _init_slots(self) -> int:
        """Slot count of a fresh bucket: the smallest whose row total
        divides the mesh's size, so every card holds an equal share of
        the rows for any ``n_shards`` (doubling keeps it so).  1 without
        a mesh."""
        nd = self.mesh.size
        return nd // math.gcd(self.n_shards, nd)

    def _bucket_for(self, cap: int) -> _Bucket:
        b = self.buckets.get(cap)
        if b is None:
            slots = self._init_slots()
            rows = slots * self.n_shards
            res = self.resident_default
            b = _Bucket(cap, seg_ids=np.full(rows, -1, np.int64),
                        t_min=np.full(rows, np.inf, np.float64),
                        t_max=np.full(rows, -np.inf, np.float64),
                        free_slots=list(range(slots)),
                        gids_h=np.full((rows, cap), -1, np.int32),
                        blk=self._new_block(rows, cap, res), resident=res)
            self.buckets[cap] = b
        return b

    def _alloc_slot(self, b: _Bucket) -> int:
        """Pop the lowest free slot, doubling the block when none is left
        (geometric growth keeps appends amortized O(changed segment)); on
        a mesh each card appends its share of the new rows."""
        if not b.free_slots:
            old_slots = b.n_rows // self.n_shards
            add_rows = old_slots * self.n_shards
            add = self._new_block(add_rows, b.cap, b.resident,
                                  row0=b.n_rows)
            b.blk = {name: tuple(self._own(b.resident, torch.cat([p, a]))
                                 for p, a in zip(t, add[name]))
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
        blk = dict(b.blk)
        split = self.mesh.split(row0, self.n_shards)
        for name, block in staged.items():
            parts = list(blk[name])
            for c, loc, sel in split:
                t = self._clone(b, parts[c])
                t[loc] = _put(block[sel], self._home(b.resident, c))
                parts[c] = t
            blk[name] = tuple(parts)
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
            card, loc = self.mesh.owner(rows)
            parts = list(b.blk["s"])
            for c in np.unique(card):
                sel = card == c
                home = self._home(b.resident, int(c))
                s = self._clone(b, parts[c])
                s[_put(loc[sel], home), _put(cols[sel], home)] = PAD_META
                parts[c] = s
            b.blk = dict(b.blk, s=tuple(parts))
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
            hs = []
            for p in t:
                h = torch.empty(p.shape, dtype=p.dtype, pin_memory=self._pin)
                h.copy_(p)
                hs.append(h)
            host[name] = tuple(hs)
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
        staged page-locked blocks to the devices, each card's rows to that
        card on its side stream, and record an event per card at the end
        of its copies.  Returns ``(gen, upload)`` for
        :meth:`install_admission`.  Fault point ``admission.upload`` fires
        first — a crash strands nothing (the host copy still lives in the
        bucket)."""
        self._fault("admission.upload")
        gen, blocks = staged
        devices = self.mesh.devices
        if not self._pin:
            return gen, _Upload({name: tuple(
                p.to(dev, copy=True) for p, dev in zip(t, devices))
                for name, t in blocks.items()})
        cards, events = [], []
        for c, dev in enumerate(devices):
            side = self._side.get(dev)
            if side is None:
                side = self._side[dev] = torch.cuda.Stream(dev)
            with torch.cuda.stream(side):
                cards.append({name: t[c].to(dev, non_blocking=True)
                              for name, t in blocks.items()})
                event = torch.cuda.Event()
                event.record(side)
            events.append(event)
        return gen, _Upload({name: tuple(blk[name] for blk in cards)
                             for name in blocks}, tuple(events))

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
        if upload.events is not None:
            for c, event in enumerate(upload.events):
                self._consumer[c].wait_event(event)
                for t in upload.blk.values():
                    t[c].record_stream(self._consumer[c])
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
                          s=blk["s"], mesh=self.mesh, x=blk.get("x"),
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
                        host_nbytes=self.host_nbytes, device=self.device,
                        mesh=self.mesh)


def build_bucketed_pack(sources: Sequence[SegmentShardSource], n_shards: int,
                        epoch: int = 0, cap_multiple: int = 256,
                        quantize: Optional[str] = None, metrics=None,
                        graph_degree: Optional[int] = None,
                        device=None, resident_default: bool = True,
                        mesh: Optional[ShardMesh] = None
                        ) -> BucketedShardPack:
    """Cold-build a :class:`BucketedShardPack`: the same
    :meth:`~BucketedShardPack.add_segment` delta applied once per
    segment, so an incrementally maintained pack and a from-scratch build
    of the same segments answer identically.  ``resident_default=False``
    builds every bucket in host memory (no device upload): a budgeted
    tier then admits only the buckets that fit.  ``mesh`` spreads the
    bucket rows over its cards."""
    if not sources:
        raise ValueError("build_bucketed_pack needs at least one segment")
    pack = BucketedShardPack(n_shards, sources[0].x.shape[1],
                             sources[0].s.shape[1], epoch=epoch,
                             cap_multiple=cap_multiple, quantize=quantize,
                             metrics=metrics, graph_degree=graph_degree,
                             device=device,
                             resident_default=resident_default, mesh=mesh)
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


def _shard_lists(ids, dd, gid_stack):
    """Shard-local ``(ids, dists) [g, b, k']`` -> ``(gids int64, dists)``
    with misses at ``+inf``, on the device that scanned them."""
    g, b, kk = ids.shape
    gl = torch.gather(gid_stack.long(), 1,
                      ids.long().clamp_min(0).reshape(g, b * kk))
    return gl.reshape(g, b, kk), torch.where(ids >= 0, dd, float("inf"))


def _merge_lists(gl, dd, active, k: int):
    """Per-row ``(gids, dists) [g, b, k']`` in global row order -> exact
    global ``(gids, dists) [b, k]``.  Inactive rows are masked to +inf
    before one stable sort over the concatenated shard axis (ties keep
    the lower position, the order of the reference's ``top_k``)."""
    g, b, kk = gl.shape
    dd = torch.where(active[:, None, None], dd, float("inf"))
    alld = dd.permute(1, 0, 2).reshape(b, g * kk)
    allg = gl.permute(1, 0, 2).reshape(b, g * kk)
    sd, sel = torch.sort(alld, dim=1, stable=True)
    out_d = sd[:, :k]
    out_g = torch.gather(allg, 1, sel[:, :k])
    return torch.where(torch.isfinite(out_d), out_g, -1), out_d


def _card_lists(mesh: ShardMesh, rows: int, active: np.ndarray, launch,
                registry=NULL_REGISTRY):
    """Run ``launch(card) -> [(gids, dists) [rows_c, b, k'], ...]`` on the
    one card of a one-entry mesh, or on every mesh card holding an active
    row — all launches queued before any result is read — and bring each
    card's lists to the home card in global row order (the order the
    merge breaks ties by).  A card without an active row contributes
    misses.  Returns the list of ``(gids, dists) [rows, b, k']``; the row
    order's copy to the home card counts in ``registry``."""
    if mesh.size == 1:
        return launch(0)
    home = mesh.home
    want = [bool(a.any()) for a in mesh.deal(active)]
    if not any(want):                 # nothing active: scan as one card
        want = [len(r) > 0 for r in mesh.deal(range(rows))]
    outs = [launch(c) if w else None for c, w in enumerate(want)]
    ref = next(o for o in outs if o is not None)
    order = mesh.order(rows)
    perm = torch.as_tensor(order, device=home)
    count_h2d(registry, "other", order.nbytes)
    merged = []
    for j, (g0, _) in enumerate(ref):
        gls, dds = [], []
        for c, o in enumerate(outs):
            if o is None:
                shape = (len(mesh.deal(range(rows))[c]), *g0.shape[1:])
                gls.append(torch.full(shape, -1, dtype=torch.long,
                                      device=home))
                dds.append(torch.full(shape, float("inf"), device=home))
            else:
                # a copy off card c runs on c's current stream after the
                # kernels queued there, and home's stream waits for it
                gls.append(o[j][0].to(home, non_blocking=True))
                dds.append(o[j][1].to(home, non_blocking=True))
        merged.append((torch.cat(gls).index_select(0, perm),
                       torch.cat(dds).index_select(0, perm)))
    return merged


def _card_queries(mesh: ShardMesh, q: torch.Tensor) -> list:
    """The query tensor on each card (sent once, non-blocking; the home
    card's is ``q`` itself)."""
    return [q.to(dev, non_blocking=True) for dev in mesh.devices]


def _scan_lists(bv: "BucketView", c: int, q, filt, kk: int, metric: str,
                m: int, registry=NULL_REGISTRY):
    """Card ``c``'s scan of a bucket: B3 over its int8 codes or B1 over
    its fp32 rows, turned into ``(gids, dists)`` on that card (the
    launch's filter parameters count in ``registry``)."""
    def part(name):
        return getattr(bv, name)[c]
    if bv.quantized:
        ids, dd = sharded_quant_filtered_topk(
            q, part("codes"), part("s"), part("xsq"), part("scales"), filt,
            kk, metric=metric, m=m, registry=registry)
    else:
        ids, dd = sharded_filtered_topk(q, part("x"), part("s"), filt, kk,
                                        metric=metric, m=m, registry=registry)
    return [_shard_lists(ids, dd, part("gids"))]


def pack_search_blocks(view: PackView, queries: np.ndarray,
                       filt: Optional[Filter], k: int,
                       t_lo: float = -np.inf, t_hi: float = np.inf,
                       metric: str = "l2", trace=None, observe=None,
                       on_cold=None, registry=None
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One fused-kernel launch per non-empty, temporally unpruned bucket.

    A bucket whose segment spans all miss ``[t_lo, t_hi]`` is skipped
    entirely.  Each fp32 bucket contributes one exact ``(gids [b, k_b],
    dists [b, k_b])`` candidate block for the caller's exact ``(gid,
    dist)`` merge; quantized buckets launch B3 instead and their blocks
    carry distances to the dequantized vectors — the caller over-fetches
    (``k = rerank_multiple * final_k``) and reranks the union exactly at
    fp32 (``repro_torch.quant.rerank_exact``).

    ``trace`` opens a ``queries_upload`` span around the queries' copy
    and one ``bucket_dispatch`` span per dispatched bucket, stopped only
    after the bucket's device results are ready, with a ``bucket_fetch``
    child around the active mask's copy, the merge of the shard lists and
    the copy back (the host's wait on the bucket's kernels);
    ``observe`` (``BucketStats.observe``) receives one observation per
    bucket — ``cache_hit`` meaning the scan kernel was already loaded.
    ``registry`` counts every copy to the device (``h2d_bytes_total``).

    A cold bucket (``resident=False``) is copied to the view's device for
    its dispatch (:func:`stage_bucket`) and scanned by the same kernel at
    the same shapes, so its answers are the resident block's bit for bit;
    ``on_cold(cap, stage_bytes)`` fires once per dispatched cold bucket
    (tier-miss accounting).

    On a shard mesh each card holding an active row scans its own rows
    (:func:`_card_lists`) and the merge on the home card reads the lists
    in global row order, so the answers are one card's bit for bit."""
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    trace = NULL_TRACE if trace is None else trace
    registry = NULL_REGISTRY if registry is None else registry
    want_obs = observe is not None or trace.enabled
    blocks: List[Tuple[np.ndarray, np.ndarray]] = []
    q = None
    for bv in view.buckets:
        active = bv.active_rows(t_lo, t_hi)
        rows = bv.n_rows
        n_active = int(active.sum())
        if n_active == 0:
            if observe is not None:       # whole-block temporal prune
                observe(bv.cap, rows=rows, active_rows=0)
            continue
        dev = view.device
        cold = not bv.resident
        if cold and on_cold is not None:
            on_cold(bv.cap, bv.stage_bytes)
        if q is None or q[0].device != dev:
            with trace.span("queries_upload"):
                q = _card_queries(view.mesh, torch.as_tensor(queries,
                                                              device=dev))
            count_h2d(registry, "scan_queries", queries.nbytes)
        kk = min(k, bv.cap)               # per-shard list length
        # merged width: for k > cap the per-shard lists (= whole shards)
        # still hold up to rows * kk candidates, so the top-k stays exact
        k_out = min(k, rows * kk)
        mode = "int8" if bv.quantized else "fp32"
        cache_hit = kernels_loaded(mode) if want_obs else False
        with trace.span("bucket_dispatch", cap=bv.cap, rows=rows,
                        active_rows=n_active, k_out=k_out,
                        quantized=bv.quantized, resident=not cold) as sp:
            bv = stage_bucket(bv, dev, registry)
            (gl, dl), = _card_lists(
                view.mesh, rows, active,
                lambda c: _scan_lists(bv, c, q[c], filt, kk, metric,
                                      view.m, registry), registry)
            with trace.span("bucket_fetch"):
                out_g, out_d = _merge_lists(
                    gl, dl, torch.as_tensor(active, device=dev), k_out)
                count_h2d(registry, "other", active.nbytes)
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
                               fault=None, observe_group=None,
                               registry=None
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
    group (per-tenant ``BucketStats``).  ``trace`` and ``registry`` see
    the spans and copies :func:`pack_search_blocks` opens and counts, a
    ``queries_upload`` per bucket that first meets a group.  Returns one
    candidate-block list per group (a dropped group keeps the blocks
    gathered before its deadline passed)."""
    trace = NULL_TRACE if trace is None else trace
    registry = NULL_REGISTRY if registry is None else registry
    groups = [(np.atleast_2d(np.asarray(q, np.float32)), f, int(k),
               float(t_lo), float(t_hi)) for q, f, k, t_lo, t_hi in groups]
    want_obs = (observe is not None or observe_group is not None
                or trace.enabled)
    blocks: List[List[Tuple[np.ndarray, np.ndarray]]] = \
        [[] for _ in groups]
    expired = [False] * len(groups)
    buckets = list(view.buckets)
    dev = view.device
    qt: Dict[int, list] = {}
    for bi, bv in enumerate(buckets):
        if deadlines is not None:
            for gi, dl in enumerate(deadlines):
                if not expired[gi] and dl is not None and dl.expired():
                    expired[gi] = True
                    if on_expired is not None:
                        on_expired(gi, len(buckets) - bi)
        rows = bv.n_rows
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
        union = np.logical_or.reduce([actives[gi] for gi in live])
        union_active = int(union.sum())
        cache_hit = kernels_loaded("fp32") if want_obs else False
        with trace.span("bucket_dispatch_grouped", cap=bv.cap, rows=rows,
                        active_rows=union_active, n_groups=len(live),
                        resident=not cold) as sp:
            bv = stage_bucket(bv, dev, registry)
            if any(gi not in qt for gi in live):
                with trace.span("queries_upload"):
                    for gi in live:
                        if gi not in qt:
                            qt[gi] = _card_queries(view.mesh, torch.as_tensor(
                                groups[gi][0], device=dev))
                            count_h2d(registry, "scan_queries",
                                      groups[gi][0].nbytes)

            def launch(c, bv=bv, live=live):
                sub = [(qt[gi][c], groups[gi][1], min(groups[gi][2], bv.cap))
                       for gi in live]
                results = sharded_filtered_topk_grouped(
                    sub, bv.x[c], bv.s[c], metric=metric, m=view.m,
                    registry=registry)
                gids = bv.gids[c]
                return [_shard_lists(ids, dd, gids) for ids, dd in results]
            lists = _card_lists(view.mesh, rows, union, launch, registry)
            merged = []
            with trace.span("bucket_fetch"):
                for (gl, dl), gi in zip(lists, live):
                    kk = min(groups[gi][2], bv.cap)
                    k_out = min(groups[gi][2], rows * kk)
                    out_g, out_d = _merge_lists(
                        gl, dl, torch.as_tensor(actives[gi], device=dev),
                        k_out)
                    count_h2d(registry, "other", actives[gi].nbytes)
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
                on_cold=None, registry=None) -> Tuple[np.ndarray, np.ndarray]:
    """Fan one query batch out over every active shard of the pack and
    merge the shard-local top-k exactly.

    ``pack`` is a :class:`ShardPack`, a :class:`BucketedShardPack` or a
    :class:`PackView`.  A quantized pack also needs ``lookup(gids) -> (x,
    s, present)`` (the manager's point-store getter) for the exact fp32
    rerank of its over-fetched (``rerank_multiple * k``) candidates.
    Returns ``(gids [b, k] int64, dists [b, k] fp32)`` with ``-1`` /
    ``+inf`` padding.  ``registry`` counts the copies to the device and
    the rerank's candidates and rows."""
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    b = queries.shape[0]
    trace = NULL_TRACE if trace is None else trace
    registry = NULL_REGISTRY if registry is None else registry
    if isinstance(pack, (BucketedShardPack, PackView)):
        view = pack.view() if isinstance(pack, BucketedShardPack) else pack
        quantized = view.quantize is not None
        k_fetch = max(k * max(int(rerank_multiple), 1), k) if quantized \
            else k
        blocks = pack_search_blocks(view, queries, filt, k_fetch, t_lo=t_lo,
                                    t_hi=t_hi, metric=metric, trace=trace,
                                    observe=observe, on_cold=on_cold,
                                    registry=registry)
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
                                   device=view.device, trace=trace,
                                   registry=registry)
                sp.annotate(candidates=int((out[0] >= 0).sum()))
            return out
        d = np.concatenate([bd for _, bd in blocks], axis=1)
        return host_topk(g, d, k)
    kk = min(k, pack.cap)                 # per-shard list length
    k_out = min(k, pack.n_rows * kk)
    with trace.span("pack_dispatch", rows=pack.n_rows, cap=pack.cap,
                    k_out=k_out):
        dev = pack.device
        active = pack.active_rows(t_lo, t_hi)
        qs = _card_queries(pack.mesh, torch.as_tensor(queries, device=dev))
        count_h2d(registry, "scan_queries", queries.nbytes)
        if pack._s_dev is None:           # re-uploaded after mark_dead
            count_h2d(registry, "other", pack._s_host.nbytes)
        xs, ss, gs = pack.x, pack.s_dev, pack.gids_dev

        def launch(c):
            ids, dd = sharded_filtered_topk(qs[c], xs[c], ss[c], filt, kk,
                                            metric=metric, m=pack.m,
                                            registry=registry)
            return [_shard_lists(ids, dd, gs[c])]
        (gl, dl), = _card_lists(pack.mesh, pack.n_rows, active, launch,
                                registry)
        out_g, out_d = _merge_lists(gl, dl, torch.as_tensor(active,
                                                            device=dev),
                                    k_out)
        count_h2d(registry, "other", active.nbytes)
        block_ready((out_g, out_d))
    gids = np.full((b, k), -1, np.int64)
    dists = np.full((b, k), np.inf, np.float32)
    gids[:, :k_out] = out_g.cpu().numpy()
    dists[:, :k_out] = out_d.cpu().numpy()
    return gids, dists
