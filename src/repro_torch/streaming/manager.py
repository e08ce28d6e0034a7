"""Segment lifecycle: seal policy, off-path compaction, TTL/retention expiry.

``SegmentManager`` owns the delta buffer, the ordered list of sealed
segments, a per-gid liveness bitmap, and a chunked :class:`PointStore`
ledger (off the query hot path, garbage-collected chunk-wise as points
retire).

Lifecycle (all event-time — "now" is the max timestamp ingested so far,
so replayed histories behave identically to live streams)::

  ingest -> delta buffer -> [seal policy] -> sealed CubeGraphIndex segment
         -> [compaction]  -> merged/GC'd segments
         -> [retention]   -> whole-segment O(1) drop

Compaction consistency (the epoch guarantee)
--------------------------------------------
Compaction is split into ``plan`` (cheap, under the manager lock) /
``execute`` (expensive index rebuilds, lock-free, off-thread via
:meth:`SegmentManager.compact_async`) / ``publish`` (atomic swap under the
lock).  Every mutation of the segment *list* bumps ``epoch``; queries take
a snapshot ``(epoch, segments)`` under the lock and run entirely against
it, so an in-flight query never observes a half-merged list.  At publish
time, deletions that landed while a replacement segment was being built
are re-applied to it before the swap, and the query path additionally
filters its merged result through the liveness bitmap — so a point deleted
before a query began is never returned.

Sharded read path: with ``StreamConfig(n_shards >= 1)`` the sealed
segments are also kept in a size-bucketed device pack
(``repro_torch.distributed.segment_shards``), maintained by
O(changed-segment) deltas at every seal / publish / expiry under the lock
(``_apply_pack_delta``); queries search an immutable view of it, in fp32
(kernel B1), int8 with an exact rerank (``quantize="int8"``, kernel B3)
or by stitched graph traversal chosen per bucket by the cost planner
(``read_path="graph"|"auto"``, kernel B4).

Durability (``persist_dir``, :meth:`SegmentManager.snapshot_to`,
:meth:`SegmentManager.restore`; ``streaming/persistence.py``): every
ingest / delete / point-store GC is WAL-logged before it mutates anything,
and every segment-list transition checkpoints segment artifacts and an
atomic manifest in the JAX package's on-disk format.

Tiered storage (``device_budget_bytes``; ``streaming/tiering.py``): the
bucketed pack keeps at most that many CUDA bytes of bucket blocks
resident; the coldest buckets live in page-locked host memory and stream
through the same kernels per dispatch, so answers stay the all-resident
ones bit for bit.

Resilience (``streaming/resilience.py``): a ``FaultInjector`` installed
with :meth:`SegmentManager.install_fault_injector` fires at the eleven
named fault points (WAL, checkpoint, pack delta, the admission trio,
prefetch, compaction, the deadline path's per-bucket dispatch); background
workers run under a ``Supervisor`` that records every failure in
``stats()["health"]``.

Grouped queries (:meth:`SegmentManager.query_grouped`) answer several
heterogeneous request groups in one pass, sharing each sealed bucket's
device block across the groups (one kernel launch per filter class).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core import CubeGraphConfig, Filter
from .segments import DeltaBuffer, PointStore, SealedSegment, grow_rows

__all__ = ["CompactionPlan", "StreamConfig", "SegmentManager"]


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Policy knobs for the streaming lifecycle (the reference's fields and
    defaults; see ``SegmentManager`` for which options are ported)."""

    time_dim: int = -1                    # metadata column holding time
    seal_max_points: int = 2048           # seal delta at this many live points
    seal_max_age: float = math.inf        # ... or when its span exceeds this
    # Retention is segment-granular for sealed data: a segment drops (O(1))
    # only once its *entire* span [t_min, t_max] is older than now - ttl, so
    # a straddling segment retains its older points until it ages out or is
    # compacted.  Delta-buffer stragglers are masked point-wise.
    ttl: float = math.inf
    compact_max_segments: int = 8         # merge adjacent pairs above this
    compact_deleted_fraction: float = 0.3  # GC a segment above this
    # Sealed-segment read path: 0 = per-segment stitched-graph beam search;
    # >= 1 = partition each sealed segment into this many shards and scan
    # the size-bucketed pack with the fused kernel (exact; on one card the
    # shard axis is the kernels' batch axis).
    n_shards: int = 0
    # True: the bucketed pack, updated by O(changed-segment) deltas;
    # False: the monolithic pack, rebuilt whole on every epoch bump.
    incremental_pack: bool = True
    pack_cap_multiple: int = 256          # bucket row-capacity quantum
    # "int8" (requires n_shards >= 1 and incremental_pack): per-dimension
    # scales fit at seal / compaction, int8 codes on the card, an
    # over-fetching kernel scan and an exact fp32 rerank.
    quantize: Optional[str] = None
    rerank_multiple: int = 4              # quantized over-fetch factor
    # "scan" always scans; "graph" / "auto" (require n_shards >= 1 and
    # incremental_pack) also stage each segment's graph into the pack and
    # traverse it — forced, or where the cost planner prices it cheaper.
    read_path: str = "scan"
    planner_costs: Optional[object] = None  # PlannerCosts override
    graph_ef: int = 128                   # traversal beam width
    graph_width: int = 8                  # expansions per traversal hop
    graph_max_iters: int = 256            # traversal hop budget
    # Build and load the pack's kernels at seal / publish time (off the
    # query path).
    pack_warm_compile: bool = True
    # Tiered storage (requires n_shards >= 1 and incremental_pack): at
    # most this many CUDA bytes of bucket blocks stay resident; the rest
    # live in page-locked host memory and stream per dispatch.
    device_budget_bytes: Optional[int] = None
    tier_window_history: int = 12         # query windows kept for drift
    # Stage cold buckets the predicted next query window touches, on a
    # supervised background thread after each sharded query.
    tier_prefetch: bool = True
    # Observability: lifecycle/query counters and latency histograms.
    obs_enabled: bool = True
    # Query deadline: checked between segment searches; on overrun the
    # partial answer comes back marked ``degraded=True``.  None = unbounded.
    query_deadline_ms: Optional[float] = None
    store_chunk: int = 4096               # PointStore GC granularity (rows)
    # Durability: WAL-log every ingest / delete / GC and checkpoint at each
    # segment-list transition, so SegmentManager.restore(persist_dir)
    # recovers a crashed replica.
    persist_dir: Optional[str] = None
    wal_fsync_every: int = 32             # WAL appends between fsyncs
    mmap_segments: bool = True            # restore x/s via np.load(mmap_mode)
    index_cfg: CubeGraphConfig = dataclasses.field(
        default_factory=CubeGraphConfig)


@dataclasses.dataclass
class CompactionPlan:
    """One compaction round, planned against a segment-list snapshot.

    ``gc`` segments are rewritten in place (lazy-deletion reclamation);
    each ``merges`` group of adjacent segments collapses into one.  The
    plan pins the ``epoch`` it was made at; ``publish`` drops any operation
    whose victims have left the list since (expired or already replaced).
    """

    epoch: int
    gc: List[SealedSegment]
    merges: List[List[SealedSegment]]
    drop_empty: bool = False

    @property
    def n_ops(self) -> int:
        """Rewrite operations this plan will perform if fully applied."""
        return len(self.gc) + sum(len(g) - 1 for g in self.merges)


class SegmentManager:
    """LSM-style lifecycle manager over DeltaBuffer + SealedSegments.

    Thread-safety: all list/ledger mutations take ``_lock``; reads snapshot
    under the lock and run lock-free (see the module docstring for the
    compaction epoch guarantee).  Indexes and scans run on ``device``
    (default: the card).  ``shard_mesh`` (optional, a ``ShardMesh`` from
    ``repro_torch.distributed.make_shard_mesh``) spreads the sharded read
    path's bucket rows over its cards; the delta buffer, the indexes of
    unsharded segments and the merges stay on its home card, which is
    ``device`` (the two must agree when both are given).
    """

    def __init__(self, d: int, m: int, cfg: StreamConfig = StreamConfig(),
                 device=None, shard_mesh=None, _restoring: bool = False):
        self.d = int(d)
        self.m = int(m)
        self.cfg = cfg
        if cfg.quantize is not None:
            from ..quant import QUANT_KINDS
            if cfg.quantize not in QUANT_KINDS:
                raise ValueError(f"unknown quantize kind {cfg.quantize!r}; "
                                 f"supported: {QUANT_KINDS}")
            if cfg.n_shards < 1:
                raise ValueError("quantize requires the sharded read path "
                                 "(StreamConfig.n_shards >= 1)")
            if not cfg.incremental_pack:
                raise ValueError("quantize requires incremental_pack=True "
                                 "(the monolithic pack is fp32-only)")
        if cfg.read_path not in ("scan", "graph", "auto"):
            raise ValueError(f"unknown read_path {cfg.read_path!r}; "
                             "supported: 'scan' | 'graph' | 'auto'")
        if cfg.read_path != "scan":
            if cfg.n_shards < 1:
                raise ValueError("read_path='graph'/'auto' requires the "
                                 "sharded read path (n_shards >= 1)")
            if not cfg.incremental_pack:
                raise ValueError("read_path='graph'/'auto' requires "
                                 "incremental_pack=True (graph blocks ride "
                                 "the bucketed pack)")
        if cfg.device_budget_bytes is not None:
            if cfg.device_budget_bytes < 0:
                raise ValueError("device_budget_bytes must be >= 0")
            if cfg.n_shards < 1 or not cfg.incremental_pack:
                raise ValueError("device_budget_bytes requires the sharded "
                                 "incremental pack (n_shards >= 1, "
                                 "incremental_pack=True) — residency is a "
                                 "bucketed-pack concept")
        if shard_mesh is not None and cfg.n_shards < 1:
            raise ValueError("shard_mesh requires the sharded read path "
                             "(StreamConfig.n_shards >= 1)")
        from ..distributed.segment_shards import resolve_mesh
        self.device = resolve_mesh(device, shard_mesh).home
        self.shard_mesh = shard_mesh
        self.time_dim = cfg.time_dim % m
        self.delta = DeltaBuffer(d, m, self.time_dim,
                                 capacity=min(cfg.seal_max_points, 4096),
                                 device=self.device)
        self.segments: List[SealedSegment] = []     # ordered by t_min
        self.epoch = 0                              # segment-list generation
        self._lock = threading.RLock()
        self._next_seg_id = 0
        self._compact_thread: Optional[threading.Thread] = None
        # Cached device pack for the sharded read path: a BucketedShardPack
        # kept in sync by _apply_pack_delta at every segment-list
        # transition (or a monolithic ShardPack rebuilt per epoch with
        # incremental_pack off).  None until the first sharded query
        # cold-builds it.
        self._pack = None
        # Most recent {cap: PlanDecision} of the cost planner
        # (read_path != "scan" only).
        self.last_plan = None
        # running count of query batches: a traced batch's id
        self._batch_seq = itertools.count()
        self.store = PointStore(d, m, chunk=cfg.store_chunk)
        self._alive = np.zeros(1024, bool)
        self.now = -math.inf                        # event-time watermark
        self.counters = {"sealed": 0, "compactions": 0, "expired_segments": 0,
                         "expired_points": 0, "deleted": 0,
                         "store_gc_points": 0}
        from ..obs import StreamObs
        self.obs = StreamObs(enabled=cfg.obs_enabled)
        # the Supervisor owns every background worker (compactor,
        # prefetcher, checkpointer); fault_injector is None in production
        # and a FaultInjector under a chaos harness
        from .resilience import Supervisor
        self.supervisor = Supervisor(registry=self.obs.registry)
        self.fault_injector = None
        # Tiered storage: TierState owns the budget and the query-window
        # history; the manager serializes every evict / admit under _lock.
        self.tier = None
        self._prefetch_thread: Optional[threading.Thread] = None
        if cfg.device_budget_bytes is not None:
            from .tiering import TierState
            self.tier = TierState(cfg.device_budget_bytes,
                                  registry=self.obs.registry,
                                  window_history=cfg.tier_window_history)
        self.persist = None                         # StreamPersistence
        self._suspend_ckpt = False                  # batched seals in ingest
        if cfg.persist_dir and not _restoring:
            from .persistence import MANIFEST_NAME, StreamPersistence
            if os.path.exists(os.path.join(cfg.persist_dir, MANIFEST_NAME)):
                raise ValueError(
                    f"{cfg.persist_dir!r} already holds a snapshot — use "
                    "SegmentManager.restore(...) to resume it")
            self.persist = StreamPersistence(cfg.persist_dir,
                                             cfg.wal_fsync_every,
                                             metrics=self.obs.registry)
            # publish an (empty) manifest at once, so the directory is
            # restorable even after a crash before the first seal
            self.persist.checkpoint(self)

    # ------------------------------------------------------------------
    # Resilience: fault points + supervised workers
    # ------------------------------------------------------------------
    def _fault(self, point: str) -> None:
        """Fire one named fault point when an injector is installed (the
        production path is a single None check)."""
        inj = self.fault_injector
        if inj is not None:
            inj(point)

    def install_fault_injector(self, inj) -> None:
        """Thread a :class:`~.resilience.FaultInjector` (or None to
        uninstall) through every fault point this manager owns: the WAL
        (``wal.append`` / ``wal.fsync``), checkpoint artifacts
        (``segment.write`` / ``manifest.rename``), the pack's admission
        trio, and the lifecycle points (``pack.delta`` /
        ``prefetch.round`` / ``compaction.execute`` / ``query.bucket``)."""
        with self._lock:
            self.fault_injector = inj
            if self._pack is not None:
                self._pack.fault_hook = inj
            if self.persist is not None:
                self.persist.fault_hook = inj
                if self.persist.wal is not None:
                    self.persist.wal.fault_hook = inj

    def checkpoint_async(self) -> Optional[threading.Thread]:
        """Run a durable checkpoint on the supervised ``checkpointer``
        worker (at most one alive); a failing checkpoint is retried with
        backoff and lands in ``stats()["health"]``.  Returns the thread,
        or None without persistence attached."""
        if self.persist is None:
            return None

        def _ckpt():
            with self._lock:
                self.persist.checkpoint(self)
        return self.supervisor.spawn("checkpointer", _ckpt)

    # ------------------------------------------------------------------
    # Liveness ledger / point store
    # ------------------------------------------------------------------
    @property
    def n_total(self) -> int:
        """Global ids handed out so far (monotone)."""
        return self.store.n_total

    @property
    def alive(self) -> np.ndarray:
        """Liveness per global id (False once deleted or expired)."""
        return self._alive[: self.n_total]

    @property
    def n_live(self) -> int:
        """Number of live points across the delta buffer and all segments."""
        return int(self.alive.sum())

    def get_points(self, gids: Sequence[int]):
        """(x, s, present) rows from the ledger — ``present`` is False for
        ids whose store chunk was garbage-collected."""
        return self.store.get(gids)

    def gc_store(self) -> int:
        """Free point-store chunks with no live id left; returns #rows.
        WAL-logged (with persistence attached), so restore replays the
        same chunk frees."""
        with self._lock:
            dead = self.store.dead_chunks(self.alive)
            if self.persist is not None and len(dead):
                self.persist.log_gc(dead)         # log-before-mutate
            freed = self.store.free_chunks(dead)
            self.counters["store_gc_points"] += freed
        return freed

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------
    def ingest(self, x: np.ndarray, s: np.ndarray) -> np.ndarray:
        """Append a batch; returns assigned global ids.  The batch is fed to
        the delta buffer in seal-policy-sized chunks, so a bulk load larger
        than ``seal_max_points`` seals into several time-ordered segments
        instead of one oversized one."""
        x = np.atleast_2d(np.asarray(x, np.float32))
        s = np.atleast_2d(np.asarray(s, np.float64))
        n_add = x.shape[0]
        with self._lock:
            epoch0 = self.epoch
            # log-before-mutate: a failed WAL append rolls back in the log
            # and leaves the manager untouched
            if self.persist is not None and n_add:
                self.persist.log_ingest(self.store.n_total, x, s)
            gids = self.store.append(x, s)
            self._alive = grow_rows(self.n_total, (self._alive, False))[0]
            self._alive[gids] = True
            self.now = max(self.now, float(s[:, self.time_dim].max()))
            self.obs.registry.counter(
                "lifecycle_ingested_points_total").inc(n_add)
            # one checkpoint at the end of the batch, so a seal mid-loop
            # never captures a half-appended delta buffer
            self._suspend_ckpt = True
            try:
                lo = 0
                while lo < n_add:
                    room = max(self.cfg.seal_max_points - self.delta.n_live,
                               1)
                    take = min(room, n_add - lo)
                    self.delta.append(x[lo:lo + take], s[lo:lo + take],
                                      gids[lo:lo + take])
                    lo += take
                    self.maybe_seal()
            finally:
                self._suspend_ckpt = False
            if self.persist is not None and self.epoch != epoch0:
                self.persist.checkpoint(self)
        return gids

    def _apply_ingest(self, x: np.ndarray, s: np.ndarray) -> np.ndarray:
        """WAL-replay ingest: store / liveness / delta updates with no
        logging and no sealing (restore reproduces the last manifest's
        segmentation; an over-full delta seals on the next live
        ingest)."""
        gids = self.store.append(x, s)
        self._alive = grow_rows(self.n_total, (self._alive, False))[0]
        self._alive[gids] = True
        self.now = max(self.now, float(s[:, self.time_dim].max()))
        self.delta.append(x, s, gids)
        return gids

    def delete(self, gids: Sequence[int]) -> int:
        """Lazy delete by global id, wherever each point lives."""
        gids = np.asarray(gids, np.int64)
        with self._lock:
            live = gids[self._alive[gids]]
            if len(live) == 0:
                return 0
            if self.persist is not None:     # log-before-mutate
                self.persist.log_delete(live)
            hits = self._apply_delete(live)
            if self._pack is not None:
                self._pack.mark_dead(live)
        return hits

    def _apply_delete(self, live: np.ndarray) -> int:
        """Shared core of :meth:`delete` and WAL replay: flip liveness and
        lazily delete from the delta buffer and every sealed segment."""
        live = live[self._alive[live]]
        if len(live) == 0:
            return 0
        self._alive[live] = False
        hits = self.delta.delete(live)
        for seg in self.segments:
            hits += seg.delete(live)
        self.counters["deleted"] += hits
        self.obs.registry.counter("lifecycle_deleted_points_total").inc(
            len(live))
        return hits

    # ------------------------------------------------------------------
    # Seal policy
    # ------------------------------------------------------------------
    def should_seal(self) -> bool:
        """Whether the delta buffer is due to freeze into a segment."""
        if self.delta.n_live >= self.cfg.seal_max_points:
            return True
        return (self.delta.n_live > 0
                and self.now - self.delta.t_min > self.cfg.seal_max_age)

    def maybe_seal(self) -> Optional[SealedSegment]:
        """Seal if the policy says so; returns the new segment or None."""
        return self.seal() if self.should_seal() else None

    def seal(self) -> Optional[SealedSegment]:
        """Freeze the delta's live points into an immutable indexed segment
        (with ``cfg.quantize``, also fit its scales and int8 codes here —
        the segment is immutable from now on)."""
        with self._lock:
            xl, sl, gl = self.delta.live_points()
            self.delta.reset()
            if len(gl) == 0:
                return None
            seg = SealedSegment.from_points(self._next_seg_id, xl, sl, gl,
                                            self.time_dim, self.cfg.index_cfg,
                                            device=self.device,
                                            quantize=self.cfg.quantize)
            self._next_seg_id += 1
            self.segments.append(seg)
            self.segments.sort(key=lambda g: g.t_min)
            self.epoch += 1
            self.counters["sealed"] += 1
            self.obs.registry.counter("lifecycle_sealed_total").inc()
            self.obs.registry.counter("lifecycle_sealed_points_total").inc(
                len(gl))
            self._apply_pack_delta((), (seg,))
            self._checkpoint_if_attached()
        self._warm_pack()
        return seg

    # ------------------------------------------------------------------
    # Sharded read path: the bucketed device pack
    # ------------------------------------------------------------------
    def _shard_source(self, seg: SealedSegment):
        """One segment's live points (plus its codec payload and graph when
        the quantized / graph read paths are on) as a pack delta input,
        built from ONE :meth:`~SealedSegment.live_snapshot`."""
        from ..distributed.segment_shards import SegmentShardSource
        nbrs = entries = None
        if self.cfg.read_path != "scan":
            xl, sl, gl, quant, graph = seg.live_snapshot(with_graph=True)
            nbrs, entries = graph.nbrs, graph.entries
        else:
            xl, sl, gl, quant = seg.live_snapshot()
        codes = scales = xsq = None
        if self.cfg.quantize is not None and quant is not None:
            codes, scales, xsq = quant.codes, quant.scales, quant.xsq
        return SegmentShardSource(seg.seg_id, xl, sl, gl, seg.t_min,
                                  seg.t_max, codes=codes, scales=scales,
                                  xsq=xsq, nbrs=nbrs, entries=entries)

    @property
    def graph_degree(self) -> Optional[int]:
        """Adjacency width staged into pack graph blocks (None = scan-only
        pack): ``n_layers`` times one layer's edge width (intra degree +
        cross-edge budget), capped at 64 — after per-point dedupe the real
        degree sits well below the bound, and every padded ``-1`` lane is
        wasted work in each traversal hop."""
        if self.cfg.read_path == "scan":
            return None
        ic = self.cfg.index_cfg
        return min(64, int(ic.n_layers
                           * (ic.m_intra + 2 * self.m * ic.m_cross)))

    def _warm_pack(self) -> int:
        """Build and load the kernels the pack reads with, at the end of a
        seal / publish, so the first query does not pay for ``nvcc`` or
        the library load.  Returns the libraries loaded."""
        if not self.cfg.pack_warm_compile or self.cfg.n_shards < 1:
            return 0
        from ..kernels.ops import warm_sharded_shapes
        return warm_sharded_shapes("int8" if self.cfg.quantize else "fp32",
                                   self.device,
                                   graph=self.cfg.read_path != "scan")

    def _apply_pack_delta(self, removed, added) -> None:
        """Keep the cached bucketed pack in sync with one segment-list
        transition (called under the lock, after the epoch bump): victims
        tombstone their slots, each added segment's live points append
        into their capacity bucket.  With ``incremental_pack`` off (or a
        monolithic pack cached) the pack is invalidated and cold-rebuilt
        on the next sharded query.  A delta failure also invalidates it
        (recorded by the supervisor), so queries stay correct."""
        pack = self._pack
        if pack is None:
            return
        from ..distributed.segment_shards import BucketedShardPack
        if (self.cfg.n_shards < 1 or not self.cfg.incremental_pack
                or not isinstance(pack, BucketedShardPack)
                or pack.quantize != self.cfg.quantize
                or pack.graph_degree != self.graph_degree):
            self._pack = None
            return
        try:
            pack.metrics = self.obs.registry
            pack.fault_hook = self.fault_injector
            self._fault("pack.delta")
            for seg in removed:
                pack.remove_segment(seg.seg_id)
            for seg in added:
                src = self._shard_source(seg)
                if len(src.gids):
                    pack.add_segment(src)
            pack.epoch = self.epoch
            self._update_pack_gauges(pack)
            self._tier_enforce(pack)
        except Exception as exc:
            self.supervisor.note_error("pack_delta", exc)
            self._pack = None

    def _update_pack_gauges(self, pack) -> None:
        """Refresh the device-pack occupancy gauges after a transition
        (caller holds the lock).  Gauges of released capacity classes are
        dropped rather than left at their last value."""
        reg = self.obs.registry
        if not reg.enabled or not hasattr(pack, "bucket_stats"):
            return
        reg.drop_prefix("pack_bucket_")
        reg.gauge("pack_nbytes").set(pack.nbytes)
        reg.gauge("pack_segments").set(pack.n_segments)
        for cap, row in pack.bucket_stats().items():
            for key in ("rows", "live_rows", "segments", "resident"):
                reg.gauge(f'pack_bucket_{key}{{cap="{cap}"}}').set(row[key])

    # ------------------------------------------------------------------
    # Tiered storage (streaming/tiering.py): device memory as a cache
    # ------------------------------------------------------------------
    def _bucket_meta(self, pack) -> List[dict]:
        """Per-bucket policy inputs for the tier (caller holds the lock):
        capacity, residency, full block bytes, the bucket's packed time
        span and its rolling BucketStats entry (None before any
        observation)."""
        snap = (self.obs.bucket_stats.snapshot()
                if self.obs.bucket_stats is not None else {})
        meta = []
        for cap, b in pack.buckets.items():
            alloc = b.seg_ids >= 0
            if not alloc.any():
                continue
            meta.append({"cap": cap, "resident": b.resident,
                         "nbytes": b.full_nbytes,
                         "t_min": float(b.t_min[alloc].min()),
                         "t_max": float(b.t_max[alloc].max()),
                         "stats": snap.get(str(cap))})
        return meta

    def _tier_enforce(self, pack, protect: Tuple[int, ...] = ()) -> int:
        """Evict coldest-first until the pack's resident bytes fit the
        budget (caller holds the lock; no-op without a tier or with a
        monolithic pack).  ``protect`` names capacities a caller just
        admitted, which are never the immediate victim.  Returns the
        device bytes released."""
        if self.tier is None or not hasattr(pack, "evict_bucket"):
            return 0
        freed = 0
        need = pack.nbytes - self.tier.budget_bytes
        if need > 0:
            meta = [m for m in self._bucket_meta(pack)
                    if m["cap"] not in protect]
            for cap in self.tier.pick_victims(meta, need):
                freed += pack.evict_bucket(cap)
                self.obs.registry.counter("tier_evictions_total").inc()
                if pack.nbytes <= self.tier.budget_bytes:
                    break
        self._update_tier_gauges(pack)
        return freed

    def _update_tier_gauges(self, pack) -> None:
        """Refresh the tier occupancy gauges (caller holds the lock)."""
        if self.tier is None:
            return
        reg = self.obs.registry
        reg.gauge("tier_budget_bytes").set(self.tier.budget_bytes)
        reg.gauge("tier_resident_bytes").set(pack.nbytes)
        reg.gauge("tier_host_bytes").set(getattr(pack, "host_nbytes", 0))

    def tier_admit(self, cap: int, prefetch: bool = False,
                   expect_epoch: Optional[int] = None):
        """Admit one cold bucket's block back to the device (the query
        path calls this when the planner prices ``admit_cheaper``), then
        re-enforce the budget with the admitted bucket protected.  Returns
        the refreshed resident ``BucketView``, or None when there is
        nothing to admit or the block alone exceeds the budget (it stays
        cold and streams per dispatch).  ``expect_epoch`` guards an
        in-flight query's snapshot: when the pack has moved past it the
        admission still happens (it helps the next query) but None is
        returned, so the caller keeps its epoch-consistent cold view."""
        with self._lock:
            pack = self._pack
            if (self.tier is None or pack is None
                    or not hasattr(pack, "admit_bucket")):
                return None
            b = pack.buckets.get(cap)
            if b is None:
                return None
            stale = expect_epoch is not None and pack.epoch != expect_epoch
            if not b.resident:
                if b.full_nbytes > self.tier.budget_bytes:
                    return None
                if not pack.admit_bucket(cap):
                    return None         # pragma: no cover - defensive
                reg = self.obs.registry
                reg.counter("tier_admissions_total").inc()
                if prefetch:
                    reg.counter("tier_prefetch_admissions_total").inc()
            self._tier_enforce(pack, protect=(cap,))
            return None if stale else pack.bucket_view(cap)

    def _tier_warm_admit(self, pack) -> None:
        """Budget-bounded warm-up of a cold-built pack (restore / first
        sharded query; caller holds the lock): admit buckets most-recent-
        span first while they fit, then flip ``resident_default`` so
        buckets created by later deltas start on the device (enforcement
        keeps the budget).  An admission that an injected ``admission.*``
        fault crashes leaves its bucket cold — every stage fires its fault
        point before it mutates anything — and lands in
        ``stats()["health"]`` under ``tier_admission``: the query that
        triggered the warm-up answers from the cold path, exactly.  Any
        other error raises."""
        from .resilience import FaultError
        for m in sorted(self._bucket_meta(pack), key=lambda m: -m["t_max"]):
            if (not m["resident"]
                    and pack.nbytes + m["nbytes"] <= self.tier.budget_bytes):
                try:
                    admitted = pack.admit_bucket(m["cap"])
                except FaultError as exc:
                    self.supervisor.note_error("tier_admission", exc)
                    continue
                if admitted:
                    self.obs.registry.counter("tier_admissions_total").inc()
        pack.resident_default = True
        self._update_tier_gauges(pack)

    def maybe_prefetch(self) -> Optional[threading.Thread]:
        """Stage cold buckets the predicted next query window will touch,
        on a supervised background thread (at most one alive; failures
        are retried and recorded in ``stats()["health"]``).  The query
        path calls this after each sharded dispatch; returns the thread,
        or None when there is nothing to prefetch."""
        if self.tier is None or not self.cfg.tier_prefetch:
            return None
        with self._lock:
            pack = self._pack
            if pack is None or not hasattr(pack, "stage_admission"):
                return None
            if not self.tier.prefetch_targets(self._bucket_meta(pack)):
                return None
        t = self.supervisor.spawn("prefetcher", self._prefetch_once)
        self._prefetch_thread = t
        return t

    def _prefetch_once(self) -> int:
        """One prefetch round: snapshot the cold targets under the lock,
        upload their host blocks lock-free on the pack's side stream (the
        thread first sets its CUDA device), and install each upload under
        the lock only if the pack and the bucket's mutation generation
        are unchanged (a delta that landed mid-upload discards the stale
        upload — the bucket stays cold and correct).  Returns the buckets
        admitted.  Fault point ``prefetch.round`` fires at entry (the
        supervisor retries a crashed round; prefetch only moves residency,
        so a crash at any stage changes no answer)."""
        self._fault("prefetch.round")
        if self.device.type == "cuda":
            import torch
            torch.cuda.set_device(self.device)
        with self._lock:
            pack = self._pack
            if (self.tier is None or pack is None
                    or not hasattr(pack, "stage_admission")):
                return 0
            staged = []
            budget = self.tier.budget_bytes
            for cap in self.tier.prefetch_targets(self._bucket_meta(pack)):
                b = pack.buckets.get(cap)
                if b is None or b.resident or b.full_nbytes > budget:
                    continue
                st = pack.stage_admission(cap)
                if st is not None:
                    staged.append((cap, st))
        if not staged:
            return 0
        ups = [(cap, pack.upload_admission(st)) for cap, st in staged]
        admitted = 0
        with self._lock:
            if self._pack is not pack:
                return 0
            reg = self.obs.registry
            for cap, (gen, up) in ups:
                if pack.install_admission(cap, gen, up):
                    admitted += 1
                    reg.counter("tier_admissions_total").inc()
                    reg.counter("tier_prefetch_admissions_total").inc()
            if admitted:
                self._tier_enforce(pack)
        return admitted

    def _checkpoint_if_attached(self) -> None:
        """Durably checkpoint after a segment-list transition (no-op
        without persistence; deferred during a bulk ingest, which
        checkpoints once at the batch boundary)."""
        if self.persist is not None and not self._suspend_ckpt:
            self.persist.checkpoint(self)

    def shard_pack(self, epoch: int, segments: List[SealedSegment]):
        """The consistent shard-pack read state for ``(epoch, segments)``:
        an immutable ``PackView`` of the delta-maintained bucketed pack (or
        the monolithic ``ShardPack`` with ``incremental_pack`` off),
        cold-building when no cached pack matches the epoch.

        The cold build runs outside the lock; installation re-checks the
        epoch and syncs the pack against deletions that landed mid-build.
        The view itself is captured under the lock, so it never interleaves
        with a concurrent delta."""
        from ..distributed.segment_shards import (BucketedShardPack,
                                                  build_bucketed_pack,
                                                  build_shard_pack)

        def _read_state(pack):
            return (pack.view() if isinstance(pack, BucketedShardPack)
                    else pack)

        with self._lock:
            pack = self._pack
            if pack is not None and pack.epoch == epoch:
                return _read_state(pack)
        sources = []
        for seg in segments:
            src = self._shard_source(seg)
            if len(src.gids):
                sources.append(src)
        if not sources:
            return None
        if self.cfg.incremental_pack:
            # under a tier budget the cold build stays in host memory;
            # _tier_warm_admit then uploads only what fits, most recent
            # span first
            pack = build_bucketed_pack(
                sources, self.cfg.n_shards, epoch,
                cap_multiple=self.cfg.pack_cap_multiple,
                quantize=self.cfg.quantize, metrics=self.obs.registry,
                graph_degree=self.graph_degree, device=self.device,
                resident_default=self.tier is None, mesh=self.shard_mesh)
        else:
            pack = build_shard_pack(sources, self.cfg.n_shards, epoch,
                                    cap_multiple=self.cfg.pack_cap_multiple,
                                    device=self.device, mesh=self.shard_mesh)
        with self._lock:
            pack.sync_alive(self.alive)
            pack.fault_hook = self.fault_injector
            if self.epoch == epoch:
                self._pack = pack
                if self.tier is not None and hasattr(pack, "admit_bucket"):
                    self._tier_warm_admit(pack)
                self._update_pack_gauges(pack)
            return _read_state(pack)

    # ------------------------------------------------------------------
    # Retention / TTL
    # ------------------------------------------------------------------
    def expire(self, now: Optional[float] = None) -> int:
        """Drop whole segments past retention — O(1) per segment (the index
        is released, not edited).  Straggler delta points expire via mask."""
        if not math.isfinite(self.cfg.ttl):
            return 0
        with self._lock:
            cutoff = (self.now if now is None else float(now)) - self.cfg.ttl
            dropped = 0
            kept: List[SealedSegment] = []
            expired: List[SealedSegment] = []
            for seg in self.segments:
                if seg.t_max < cutoff:
                    self._alive[seg.gids] = False
                    dropped += seg.n_live
                    self.counters["expired_segments"] += 1
                    expired.append(seg)
                else:
                    kept.append(seg)
            list_changed = len(kept) != len(self.segments)
            if list_changed:
                self.segments = kept
                self.epoch += 1
                self._apply_pack_delta(expired, ())
            gl = self.delta.expire_before(cutoff)
            self._alive[gl] = False
            self.counters["expired_points"] += dropped + len(gl)
            reg = self.obs.registry
            reg.counter("lifecycle_expired_segments_total").inc(len(expired))
            reg.counter("lifecycle_expired_points_total").inc(
                dropped + len(gl))
            # dropping an all-dead segment flips no liveness bit but still
            # changes the list, which must reach the manifest
            if list_changed or dropped or len(gl):
                self._checkpoint_if_attached()
        return dropped + len(gl)

    # ------------------------------------------------------------------
    # Compaction (plan under lock / execute lock-free / publish atomically)
    # ------------------------------------------------------------------
    def plan_compaction(self) -> Optional[CompactionPlan]:
        """Pick this round's rewrites against the current segment list.

        Merging simulates the greedy smallest-adjacent-pair policy on live
        counts, so one plan carries the full set of merge *groups* needed to
        get the list back under ``compact_max_segments``.  Returns None when
        there is nothing to do.
        """
        with self._lock:
            segs = [g for g in self.segments if g.n_live > 0]
            drop_empty = len(segs) != len(self.segments)
            groups = [[g] for g in segs]
            while len(groups) > self.cfg.compact_max_segments:
                sizes = [sum(x.n_live for x in grp) for grp in groups]
                i = min(range(len(sizes) - 1),
                        key=lambda j: sizes[j] + sizes[j + 1])
                groups[i:i + 2] = [groups[i] + groups[i + 1]]
            merges = [grp for grp in groups if len(grp) > 1]
            merged = {id(g) for grp in merges for g in grp}
            gc = [g for g in segs if id(g) not in merged
                  and g.deleted_fraction() > self.cfg.compact_deleted_fraction]
            if not gc and not merges and not drop_empty:
                return None
            plan = CompactionPlan(self.epoch, gc, merges, drop_empty)
            self.obs.registry.counter("compaction_plans_total").inc()
            self.obs.registry.counter("compaction_planned_ops_total").inc(
                plan.n_ops)
            return plan

    def execute_compaction(self, plan: CompactionPlan
                           ) -> List[Tuple[List[SealedSegment],
                                           Optional[SealedSegment]]]:
        """Build every replacement segment in the plan — the expensive part,
        run without the lock (this is what ``compact_async`` moves off the
        ingest/query path).  Returns ``(victims, replacement)`` pairs.
        Fault point ``compaction.execute`` fires before any rebuild — a
        crash here mutates nothing."""
        self._fault("compaction.execute")
        t0 = time.perf_counter()
        built: List[Tuple[List[SealedSegment], Optional[SealedSegment]]] = []
        for seg in plan.gc:
            built.append(([seg], seg.compacted(quantize=self.cfg.quantize)))
        for grp in plan.merges:
            built.append((grp, self._merge_group(grp)))
        if self.persist is not None:
            # stage the replacements' artifacts here, lock-free, so the
            # publish checkpoint only swaps state and manifest
            for _, new_seg in built:
                if new_seg is not None:
                    self.persist.stage_segment(new_seg)
        self.obs.registry.counter("compaction_executed_ops_total").inc(
            plan.n_ops)
        self.obs.registry.histogram("compaction_execute_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return built

    def publish_compaction(self, plan: CompactionPlan, built) -> int:
        """Atomically swap replacements into the segment list.

        Operations whose victims already left the list (expired or replaced
        by a racing round) are dropped; deletions that landed during the
        build are re-applied to each replacement before it becomes visible.
        Bumps ``epoch``.  Returns the number of applied rewrite ops.
        """
        ops = 0
        with self._lock:
            current = {id(g) for g in self.segments}
            out = list(self.segments)
            for victims, new_seg in built:
                if any(id(v) not in current for v in victims):
                    continue
                if new_seg is not None:
                    dead = new_seg.gids[~self._alive[new_seg.gids]]
                    if len(dead):
                        new_seg.delete(dead)
                victim_ids = {id(v) for v in victims}
                out = [g for g in out if id(g) not in victim_ids]
                if new_seg is not None and new_seg.n_live > 0:
                    out.append(new_seg)
                ops += 1 if len(victims) == 1 else len(victims) - 1
            out = [g for g in out if g.n_live > 0]
            changed = ops > 0 or len(out) != len(self.segments)
            if changed:
                pre_ids = {id(g): g for g in self.segments}
                post_ids = {id(g) for g in out}
                out.sort(key=lambda g: g.t_min)
                self.segments = out
                self.epoch += 1
                # pack delta = the object-identity diff of the swap (merge
                # victims, GC rewrites reusing a seg_id, and all-dead
                # segments dropped from the list)
                self._apply_pack_delta(
                    [g for oid, g in pre_ids.items() if oid not in post_ids],
                    [g for g in out if id(g) not in pre_ids])
            if ops:
                self.counters["compactions"] += 1
                self.obs.registry.counter(
                    "compaction_published_ops_total").inc(ops)
            if changed:
                self._checkpoint_if_attached()
        self._warm_pack()
        return ops

    def compact(self) -> int:
        """One full synchronous compaction: plan/execute/publish rounds
        until a plan comes back empty; returns total rewrite operations.
        (Call :meth:`compact_async` to run this off the hot path.)"""
        total = 0
        for _ in range(8):          # one round in the uncontended case
            plan = self.plan_compaction()
            if plan is None:
                break
            built = self.execute_compaction(plan)
            applied = self.publish_compaction(plan, built)
            total += applied
            if applied < plan.n_ops:
                break               # racing mutations; let the next tick retry
        return total

    def compact_async(self) -> threading.Thread:
        """Run :meth:`compact` on a supervised daemon thread (at most one
        at a time); returns the thread.  Queries and ingest proceed
        concurrently — the publish step is the only part that takes the
        lock.  A compaction that raises is retried with bounded backoff
        by the :class:`~.resilience.Supervisor` and recorded in
        ``stats()["health"]``."""
        t = self.supervisor.spawn("compactor", self.compact)
        self._compact_thread = t
        return t

    def wait_for_compaction(self, timeout: Optional[float] = None) -> None:
        """Block until the background compaction (if any) finishes."""
        t = self._compact_thread
        if t is not None:
            t.join(timeout)

    def _merge_group(self, segs: Sequence[SealedSegment]
                     ) -> Optional[SealedSegment]:
        """Rebuild one segment from the live points of ``segs``."""
        xs, ss, gs = [], [], []
        for g in segs:
            xl, sl, gl = g.live_points()
            xs.append(xl)
            ss.append(sl)
            gs.append(gl)
        gids = np.concatenate(gs)
        if len(gids) == 0:
            return None
        with self._lock:
            sid = self._next_seg_id
            self._next_seg_id += 1
        return SealedSegment.from_points(sid, np.concatenate(xs),
                                         np.concatenate(ss), gids,
                                         self.time_dim, self.cfg.index_cfg,
                                         device=self.device,
                                         quantize=self.cfg.quantize)

    def maintenance(self, async_compaction: bool = False) -> dict:
        """One lifecycle tick: seal (if due) + expire + compact + store GC.

        With ``async_compaction`` the compaction rounds run on the
        background thread and this tick returns immediately (the dict then
        reports ``compaction_ops=None``)."""
        sealed = self.maybe_seal() is not None
        expired = self.expire()
        if async_compaction:
            self.compact_async()
            compactions = None
        else:
            compactions = self.compact()
        freed = self.gc_store()
        return {"sealed": sealed, "expired_points": expired,
                "compaction_ops": compactions, "store_gc_points": freed}

    # ------------------------------------------------------------------
    # Durability (WAL + manifest snapshots live in streaming/persistence.py)
    # ------------------------------------------------------------------
    def snapshot_to(self, directory: str) -> dict:
        """Write a complete, self-consistent snapshot of this manager to
        ``directory`` (segment artifacts + state + atomic manifest, the JAX
        package's format) and return the manifest dict.

        Segment artifacts are immutable, so they are staged without the
        lock first; only the state + manifest capture runs under the lock,
        which serializes it against ingest, deletes and a racing
        ``compact_async`` publish.  When ``directory`` is this manager's
        own ``persist_dir`` the attached persistence checkpoints; any
        other directory gets a standalone export."""
        from .persistence import StreamPersistence
        if self.persist is not None and os.path.abspath(directory) \
                == os.path.abspath(self.persist.root):
            p, owned = self.persist, False
        else:
            p = StreamPersistence(directory, self.cfg.wal_fsync_every)
            owned = True
        with self._lock:
            segments = list(self.segments)
        for seg in segments:         # lock-free: artifact content is frozen
            p.stage_segment(seg)
        try:
            with self._lock:
                return p.checkpoint(self)
        finally:
            if owned:
                p.close()

    @classmethod
    def restore(cls, directory: str, cfg: Optional[StreamConfig] = None,
                device=None, resume: bool = True,
                mmap_segments: Optional[bool] = None,
                shard_mesh=None) -> "SegmentManager":
        """Rebuild a manager on ``device`` (default: the card) or on
        ``shard_mesh`` from a snapshot directory written by either
        package: last published manifest + mmapped segment artifacts +
        WAL-tail replay.  The result answers queries bit-for-bit like the
        snapshotted manager, whether that ran on one card or a mesh (see
        ``streaming.persistence.restore_manager``).  ``resume``
        re-attaches persistence to ``directory``; ``cfg`` overrides the
        persisted config (e.g. a ``device_budget_bytes``)."""
        from .persistence import restore_manager
        return restore_manager(directory, cfg=cfg, device=device,
                               resume=resume, mmap_segments=mmap_segments,
                               shard_mesh=shard_mesh)

    # ------------------------------------------------------------------
    # Read path (fan-out lives in streaming/query.py)
    # ------------------------------------------------------------------
    def snapshot(self):
        """(epoch, segment-list copy, frozen delta rows) — the consistent
        view a query runs against while ingest/seal/compaction publish
        concurrently, captured in one lock hold."""
        with self._lock:
            return self.epoch, list(self.segments), self.delta.freeze()

    def query(self, queries: np.ndarray, filt: Optional[Filter], k: int = 10,
              ef: int = 64, return_stats: bool = False,
              return_trace: bool = False, **kw):
        """Unified fan-out query over the delta buffer + sealed segments;
        see :func:`repro_torch.streaming.query.query_segments`.  Returns
        host ``(gids [b, k] int64, dists [b, k] fp32)``.

        ``return_trace`` appends a finished
        :class:`~repro_torch.obs.trace.QueryTrace` to the result tuple,
        whose ``id`` is the number of batches this manager was asked
        before this one.  ``deadline_ms`` (forwarded via ``**kw``) bounds
        this call's time budget."""
        from .query import query_segments
        batch = next(self._batch_seq)
        if not return_trace:
            return query_segments(self, queries, filt, k=k, ef=ef,
                                  return_stats=return_stats, **kw)
        from ..obs.trace import QueryTrace
        from .resilience import QueryResult
        trace = QueryTrace("query", id=batch)
        out = query_segments(self, queries, filt, k=k, ef=ef,
                             return_stats=return_stats, trace=trace, **kw)
        return QueryResult(out + (trace.finish(),), degraded=out.degraded,
                           reasons=out.reasons)

    def query_grouped(self, groups, trace=None, observe_group=None):
        """Continuous filtered batching: answer several heterogeneous
        :class:`~repro_torch.streaming.query.GroupQuery` request groups in
        one pass, sharing each sealed bucket's device block across every
        group active there; see
        :func:`repro_torch.streaming.query.query_segments_grouped` (answers
        are bit for bit the per-group :meth:`query` answers)."""
        from .query import query_segments_grouped
        return query_segments_grouped(self, groups, trace=trace,
                                      observe_group=observe_group)

    def stats(self) -> dict:
        """Lifecycle counters, per-segment occupancy, and the ``obs``
        metrics block for dashboards.  Strict-JSON safe end-to-end."""
        from ..obs.metrics import json_sanitize
        with self._lock:
            pack = self._pack
            return json_sanitize({
                "pack_nbytes": 0 if pack is None else int(pack.nbytes),
                "pack_buckets": (pack.bucket_stats()
                                 if hasattr(pack, "bucket_stats") else {}),
                "n_total": self.n_total,
                "n_live": self.n_live,
                "delta_live": self.delta.n_live,
                "n_segments": len(self.segments),
                "segment_live": [g.n_live for g in self.segments],
                "segment_spans": [(g.t_min, g.t_max) for g in self.segments],
                "now": self.now,
                "epoch": self.epoch,
                "n_shards": self.cfg.n_shards,
                "quantize": self.cfg.quantize,
                "tier": (None if self.tier is None else {
                    "budget_bytes": self.tier.budget_bytes,
                    "resident_bytes": 0 if pack is None else int(pack.nbytes),
                    "host_bytes": (0 if pack is None else
                                   int(getattr(pack, "host_nbytes", 0))),
                }),
                "store_resident_points": self.store.resident_points,
                "store_nbytes": self.store.nbytes,
                "health": self.supervisor.health(),
                "obs": self.obs.snapshot(),
                **self.counters,
            })
