"""Durable streaming snapshots: WAL + segment artifacts + atomic manifest.

Three cooperating pieces give
:class:`~repro_torch.streaming.manager.SegmentManager` crash-consistent
durability.  The on-disk format is the JAX package's byte for byte (the
same file names, record types, npz keys, manifest fields and artifact
layout), so either package restores a snapshot the other wrote.

* **Write-ahead log** (:class:`WriteAheadLog`) — the hot path.  Every ingest
  batch, delete, and point-store GC appends one CRC-framed record
  (``[u32 length][u32 crc32][payload]``) to an append-only file; fsyncs are
  batched (``wal_fsync_every``).  Replay stops at the first torn or
  corrupt frame, so a crash mid-append loses only the unacknowledged record.

* **Segment artifacts** — immutable per-segment directories written once at
  seal / compaction-publish through
  :func:`repro_torch.core.cubegraph.save_index` (graphs + standalone ``x.npy`` /
  ``s.npy`` point arrays + gid map + time range; with the quantized read
  path on, also the int8 codec payload — codes, per-dimension scales,
  dequantized norms — so restore never re-quantizes).  Restore loads them
  with ``np.load(mmap_mode="r")`` for cheap replica warm-start; the
  read-only maps are copied into device tensors, never aliased.
  Artifacts are staged in a ``*.tmp`` directory and published with one
  ``os.replace``.

* **Versioned manifest** (``MANIFEST.json``) — the commit point.  A
  checkpoint captures the mutable residue (liveness bitmap, delta buffer,
  point-store chunks) into a ``state-<version>.npz``, rotates the WAL, and
  swaps the manifest via write-temp-then-rename.  Every on-disk state is
  therefore self-consistent: restore reads the last published manifest and
  replays the (complete-by-construction) WAL tail after it.

Checkpoints happen only at segment-list transitions (seal, compaction
publish, expiry) and on explicit :meth:`SegmentManager.snapshot_to` — the
LSM discipline: sealed data is written once, the WAL covers everything
between checkpoints, and nothing on the ingest/delete hot path ever waits
on an index serialization.

Recovery sequence (:func:`restore_manager`)::

    MANIFEST.json -> verify state checksum -> load segment artifacts (mmap)
                  -> rebuild alive bitmap / delta buffer / point store
                  -> replay WAL tail (ingest / delete / gc records)
                  -> re-derive per-segment validity from the alive bitmap

The restored manager answers queries bit-for-bit identically to the
pre-snapshot one: sealed-segment arrays round-trip exactly, the delta
buffer preserves row order, and the shard-pack read path rebuilds from the
same live points in the same segment order
(``tests/test_torch_persistence.py``).  The size-bucketed device pack is
*derived* state: it is never serialized —
restore cold-builds the buckets lazily on the first sharded query from the
restored segments' live points (the manifest's per-segment entries carry
``n_live`` and the projected ``bucket_cap``, and the cfg blob carries the
bucket geometry knobs, so a replica's device footprint is known up front).

Fault hooks: every critical transition calls ``fault_hook(point)`` when a
plain callable is installed (``"wal.append"`` mid-frame, ``"wal.fsync"``
before a batched flush, ``"segment.write"`` between index arrays and the
artifact's metadata, ``"manifest.rename"`` just before the atomic swap).
The crash-recovery tests raise from these hooks and then restore from disk
— simulating a kill at the worst possible instant.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import struct
import threading
import time
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core import CubeGraphConfig
from ..core.cubegraph import load_index, load_index_extras, save_index
from ..obs.metrics import NULL_REGISTRY
from .segments import SealedSegment

__all__ = ["RestoreError", "WriteAheadLog", "StreamPersistence",
           "load_manifest", "restore_manager", "write_segment_artifact",
           "load_segment_artifact"]

WAL_MAGIC = b"CGWAL001"
_FRAME = struct.Struct("<II")            # payload length, crc32(payload)
REC_INGEST, REC_DELETE, REC_GC = 1, 2, 3
MANIFEST_NAME = "MANIFEST.json"
MANIFEST_FORMAT = 1


class RestoreError(RuntimeError):
    """A snapshot directory failed a consistency check during restore."""


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync so renames survive a power cut."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                      # pragma: no cover - platform quirk
        return
    try:
        os.fsync(fd)
    except OSError:                      # pragma: no cover - platform quirk
        pass
    finally:
        os.close(fd)


def _fsync_tree(directory: str) -> None:
    """fsync every file under ``directory`` — artifact data blocks must be
    durable before a manifest referencing the artifact commits."""
    for dirpath, _, files in os.walk(directory):
        for name in files:
            try:
                fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
            except OSError:              # pragma: no cover - platform quirk
                continue
            try:
                os.fsync(fd)
            except OSError:              # pragma: no cover - platform quirk
                pass
            finally:
                os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via temp file + fsync + atomic rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


# ---------------------------------------------------------------------------
# Write-ahead log
# ---------------------------------------------------------------------------
class WriteAheadLog:
    """Append-only CRC-framed record log (the ingest/delete hot path).

    Frame layout: ``[u32 length][u32 crc32][payload]`` after an 8-byte file
    magic.  Appends write the whole frame in one unbuffered write and fsync
    every ``fsync_every`` records (and on :meth:`sync`), trading a bounded
    tail-loss window for hot-path latency.  :meth:`replay` yields decoded
    records and stops cleanly at the first torn or corrupt frame.
    """

    def __init__(self, path: str, fsync_every: int = 32,
                 fault_hook: Optional[Callable[[str], None]] = None,
                 metrics=None):
        self.path = path
        self.fsync_every = max(int(fsync_every), 1)
        self.fault_hook = fault_hook
        self.metrics = NULL_REGISTRY if metrics is None else metrics
        self._since_sync = 0
        self._f = open(path, "ab", buffering=0)
        # a new OR empty file always gets the magic — appends to a
        # magic-less log would be silently unreplayable
        if self._f.tell() == 0:
            self._f.write(WAL_MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())

    @property
    def offset(self) -> int:
        """Current end-of-log byte offset (== bytes durable once synced)."""
        return self._f.tell()

    def append(self, rec_type: int, payload: bytes) -> int:
        """Frame and append one record; returns the post-append offset.

        Failure-atomic for a *surviving* process: if any write raises
        (ENOSPC, a raising fault hook), the file is truncated back to the
        pre-append offset before the exception propagates, so the log never
        carries a torn frame that would hide later appends from replay.  A
        process killed mid-write does leave a torn frame — replay stops at
        it and a resuming replica truncates it (see
        ``restore_manager``).

        With a fault hook installed the frame is split in two writes around
        the hook call, emulating the kill-mid-write state at the hook.
        """
        body = bytes([rec_type]) + payload
        frame = _FRAME.pack(len(body), zlib.crc32(body)) + body
        start = self._f.tell()
        since0 = self._since_sync
        t0 = time.perf_counter()
        try:
            if self.fault_hook is not None:
                mid = len(frame) // 2
                self._f.write(frame[:mid])
                self.fault_hook("wal.append")
                self._f.write(frame[mid:])
            else:
                self._f.write(frame)
            self._since_sync += 1
            # the batched fsync is part of this append's failure atom: if
            # it raises (ENOSPC at sync time, a "wal.fsync" fault), the
            # un-acknowledged record is rolled back too — otherwise the
            # caller aborts its mutation while the record survives replay,
            # and the *next* logged ingest would no longer extend the
            # store (phantom-point RestoreError on recovery)
            if self._since_sync >= self.fsync_every:
                self.sync()
        except BaseException:
            self._since_sync = since0
            try:
                self._f.truncate(start)
                self._f.seek(start)
            except OSError:              # pragma: no cover - disk gone
                pass
            raise
        # the append histogram includes the batched fsync when this record
        # hit the batch boundary — that is the latency an acknowledged
        # ingest actually pays, which is what the histogram is for
        self.metrics.histogram("wal_append_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return self._f.tell()

    def sync(self) -> None:
        """fsync pending appends (batch boundary).  Named fault point
        ``wal.fsync`` fires just before the flush — a raise here, reached
        through :meth:`append`, rolls the triggering record back (see the
        failure-atomicity note there)."""
        t0 = time.perf_counter()
        if self.fault_hook is not None:
            self.fault_hook("wal.fsync")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._since_sync = 0
        self.metrics.histogram("wal_fsync_ms").observe(
            (time.perf_counter() - t0) * 1e3)

    def close(self) -> None:
        """Sync and release the file handle."""
        try:
            self.sync()
        finally:
            self._f.close()

    # -- record encodings ----------------------------------------------
    def log_ingest(self, gid0: int, x: np.ndarray, s: np.ndarray) -> int:
        """One ingest batch: first assigned gid + raw row bytes."""
        x = np.ascontiguousarray(x, np.float32)
        s = np.ascontiguousarray(s, np.float64)
        head = struct.pack("<QIII", int(gid0), x.shape[0], x.shape[1],
                           s.shape[1])
        return self.append(REC_INGEST, head + x.tobytes() + s.tobytes())

    def log_delete(self, gids: np.ndarray) -> int:
        """One delete batch by global id."""
        g = np.ascontiguousarray(gids, np.int64)
        return self.append(REC_DELETE, struct.pack("<I", len(g)) + g.tobytes())

    def log_gc(self, chunk_ids: Sequence[int]) -> int:
        """One point-store GC pass: the freed chunk indices."""
        c = np.ascontiguousarray(chunk_ids, np.int64)
        return self.append(REC_GC, struct.pack("<I", len(c)) + c.tobytes())

    @staticmethod
    def scan(path: str, offset: int = 0
             ) -> Tuple[List[Tuple[int, object]], int]:
        """Decode every intact record after ``offset`` (0 means the whole
        log), stopping at the first torn or CRC-failing frame — the durable
        prefix property.  Returns ``(records, durable_end)`` where
        ``durable_end`` is the byte offset just past the last intact frame:
        a resuming replica truncates the file there so fresh appends extend
        the durable prefix instead of hiding behind a torn frame."""
        records: List[Tuple[int, object]] = []
        end = max(offset, len(WAL_MAGIC))
        if not os.path.exists(path):
            return records, end
        with open(path, "rb") as f:
            if f.read(len(WAL_MAGIC)) != WAL_MAGIC:
                return records, len(WAL_MAGIC)
            if offset > len(WAL_MAGIC):
                f.seek(offset)
            while True:
                head = f.read(_FRAME.size)
                if len(head) < _FRAME.size:
                    return records, end
                length, crc = _FRAME.unpack(head)
                body = f.read(length)
                if len(body) < length or zlib.crc32(body) != crc:
                    return records, end
                rec_type = body[0]
                payload = body[1:]
                if rec_type == REC_INGEST:
                    gid0, n, d, m = struct.unpack_from("<QIII", payload)
                    off = struct.calcsize("<QIII")
                    x = np.frombuffer(payload, np.float32, n * d,
                                      off).reshape(n, d)
                    s = np.frombuffer(payload, np.float64, n * m,
                                      off + x.nbytes).reshape(n, m)
                    records.append((rec_type, (gid0, x, s)))
                elif rec_type in (REC_DELETE, REC_GC):
                    (n,) = struct.unpack_from("<I", payload)
                    records.append(
                        (rec_type, np.frombuffer(payload, np.int64, n, 4)))
                else:                     # unknown type: future format
                    return records, end
                end = f.tell()

    @staticmethod
    def replay(path: str, offset: int = 0):
        """Yield the intact records after ``offset`` (see :meth:`scan`)."""
        yield from WriteAheadLog.scan(path, offset)[0]


# ---------------------------------------------------------------------------
# Segment artifacts
# ---------------------------------------------------------------------------
def write_segment_artifact(seg: SealedSegment, directory: str,
                           fault_hook: Optional[Callable] = None) -> None:
    """Write one sealed segment as an immutable artifact directory.

    Staged under ``<directory>.tmp`` and published with one ``os.replace``,
    so a partially written artifact is never mistaken for a complete one —
    restore only trusts directories the manifest names, and the manifest is
    only swapped after every artifact it references has been renamed.
    """
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    extra_arrays = {"gids": seg.gids}
    extra_meta = {"seg_id": seg.seg_id, "time_dim": seg.time_dim,
                  "t_min": seg.t_min, "t_max": seg.t_max}
    if seg.quant is not None:
        # the codec payload is part of the immutable artifact: restore
        # attaches it as-is and never re-fits scales or re-encodes
        extra_arrays.update(qcodes=seg.quant.codes, qscales=seg.quant.scales,
                            qxsq=seg.quant.xsq)
        extra_meta["quant_kind"] = seg.quant.kind
    save_index(seg.index, tmp, extra_arrays=extra_arrays,
               extra_meta=extra_meta)
    if fault_hook is not None:
        fault_hook("segment.write")
    _fsync_tree(tmp)
    if os.path.exists(directory):        # pragma: no cover - re-publish
        shutil.rmtree(directory)
    os.replace(tmp, directory)
    _fsync_dir(os.path.dirname(directory) or ".")


def load_segment_artifact(directory: str, mmap_mode: Optional[str] = "r",
                          device=None) -> SealedSegment:
    """Artifact directory -> :class:`SealedSegment` with its index on
    ``device`` (default: the card).  The point arrays are mmapped by
    default: the host planning metadata stays disk-backed and the vectors
    are copied into device tensors.  Validity is re-derived by the caller
    from the manager's restored liveness bitmap.  A quantized artifact's
    codec payload (codes / scales / norms) is attached verbatim — restore
    never re-quantizes, so a restored replica's int8 scan is bit-for-bit
    the writer's."""
    idx = load_index(directory, mmap_mode=mmap_mode, device=device)
    arrays, extra = load_index_extras(directory, ["gids"])
    quant = None
    if extra.get("quant_kind"):
        from ..quant import SegmentQuant
        qarr, _ = load_index_extras(directory,
                                    ["qcodes", "qscales", "qxsq"])
        quant = SegmentQuant(str(extra["quant_kind"]),
                             np.array(qarr["qcodes"]),
                             np.array(qarr["qscales"]),
                             np.array(qarr["qxsq"]))
    return SealedSegment(int(extra["seg_id"]), idx,
                         np.array(arrays["gids"]), int(extra["time_dim"]),
                         quant=quant)


# ---------------------------------------------------------------------------
# Manifest + checkpoint
# ---------------------------------------------------------------------------
def load_manifest(root: str) -> dict:
    """Parse ``<root>/MANIFEST.json`` (raises ``FileNotFoundError`` when the
    directory holds no published snapshot)."""
    with open(os.path.join(root, MANIFEST_NAME)) as f:
        return json.load(f)


class StreamPersistence:
    """One manager's durable home directory: WAL + artifacts + manifest.

    Attach with ``StreamConfig(persist_dir=...)`` (the manager then logs
    every ingest/delete/GC and checkpoints at each segment-list transition)
    or construct standalone for a one-shot export via
    :meth:`SegmentManager.snapshot_to`.  All mutation entry points are
    called with the manager lock held, so a checkpoint always captures a
    quiescent, self-consistent state.
    """

    _ART_RE = re.compile(r"^seg-\d+-[vn](\d+)(?:\.tmp)?$")

    def __init__(self, root: str, fsync_every: int = 32,
                 fault_hook: Optional[Callable[[str], None]] = None,
                 metrics=None):
        self.root = root
        self.fsync_every = max(int(fsync_every), 1)
        self.fault_hook = fault_hook
        self.metrics = NULL_REGISTRY if metrics is None else metrics
        os.makedirs(root, exist_ok=True)
        self.version = 0
        self.wal: Optional[WriteAheadLog] = None
        # artifact-name allocation + in-flight staging registry (cleanup
        # must never rmtree a directory another thread is writing into)
        self._seq_lock = threading.Lock()
        self._staging: set = set()
        self._seq = max((int(m.group(1)) for m in
                         (self._ART_RE.match(n) for n in os.listdir(root))
                         if m), default=0)
        if os.path.exists(os.path.join(root, MANIFEST_NAME)):
            man = load_manifest(root)
            self.version = int(man["version"])
            self.wal = WriteAheadLog(os.path.join(root, man["wal_file"]),
                                     self.fsync_every, fault_hook,
                                     metrics=self.metrics)
        else:
            self.wal = WriteAheadLog(os.path.join(root, "wal-000000.log"),
                                     self.fsync_every, fault_hook,
                                     metrics=self.metrics)

    # -- hot path ------------------------------------------------------
    def log_ingest(self, gid0: int, x, s) -> None:
        """WAL-append one acknowledged ingest batch."""
        self.wal.log_ingest(gid0, x, s)

    def log_delete(self, gids) -> None:
        """WAL-append one acknowledged delete batch."""
        self.wal.log_delete(gids)

    def log_gc(self, chunk_ids) -> None:
        """WAL-append one point-store GC pass (freed chunk ids)."""
        if len(chunk_ids):
            self.wal.log_gc(chunk_ids)

    # -- artifacts -----------------------------------------------------
    def _next_artifact_name(self, seg_id: int) -> str:
        """Allocate a root-unique artifact directory name (thread-safe)."""
        with self._seq_lock:
            self._seq += 1
            return f"seg-{seg_id:05d}-n{self._seq:06d}"

    def stage_segment(self, seg: SealedSegment) -> str:
        """Write ``seg``'s artifact into this root (idempotent), safe to
        call WITHOUT the manager lock.  Compaction stages its replacement
        segments here during the lock-free execute phase, so the
        under-lock publish checkpoint finds the artifacts already on disk
        and only swaps state + manifest.  Validity is not a problem:
        restore derives per-segment validity from the liveness bitmap, so
        deletions racing the stage never make the artifact stale."""
        key = os.path.abspath(self.root)
        art = seg.artifacts.get(key)
        if art is not None and os.path.isdir(os.path.join(self.root, art)):
            return art
        art = self._next_artifact_name(seg.seg_id)
        with self._seq_lock:             # shield from a concurrent _cleanup
            self._staging.update((art, art + ".tmp"))
        try:
            write_segment_artifact(seg, os.path.join(self.root, art),
                                   self.fault_hook)
        finally:
            with self._seq_lock:
                self._staging.difference_update((art, art + ".tmp"))
        seg.artifacts[key] = art
        return art

    # -- checkpoint ----------------------------------------------------
    def checkpoint(self, manager) -> dict:
        """Capture ``manager`` (lock held by the caller) into a new manifest
        version: missing segment artifacts are written, the mutable residue
        goes into ``state-<v>.npz``, the WAL rotates, and ``MANIFEST.json``
        swaps last — the single commit point.  Returns the manifest dict."""
        from ..distributed.segment_shards import bucket_cap_for
        t_ckpt = time.perf_counter()
        v = self.version + 1
        seg_entries = []
        for seg in manager.segments:
            art = self.stage_segment(seg)     # no-op when already staged
            entry = {"seg_id": seg.seg_id, "dir": art,
                     "t_min": seg.t_min, "t_max": seg.t_max,
                     "n": seg.n, "n_live": seg.n_live,
                     # which codec (if any) the artifact's codes carry, so
                     # operators can audit a snapshot's quantization state
                     # without opening artifacts
                     "quant": None if seg.quant is None else seg.quant.kind}
            if manager.cfg.n_shards >= 1:
                # pack state is derived (restore cold-builds the buckets
                # lazily on the first sharded query), but the manifest
                # records each segment's capacity bucket so operators can
                # size a replica's device memory before restoring — the
                # cfg blob already carries n_shards / pack_cap_multiple /
                # incremental_pack, which is all the cold build needs
                entry["bucket_cap"] = bucket_cap_for(
                    seg.n_live, manager.cfg.n_shards,
                    manager.cfg.pack_cap_multiple)
            seg_entries.append(entry)

        state_name = f"state-{v:06d}.npz"
        state_bytes = _encode_state(manager)
        _atomic_write(os.path.join(self.root, state_name), state_bytes)

        wal_name = f"wal-{v:06d}.log"
        old_wal = self.wal
        old_wal.sync()
        new_wal = WriteAheadLog(os.path.join(self.root, wal_name),
                                self.fsync_every, self.fault_hook,
                                metrics=self.metrics)

        alive = np.ascontiguousarray(manager.alive)
        manifest = {
            "format": MANIFEST_FORMAT,
            "version": v,
            "epoch": manager.epoch,
            "next_seg_id": manager._next_seg_id,
            "n_total": manager.n_total,
            # strict JSON: non-finite floats have no standard encoding, so
            # the pre-first-ingest watermark (-inf) is stored as null
            "now": manager.now if math.isfinite(manager.now) else None,
            "d": manager.d,
            "m": manager.m,
            "cfg": _encode_cfg(manager.cfg),
            "counters": dict(manager.counters),
            "segments": seg_entries,
            "state_file": state_name,
            "state_crc": zlib.crc32(state_bytes),
            "alive_crc": zlib.crc32(np.packbits(alive).tobytes()),
            "wal_file": wal_name,
            "wal_offset": len(WAL_MAGIC),
        }
        data = json.dumps(manifest, indent=1, allow_nan=False).encode()
        tmp = os.path.join(self.root, MANIFEST_NAME + ".tmp")
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            if self.fault_hook is not None:
                self.fault_hook("manifest.rename")
            os.replace(tmp, os.path.join(self.root, MANIFEST_NAME))
        except BaseException:
            # failed commit: the old manifest + old WAL stay authoritative;
            # release the never-published WAL instead of leaking its fd on
            # every retried checkpoint
            try:
                new_wal.close()
                os.remove(new_wal.path)
            except OSError:              # pragma: no cover - disk gone
                pass
            raise
        _fsync_dir(self.root)

        self.version = v
        self.wal = new_wal
        old_wal.close()
        self._cleanup(manifest)
        self.metrics.counter("checkpoints_total").inc()
        self.metrics.histogram("checkpoint_ms").observe(
            (time.perf_counter() - t_ckpt) * 1e3)
        return manifest

    def _cleanup(self, manifest: dict) -> None:
        """Drop files the freshly published manifest no longer references
        (old WALs/state files, orphaned or staged artifacts).  Runs after
        the rename; a crash mid-cleanup only leaves harmless garbage.
        Names registered by an in-flight :meth:`stage_segment` are skipped
        rather than blocked on (the compactor's disk write must never
        stall a lock-holding checkpoint); a staged-but-unpublished
        artifact may still be removed once its staging finishes — the
        publish checkpoint then detects the missing directory and
        rewrites it."""
        keep = {manifest["wal_file"], manifest["state_file"], MANIFEST_NAME,
                *(e["dir"] for e in manifest["segments"])}
        for name in os.listdir(self.root):
            if name in keep:
                continue
            # re-check the staging registry immediately before each removal
            # (not once up front): a stage_segment may have registered this
            # name after a single earlier snapshot was taken
            with self._seq_lock:
                if name in self._staging:
                    continue
            path = os.path.join(self.root, name)
            try:
                if name.startswith(("wal-", "state-")) \
                        and os.path.isfile(path):
                    os.remove(path)
                elif name.startswith("seg-") and os.path.isdir(path):
                    shutil.rmtree(path)
            except OSError:              # pragma: no cover - races are fine
                pass

    def close(self) -> None:
        """Sync and close the active WAL."""
        if self.wal is not None:
            self.wal.close()


# ---------------------------------------------------------------------------
# State capture / restore helpers
# ---------------------------------------------------------------------------
_UNBOUNDED_CFG_FIELDS = ("ttl", "seal_max_age")    # inf <-> null in JSON


def _encode_cfg(cfg) -> dict:
    """StreamConfig -> strict-JSON-safe dict (``inf`` policy knobs become
    ``null``; nested index cfg expanded)."""
    out = dataclasses.asdict(cfg)
    out["index_cfg"] = dataclasses.asdict(cfg.index_cfg)
    for key in _UNBOUNDED_CFG_FIELDS:
        if not math.isfinite(out[key]):
            out[key] = None
    return out


def _decode_cfg(blob: dict, persist_dir: Optional[str]):
    """Inverse of :func:`_encode_cfg`; rebinds ``persist_dir``."""
    from .manager import StreamConfig
    kw = dict(blob)
    for key in _UNBOUNDED_CFG_FIELDS:
        if kw.get(key) is None:
            kw[key] = math.inf
    kw["index_cfg"] = CubeGraphConfig(**kw["index_cfg"])
    kw["persist_dir"] = persist_dir
    return StreamConfig(**kw)


def _encode_state(manager) -> bytes:
    """The mutable residue outside segment artifacts, as one npz blob:
    liveness bitmap (bit-packed), delta-buffer rows (including lazily
    deleted ones, preserving order), and resident point-store chunks."""
    import io
    delta = manager.delta
    store = manager.store
    chunk_ids = np.sort(np.fromiter(store._chunks, np.int64,
                                    len(store._chunks)))
    buf = io.BytesIO()
    np.savez(
        buf,
        alive=np.packbits(np.ascontiguousarray(manager.alive)),
        delta_x=delta.x[: delta.size], delta_s=delta.s[: delta.size],
        delta_gids=delta.gids[: delta.size],
        delta_valid=delta.valid[: delta.size],
        store_chunk_ids=chunk_ids,
        store_x=np.stack([store._chunks[int(c)][0] for c in chunk_ids])
        if len(chunk_ids) else np.zeros((0, store.chunk, store.d), np.float32),
        store_s=np.stack([store._chunks[int(c)][1] for c in chunk_ids])
        if len(chunk_ids) else np.zeros((0, store.chunk, store.m), np.float64),
    )
    return buf.getvalue()


def restore_manager(root: str, cfg=None, device=None, resume: bool = True,
                    mmap_segments: Optional[bool] = None, shard_mesh=None):
    """Rebuild a :class:`SegmentManager` from a snapshot directory.

    Loads the last published manifest (checksum-verified), mmaps segment
    artifacts, reconstructs the liveness bitmap / delta buffer / point
    store, replays the WAL tail, and re-derives per-segment validity from
    the final bitmap.  The manager and its indexes live on ``device``
    (default: the card); ``shard_mesh`` spreads its pack's bucket rows
    over the mesh's cards (home card = ``device``).  A snapshot does not
    record where it ran, so one taken on a mesh restores on one card and
    the other way round.  With ``resume`` (default) the manager re-attaches
    to ``root`` and keeps persisting; pass ``resume=False`` for a read-only
    clone (e.g. a serving replica warm-starting from a shared export).

    The restored manager honors ``StreamConfig.device_budget_bytes``
    (persisted, or overridden via ``cfg``): its first sharded query
    cold-builds the bucket blocks *host-side* from the mmapped artifacts
    and admits only the most-recent buckets that fit the budget
    (``SegmentManager._tier_warm_admit``), instead of staging the whole
    corpus on device before answering.
    """
    import io

    from .manager import SegmentManager
    from .segments import grow_rows

    man = load_manifest(root)
    if man.get("format") != MANIFEST_FORMAT:
        raise RestoreError(f"unknown manifest format {man.get('format')!r}")
    state_path = os.path.join(root, man["state_file"])
    with open(state_path, "rb") as f:
        state_bytes = f.read()
    if zlib.crc32(state_bytes) != man["state_crc"]:
        raise RestoreError(f"checksum mismatch for {man['state_file']}")

    if cfg is None:
        cfg = _decode_cfg(man["cfg"],
                          os.path.abspath(root) if resume else None)
    else:
        # a cfg override may change policy (seal thresholds, n_shards,
        # ttl, index build params) but never the on-disk geometry the
        # snapshot was written with — silently re-keying the point store
        # or re-interpreting the time column would corrupt the state
        saved = man["cfg"]
        if cfg.store_chunk != saved["store_chunk"]:
            raise RestoreError(
                f"cfg.store_chunk={cfg.store_chunk} does not match the "
                f"snapshot's store_chunk={saved['store_chunk']}")
        if cfg.time_dim % man["m"] != saved["time_dim"] % man["m"]:
            raise RestoreError(
                f"cfg.time_dim={cfg.time_dim} does not match the "
                f"snapshot's time_dim={saved['time_dim']} (m={man['m']})")
    mgr = SegmentManager(man["d"], man["m"], cfg, device=device,
                         shard_mesh=shard_mesh, _restoring=True)

    with np.load(io.BytesIO(state_bytes)) as z:
        n_total = int(man["n_total"])
        alive = np.unpackbits(z["alive"], count=n_total).astype(bool) \
            if n_total else np.zeros(0, bool)
        cap = len(mgr._alive)
        while cap < n_total:
            cap *= 2
        mgr._alive = np.zeros(cap, bool)
        mgr._alive[:n_total] = alive
        # -- point store ----------------------------------------------
        mgr.store.n_total = n_total
        for i, ci in enumerate(z["store_chunk_ids"]):
            mgr.store._chunks[int(ci)] = (np.array(z["store_x"][i]),
                                          np.array(z["store_s"][i]))
        # -- delta buffer (row order preserved, invalid rows included) --
        dx, ds = np.array(z["delta_x"]), np.array(z["delta_s"])
        dg, dv = np.array(z["delta_gids"]), np.array(z["delta_valid"])
    size = len(dg)
    mgr.delta.x, mgr.delta.s, mgr.delta.gids, mgr.delta.valid = grow_rows(
        max(size, 16), (mgr.delta.x, 0.0), (mgr.delta.s, 0.0),
        (mgr.delta.gids, -1), (mgr.delta.valid, False))
    mgr.delta.x[:size] = dx
    mgr.delta.s[:size] = ds
    mgr.delta.gids[:size] = dg
    mgr.delta.valid[:size] = dv
    mgr.delta.size = size
    if size:
        t = ds[:, mgr.time_dim]
        mgr.delta.t_min, mgr.delta.t_max = float(t.min()), float(t.max())

    mmap = cfg.mmap_segments if mmap_segments is None else mmap_segments
    for entry in man["segments"]:
        seg = load_segment_artifact(os.path.join(root, entry["dir"]),
                                    mmap_mode="r" if mmap else None,
                                    device=mgr.device)
        seg.artifacts[os.path.abspath(root)] = entry["dir"]
        mgr.segments.append(seg)

    mgr.now = float(man["now"]) if man["now"] is not None else -math.inf
    mgr.epoch = int(man["epoch"])
    mgr._next_seg_id = int(man["next_seg_id"])
    mgr.counters.update(man["counters"])

    # -- WAL tail: every acknowledged op after the checkpoint ----------
    wal_path = os.path.join(root, man["wal_file"])
    records, wal_end = WriteAheadLog.scan(wal_path, man["wal_offset"])
    reg = mgr.obs.registry
    reg.counter("recovery_restores_total").inc()
    reg.counter("recovery_replayed_records_total").inc(len(records))
    _REC_NAMES = {REC_INGEST: "ingest", REC_DELETE: "delete", REC_GC: "gc"}
    for rec_type, rec in records:
        reg.counter('recovery_replayed_records_total'
                    f'{{type="{_REC_NAMES[rec_type]}"}}').inc()
        if rec_type == REC_INGEST:
            gid0, x, s = rec
            if gid0 != mgr.store.n_total:
                raise RestoreError(
                    f"WAL ingest at gid {gid0} does not extend the store "
                    f"(n_total={mgr.store.n_total})")
            mgr._apply_ingest(np.array(x), np.array(s))
        elif rec_type == REC_DELETE:
            mgr._apply_delete(np.array(rec))
        elif rec_type == REC_GC:
            freed = mgr.store.free_chunks(np.array(rec))
            mgr.counters["store_gc_points"] += freed

    # -- per-segment validity is derived state: alive[gids] -----------
    for seg in mgr.segments:
        seg.index.valid[:] = mgr.alive[seg.gids]

    crc = zlib.crc32(np.packbits(np.ascontiguousarray(mgr.alive)).tobytes())
    if not records and crc != man["alive_crc"]:
        raise RestoreError("liveness bitmap checksum mismatch")

    if resume:
        # drop any torn tail so fresh appends extend the durable prefix
        # (a record hiding behind a torn frame would never replay)
        try:
            if os.path.getsize(wal_path) > wal_end:
                with open(wal_path, "r+b") as f:
                    f.truncate(wal_end)
        except OSError:                  # pragma: no cover - platform quirk
            pass
        mgr.persist = StreamPersistence(root, cfg.wal_fsync_every,
                                        metrics=mgr.obs.registry)
    return mgr
