"""Per-tenant collections over ONE shared streaming substrate — the
counterpart of ``repro.serving.tenancy``.

A :class:`MultiTenantStore` multiplexes many tenant **collections** onto a
single :class:`~repro_torch.streaming.SegmentManager` — one device pack on
one card, one device budget, one WAL — while keeping the tenants
logically isolated:

* **gid-spaces** — every point belongs to exactly one collection (the
  store records the owner of each gid it hands out); cross-tenant
  ``delete`` or document materialization raises
  :class:`TenantIsolationError` instead of silently touching another
  tenant's data;
* **metadata tagging** — the store appends one hidden metadata column
  (``tenant_dim == m_user``) holding the collection's numeric tenant id,
  and every query is automatically scoped with an
  ``IntervalFilter(dim=tenant_dim, lo=tid-0.5, hi=tid+0.5)`` conjunction.
  The scoped filter stays kernel-encodable for box/interval/ball user
  filters, so tenant isolation costs nothing on the fused scan path;
* **per-tenant accounting** — each collection carries its own
  :class:`~repro_torch.obs.metrics.BucketStats` accumulator (fed by the serving
  tier's grouped dispatches) and its ingest/delete/live counters land in
  the shared registry under ``{tenant="<name>"}`` labels;
* **per-tenant snapshot layout** — :meth:`MultiTenantStore.snapshot_to`
  writes the shared substrate once (``<root>/substrate/``) plus one
  catalog directory per tenant (``<root>/tenants/<name>/``) holding that
  collection's document payloads, so a restore rebuilds both the index
  state and every tenant's document mapping.

**Isolation = correctness, bit for bit.**  Kernel B1 computes every
``(query, point)`` distance with the same fp32 arithmetic whatever other
rows share the device block, and gid order within a tenant equals its
ingestion order in a single-tenant store, so a collection's answers are
bit for bit those of a dedicated single-tenant store holding only its
documents — whatever other tenants ingest, delete or query concurrently
(``tests/test_torch_service.py`` asserts it against racing writers).

Quotas here bound **stored live points per tenant** (admission control
for *requests* lives in ``serving/service.py``): an ``insert`` that would
exceed ``quota_points`` raises :class:`TenantQuotaError` before touching
the substrate.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import (BoxFilter, ComposeFilter, CubeGraphConfig, Filter,
                    IntervalFilter, PolygonFilter)
from ..obs import json_sanitize
from ..obs.metrics import BucketStats
from ..streaming import SegmentManager, StreamConfig
from .rag import Document

__all__ = ["Collection", "MultiTenantStore", "TenantIsolationError",
           "TenantQuotaError", "TenantAnswer"]


class TenantQuotaError(RuntimeError):
    """An insert would push a collection past its ``quota_points``."""


class TenantIsolationError(RuntimeError):
    """A tenant operation referenced a gid owned by another collection."""


@dataclasses.dataclass
class TenantAnswer:
    """One tenant's retrieval answer: materialized documents plus the raw
    ``(gid, dist)`` rows and the degraded-result marker carried over from
    the streaming :class:`~repro_torch.streaming.resilience.QueryResult`."""

    docs: List[List[Document]]
    gids: np.ndarray                 # [b, k] int64, -1 padded
    dists: np.ndarray                # [b, k] fp32, +inf padded
    degraded: bool = False
    reasons: Optional[dict] = None


@dataclasses.dataclass
class Collection:
    """One tenant's namespace: its numeric id, live-document mapping,
    point quota, and per-tenant bucket accounting."""

    name: str
    tid: int
    quota_points: Optional[int] = None
    docs_by_gid: Dict[int, Document] = dataclasses.field(
        default_factory=dict)
    bucket_stats: BucketStats = dataclasses.field(
        default_factory=BucketStats)

    @property
    def n_live(self) -> int:
        """Live (inserted minus deleted) points in this collection."""
        return len(self.docs_by_gid)


class MultiTenantStore:
    """Many tenant collections sharing one streaming substrate.

    ``d_emb`` / ``m`` describe the *user-visible* schema (embedding dims,
    metadata dims); the underlying manager runs with ``m + 1`` metadata
    dims — the hidden trailing column holds the tenant id.  The manager's
    temporal column is resolved against the user schema **before** the
    tenant column is appended, so ``StreamConfig(time_dim=-1)`` keeps
    meaning "last user metadata dim", never the tenant tag.

    The sharded read path is forced on (``n_shards >= 1``) — the
    serving tier's continuous filtered batching
    (:meth:`~repro_torch.streaming.SegmentManager.query_grouped`) shares
    per-bucket device reads across tenants, which needs the bucketed
    pack.  The substrate lives on ``device`` (default: the card).
    """

    def __init__(self, d_emb: int, m: int,
                 stream_cfg: Optional[StreamConfig] = None,
                 index_cfg: Optional[CubeGraphConfig] = None,
                 device=None):
        if stream_cfg is None:
            stream_cfg = StreamConfig(
                index_cfg=index_cfg or CubeGraphConfig())
        elif index_cfg is not None:
            stream_cfg = dataclasses.replace(stream_cfg,
                                             index_cfg=index_cfg)
        self.m_user = int(m)
        self.tenant_dim = int(m)
        # resolve time_dim in USER coordinates before widening the schema:
        # the manager would otherwise resolve the default -1 to the
        # appended tenant column and temporally prune on tenant ids
        stream_cfg = dataclasses.replace(
            stream_cfg, time_dim=stream_cfg.time_dim % self.m_user,
            n_shards=max(stream_cfg.n_shards, 1))
        self.manager = SegmentManager(d_emb, self.m_user + 1, stream_cfg,
                                      device=device)
        self.obs = self.manager.obs
        self.metrics = self.obs.registry
        self.collections: Dict[str, Collection] = {}
        self._lock = threading.Lock()
        self._next_tid = 1

    # -- collection lifecycle ------------------------------------------

    def create_collection(self, name: str,
                          quota_points: Optional[int] = None) -> Collection:
        """Register a new tenant namespace (its numeric id is assigned
        here and never reused)."""
        with self._lock:
            if name in self.collections:
                raise ValueError(f"collection {name!r} already exists")
            coll = Collection(name=name, tid=self._next_tid,
                              quota_points=quota_points)
            self._next_tid += 1
            self.collections[name] = coll
        return coll

    def collection(self, tenant: str) -> Collection:
        """Look up a collection by name (KeyError when unknown)."""
        return self.collections[tenant]

    # -- tenant scoping ------------------------------------------------

    def isolation_filter(self, tenant: str) -> Filter:
        """The hidden-column predicate restricting a query to one tenant's
        rows (kernel-encodable interval around the integer tenant id)."""
        tid = self.collections[tenant].tid
        return IntervalFilter(dim=self.tenant_dim, lo=tid - 0.5,
                              hi=tid + 0.5)

    def _widen(self, f: Filter) -> Filter:
        """Re-express a user filter (bounds over the user's ``m`` dims)
        against the substrate's ``m + 1``-wide schema: box/polygon bounds
        gain an unconstrained trailing (tenant) dim; interval/ball filters
        address dim prefixes and pass through unchanged."""
        extra = self.m_user + 1
        if isinstance(f, BoxFilter):
            lo = np.asarray(f.lo, np.float32)
            hi = np.asarray(f.hi, np.float32)
            if len(lo) < extra:
                lo = np.concatenate(
                    [lo, np.full(extra - len(lo), -np.inf, np.float32)])
                hi = np.concatenate(
                    [hi, np.full(extra - len(hi), np.inf, np.float32)])
            return BoxFilter(lo=lo, hi=hi)
        if isinstance(f, PolygonFilter):
            rlo = np.asarray(f.rest_lo, np.float32)
            rhi = np.asarray(f.rest_hi, np.float32)
            if 2 + len(rlo) < extra:
                pad = extra - 2 - len(rlo)
                rlo = np.concatenate(
                    [rlo, np.full(pad, -np.inf, np.float32)])
                rhi = np.concatenate(
                    [rhi, np.full(pad, np.inf, np.float32)])
            return PolygonFilter(vertices=f.vertices, rest_lo=rlo,
                                 rest_hi=rhi)
        if isinstance(f, ComposeFilter):
            return ComposeFilter(self._widen(f.a), self._widen(f.b), f.op)
        return f

    def scoped_filter(self, tenant: str,
                      filt: Optional[Filter]) -> Filter:
        """Conjoin a user filter (over the user's ``m`` dims) with the
        tenant isolation predicate; the composition stays
        kernel-encodable whenever the user filter is."""
        iso = self.isolation_filter(tenant)
        return iso if filt is None else ComposeFilter(self._widen(filt),
                                                      iso, "and")

    # -- writes --------------------------------------------------------

    def insert(self, tenant: str, docs: Sequence[Document]) -> np.ndarray:
        """Ingest documents into one collection (quota-checked); returns
        the assigned global ids."""
        coll = self.collections[tenant]
        with self._lock:
            if coll.quota_points is not None and \
                    coll.n_live + len(docs) > coll.quota_points:
                raise TenantQuotaError(
                    f"collection {tenant!r} holds {coll.n_live} live "
                    f"points; inserting {len(docs)} exceeds its quota of "
                    f"{coll.quota_points}")
            x = np.stack([d.embedding for d in docs]).astype(np.float32)
            s = np.stack([d.metadata for d in docs]).astype(np.float64)
            s = np.concatenate(
                [s, np.full((len(docs), 1), float(coll.tid))], axis=1)
            gids = self.manager.ingest(x, s)
            for g, d in zip(np.asarray(gids).tolist(), docs):
                coll.docs_by_gid[int(g)] = d
        self.metrics.counter(
            f'tenant_ingested_points_total{{tenant="{tenant}"}}'
        ).inc(len(docs))
        self.metrics.gauge(
            f'tenant_live_points{{tenant="{tenant}"}}').set(coll.n_live)
        return np.asarray(gids, np.int64)

    def delete(self, tenant: str, gids: Sequence[int]) -> int:
        """Lazy-delete a collection's own points; a gid owned by another
        tenant (or by nobody) raises :class:`TenantIsolationError` and
        deletes nothing."""
        coll = self.collections[tenant]
        gids = [int(g) for g in np.asarray(gids, np.int64).tolist()]
        with self._lock:
            foreign = [g for g in gids if g not in coll.docs_by_gid]
            if foreign:
                raise TenantIsolationError(
                    f"collection {tenant!r} does not own gids {foreign}")
            n = self.manager.delete(np.asarray(gids, np.int64))
            for g in gids:
                coll.docs_by_gid.pop(g, None)
        self.metrics.counter(
            f'tenant_deleted_points_total{{tenant="{tenant}"}}').inc(
                len(gids))
        self.metrics.gauge(
            f'tenant_live_points{{tenant="{tenant}"}}').set(coll.n_live)
        return n

    # -- reads ---------------------------------------------------------

    def materialize(self, tenant: str, gids: np.ndarray
                    ) -> List[List[Document]]:
        """Map answer gid rows to the tenant's documents.  A gid outside
        the collection means the isolation predicate was breached — that
        is a hard error, never a silent cross-tenant document leak."""
        coll = self.collections[tenant]
        out: List[List[Document]] = []
        for row in np.asarray(gids):
            docs = []
            for g in row:
                if g < 0:
                    continue
                d = coll.docs_by_gid.get(int(g))
                if d is None:
                    raise TenantIsolationError(
                        f"answer gid {int(g)} is not owned by collection "
                        f"{tenant!r} — isolation predicate breached")
                docs.append(d)
            out.append(docs)
        return out

    def retrieve(self, tenant: str, query_emb: np.ndarray,
                 filt: Optional[Filter] = None, k: int = 10, ef: int = 64,
                 deadline_ms: Optional[float] = None,
                 read_path: Optional[str] = None,
                 trace=None) -> TenantAnswer:
        """Tenant-scoped filtered top-k retrieval (one solo query; the
        serving tier batches heterogeneous requests instead — same
        answers bit-for-bit)."""
        q = np.atleast_2d(np.asarray(query_emb, np.float32))
        res = self.manager.query(q, self.scoped_filter(tenant, filt), k=k,
                                 ef=ef, deadline_ms=deadline_ms,
                                 read_path=read_path, trace=trace)
        gids, dists = res
        degraded = bool(getattr(res, "degraded", False))
        reasons = dict(getattr(res, "reasons", {}) or {})
        self.metrics.counter(
            f'tenant_requests_total{{tenant="{tenant}"}}').inc(q.shape[0])
        return TenantAnswer(docs=self.materialize(tenant, gids),
                            gids=np.asarray(gids, np.int64),
                            dists=np.asarray(dists, np.float32),
                            degraded=degraded, reasons=reasons)

    # -- lifecycle / stats / persistence -------------------------------

    def maintenance(self, async_compaction: bool = False) -> dict:
        """Shared substrate lifecycle tick (seal / TTL / compaction)."""
        return self.manager.maintenance(async_compaction=async_compaction)

    def stats(self) -> dict:
        """Substrate ``stats()`` plus a ``tenants`` block: per collection
        its id, liveness, quota, and per-tenant ``BucketStats``."""
        out = self.manager.stats()
        out["tenants"] = {
            name: {
                "tid": coll.tid,
                "live_points": coll.n_live,
                "quota_points": coll.quota_points,
                "buckets": coll.bucket_stats.snapshot(),
            }
            for name, coll in sorted(self.collections.items())
        }
        return json_sanitize(out)

    def metrics_snapshot(self) -> dict:
        """Strict-JSON observability export (shared registry + per-tenant
        blocks)."""
        return self.stats()

    def snapshot_to(self, root: str) -> dict:
        """Durable snapshot: shared substrate under ``<root>/substrate``,
        one catalog per tenant under ``<root>/tenants/<name>`` (document
        payloads stored as plain npz + json — no pickling)."""
        root_p = pathlib.Path(root)
        manifest = self.manager.snapshot_to(str(root_p / "substrate"))
        for name, coll in self.collections.items():
            tdir = root_p / "tenants" / name
            tdir.mkdir(parents=True, exist_ok=True)
            gids = sorted(coll.docs_by_gid)
            docs = [coll.docs_by_gid[g] for g in gids]
            tokens = ([d.tokens.astype(np.int32) for d in docs]
                      if docs else [])
            offsets = np.zeros(len(docs) + 1, np.int64)
            if docs:
                offsets[1:] = np.cumsum([len(t) for t in tokens])
            np.savez(
                tdir / "catalog.npz",
                gids=np.asarray(gids, np.int64),
                doc_ids=np.asarray([d.doc_id for d in docs], np.int64),
                embeddings=(np.stack([d.embedding for d in docs])
                            .astype(np.float32) if docs
                            else np.zeros((0, 0), np.float32)),
                metadata=(np.stack([d.metadata for d in docs])
                          .astype(np.float64) if docs
                          else np.zeros((0, 0), np.float64)),
                tokens=(np.concatenate(tokens) if docs
                        else np.zeros(0, np.int32)),
                token_offsets=offsets)
            (tdir / "catalog.json").write_text(json.dumps({
                "name": name, "tid": coll.tid,
                "quota_points": coll.quota_points,
                "n_live": coll.n_live}))
        (root_p / "tenants.json").write_text(json.dumps({
            "next_tid": self._next_tid,
            "tenants": sorted(self.collections)}))
        return manifest

    @classmethod
    def restore(cls, root: str, d_emb: int, m: int,
                stream_cfg: Optional[StreamConfig] = None,
                device=None, resume: bool = True) -> "MultiTenantStore":
        """Rebuild the store from a :meth:`snapshot_to` directory: the
        substrate restores on ``device`` via ``SegmentManager.restore``
        (bit-for-bit query parity) and every tenant catalog rebuilds its
        gid→document mapping.  The layout is the reference's, so either
        package restores the other's snapshot."""
        root_p = pathlib.Path(root)
        obj = cls.__new__(cls)
        obj.m_user = int(m)
        obj.tenant_dim = int(m)
        obj.manager = SegmentManager.restore(
            str(root_p / "substrate"), cfg=stream_cfg, device=device,
            resume=resume)
        obj.obs = obj.manager.obs
        obj.metrics = obj.obs.registry
        obj.collections = {}
        obj._lock = threading.Lock()
        meta = json.loads((root_p / "tenants.json").read_text())
        obj._next_tid = int(meta["next_tid"])
        for name in meta["tenants"]:
            tdir = root_p / "tenants" / name
            cat = json.loads((tdir / "catalog.json").read_text())
            coll = Collection(name=name, tid=int(cat["tid"]),
                              quota_points=cat["quota_points"])
            with np.load(tdir / "catalog.npz") as z:
                offs = z["token_offsets"]
                for i, g in enumerate(z["gids"].tolist()):
                    coll.docs_by_gid[int(g)] = Document(
                        doc_id=int(z["doc_ids"][i]),
                        tokens=z["tokens"][offs[i]:offs[i + 1]],
                        embedding=z["embeddings"][i],
                        metadata=z["metadata"][i])
            obj.collections[name] = coll
            obj.metrics.gauge(
                f'tenant_live_points{{tenant="{name}"}}').set(coll.n_live)
        return obj
