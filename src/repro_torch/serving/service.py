"""Multi-tenant serving front end: admission control + continuous
filtered batching over one shared streaming substrate — the counterpart of
``repro.serving.service``.

:class:`CubeGraphService` is the request loop of the serving tier, layered
over :class:`~repro_torch.serving.tenancy.MultiTenantStore`:

* **admission control** — :class:`AdmissionController` enforces
  per-tenant queue-depth quotas and a global in-flight cap at ``submit``
  time.  A rejected request gets an explicit
  :class:`~repro_torch.serving.batching.RetrievalFailure` with
  ``reason="over_quota"`` (backpressure the client can see and retry on)
  and bumps ``tenant_rejected_total{tenant=...}`` — it is never silently
  dropped and never poisons the queue;

* **continuous filtered batching** — ``flush()`` drains the queue and
  generalizes :class:`~repro_torch.serving.batching.RetrievalBatcher`:
  instead of requiring identical filter keys, heterogeneous ``(tenant,
  filter, k, deadline)`` requests become one
  :class:`~repro_torch.streaming.GroupQuery` list answered by
  ``SegmentManager.query_grouped`` — every sealed bucket's device block is
  read once for all tenants and filters active in it (one B1 launch per
  filter class), and each group's answer is bit for bit what a solo
  ``MultiTenantStore.retrieve`` returns.  Per-group bucket observations
  feed each tenant's own :class:`~repro_torch.obs.metrics.BucketStats`,
  so the cost planner's inputs stay tenant-attributed;

* **per-request SLOs** — each request may carry ``deadline_ms`` (the
  :class:`~repro_torch.streaming.resilience.Deadline` machinery); an
  overrun group is dropped from the *remaining* buckets only — other
  tenants keep scanning — and its answers come back with
  ``degraded=True`` plus per-reason skip counts;

* **async loop** — ``start()`` runs ``flush()`` on a supervised daemon
  thread (the manager's
  :class:`~repro_torch.streaming.resilience.Supervisor`, so loop crashes
  are retried, counted and surfaced in ``health()`` instead of
  vanishing).

Failure isolation mirrors ``RetrievalBatcher``: if the shared grouped
dispatch raises, ``flush()`` falls back to per-group solo queries, each
in its own try — one poisoned filter cannot black-hole the whole flush.
Each such fallback counts in ``retrieval_grouped_fallback_total`` and each
request that fails in ``retrieval_failed_total``, so a caller can tell a
flush that shared its bucket reads from one that did not.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..core import Filter
from ..streaming import GroupQuery
from .batching import RetrievalFailure, _filter_key
from .rag import Document
from .tenancy import MultiTenantStore

__all__ = ["AdmissionController", "CubeGraphService", "ServeRequest",
           "ServeResult"]


@dataclasses.dataclass
class ServeRequest:
    """One tenant retrieval request: a single query embedding plus its
    filter, fan-out, and optional per-request SLO budget."""

    req_id: int
    tenant: str
    query_emb: np.ndarray            # [d_emb]
    filt: Optional[Filter] = None
    k: int = 10
    deadline_ms: Optional[float] = None
    enqueued_at: float = 0.0         # stamped by CubeGraphService.submit


@dataclasses.dataclass
class ServeResult:
    """One answered request: materialized documents, the raw ``(gid,
    dist)`` row, degraded markers, and the measured queue-to-answer
    latency."""

    req_id: int
    tenant: str
    docs: List[Document]
    gids: np.ndarray                 # [k] int64, -1 padded
    dists: np.ndarray                # [k] fp32, +inf padded
    degraded: bool = False
    reasons: Optional[dict] = None
    latency_ms: float = 0.0


class AdmissionController:
    """Queue-depth admission: per-tenant quotas + a global cap.

    ``max_queue_per_tenant`` bounds how many requests one tenant may have
    queued (overridable per tenant via ``tenant_quotas``);
    ``max_queue_total`` bounds the whole queue.  :meth:`try_admit`
    returns ``None`` to admit or a stable rejection reason string —
    the service turns that into
    ``RetrievalFailure(reason="over_quota")`` backpressure.
    """

    def __init__(self, max_queue_per_tenant: int = 64,
                 max_queue_total: Optional[int] = None,
                 tenant_quotas: Optional[Dict[str, int]] = None):
        self.max_queue_per_tenant = int(max_queue_per_tenant)
        self.max_queue_total = (None if max_queue_total is None
                                else int(max_queue_total))
        self.tenant_quotas = dict(tenant_quotas or {})

    def try_admit(self, tenant: str, tenant_depth: int,
                  total_depth: int) -> Optional[str]:
        """``None`` = admit; otherwise the rejection reason."""
        if self.max_queue_total is not None \
                and total_depth >= self.max_queue_total:
            return "over_quota"
        quota = self.tenant_quotas.get(tenant, self.max_queue_per_tenant)
        if tenant_depth >= quota:
            return "over_quota"
        return None


class CubeGraphService:
    """The serving front end: submit -> (admission) -> queue ->
    continuous filtered batching -> per-tenant answers.

    ``flush()`` is synchronous (drain everything queued now); ``start()``
    runs it continuously on a supervised daemon thread.  Results are
    returned from ``flush()`` *and* retained in :attr:`results` keyed by
    ``req_id`` (popped by :meth:`take_result`) so async-loop clients can
    poll.  ``maintenance_every > 0`` triggers one substrate lifecycle
    tick (async compaction) every that-many flushes, exactly like
    ``RetrievalBatcher``.
    """

    def __init__(self, store: MultiTenantStore,
                 admission: Optional[AdmissionController] = None,
                 ef: int = 64, max_batch: int = 64,
                 maintenance_every: int = 0):
        self.store = store
        self.admission = admission or AdmissionController()
        self.ef = int(ef)
        self.max_batch = int(max_batch)
        self.maintenance_every = int(maintenance_every)
        self._flushes = 0
        self.queue: deque = deque()
        self.results: Dict[int, object] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.metrics = store.metrics

    # -- submission / admission ----------------------------------------

    def _depths(self) -> Dict[str, int]:
        depths: Dict[str, int] = {}
        for r in self.queue:
            depths[r.tenant] = depths.get(r.tenant, 0) + 1
        return depths

    def submit(self, req: ServeRequest) -> Optional[RetrievalFailure]:
        """Admit a request into the queue, or reject it with explicit
        backpressure: returns ``None`` when admitted, else a
        :class:`RetrievalFailure` with ``reason="over_quota"`` (also
        recorded in :attr:`results` so pollers see it)."""
        if req.tenant not in self.store.collections:
            raise KeyError(f"unknown collection {req.tenant!r}")
        with self._lock:
            depths = self._depths()
            reason = self.admission.try_admit(
                req.tenant, depths.get(req.tenant, 0), len(self.queue))
            if reason is None:
                if not req.enqueued_at:
                    req.enqueued_at = time.perf_counter()
                self.queue.append(req)
                return None
        self.metrics.counter(
            f'tenant_rejected_total{{tenant="{req.tenant}"}}').inc()
        failure = RetrievalFailure(
            req.req_id, f"tenant {req.tenant!r} queue depth exceeded",
            reason=reason)
        with self._lock:
            self.results[req.req_id] = failure
        return failure

    def __len__(self) -> int:
        return len(self.queue)

    def take_result(self, req_id: int):
        """Pop one finished request's :class:`ServeResult` /
        :class:`RetrievalFailure` (None if not finished yet)."""
        with self._lock:
            return self.results.pop(req_id, None)

    # -- the batched dispatch ------------------------------------------

    def flush(self) -> Dict[int, object]:
        """Drain the queue through ONE continuous filtered batch.

        Queued requests group by ``(tenant, filter value, k, deadline)``
        — chunked at ``max_batch`` — and every group becomes one
        tenant-scoped :class:`GroupQuery`; the whole heterogeneous batch
        then shares per-bucket device reads in a single
        ``query_grouped`` pass.  Returns (and retains in
        :attr:`results`) ``{req_id: ServeResult | RetrievalFailure}``.
        """
        with self._lock:
            drained: List[ServeRequest] = list(self.queue)
            self.queue.clear()
        out: Dict[int, object] = {}
        if drained:
            grouped: Dict[object, List[ServeRequest]] = {}
            for r in drained:
                grouped.setdefault(
                    (r.tenant, _filter_key(r.filt, r.k), r.deadline_ms),
                    []).append(r)
            chunks: List[List[ServeRequest]] = []
            for reqs in grouped.values():
                for lo in range(0, len(reqs), self.max_batch):
                    chunks.append(reqs[lo:lo + self.max_batch])
            t_flush = time.perf_counter()
            wait_hist = self.metrics.histogram("retrieval_queue_wait_ms")
            occ_hist = self.metrics.histogram("retrieval_batch_occupancy")
            for chunk in chunks:
                occ_hist.observe(len(chunk) / self.max_batch)
                for r in chunk:
                    if r.enqueued_at:
                        wait_hist.observe((t_flush - r.enqueued_at) * 1e3)
            gqs = [GroupQuery(
                np.stack([r.query_emb for r in chunk]).astype(np.float32),
                self.store.scoped_filter(chunk[0].tenant, chunk[0].filt),
                k=chunk[0].k, ef=self.ef,
                deadline_ms=chunk[0].deadline_ms) for chunk in chunks]
            stats_of = [self.store.collections[c[0].tenant].bucket_stats
                        for c in chunks]

            def observe_group(gi, cap, **kw):
                stats_of[gi].observe(cap, **kw)

            try:
                answers = self.store.manager.query_grouped(
                    gqs, observe_group=observe_group)
                for chunk, res in zip(chunks, answers):
                    self._finish_chunk(out, chunk, res, t_flush)
            except Exception:  # noqa: BLE001 — isolate per group instead
                self.metrics.counter(
                    "retrieval_grouped_fallback_total").inc()
                for chunk, gq in zip(chunks, gqs):
                    try:
                        res = self.store.manager.query(
                            gq.queries, gq.filt, k=gq.k, ef=gq.ef,
                            deadline_ms=gq.deadline_ms)
                        self._finish_chunk(out, chunk, res, t_flush)
                    except Exception as exc:  # noqa: BLE001
                        self.metrics.counter(
                            "retrieval_failed_total").inc(len(chunk))
                        for r in chunk:
                            out[r.req_id] = RetrievalFailure(
                                r.req_id,
                                f"{type(exc).__name__}: {exc}")
        with self._lock:
            self.results.update(out)
        self._flushes += 1
        if (self.maintenance_every > 0
                and self._flushes % self.maintenance_every == 0):
            self.store.maintenance(async_compaction=True)
        return out

    def _finish_chunk(self, out: Dict[int, object],
                      chunk: List[ServeRequest], res, t_flush: float
                      ) -> None:
        """Split one answered group back into per-request results."""
        tenant = chunk[0].tenant
        gids = np.asarray(res[0], np.int64)
        dists = np.asarray(res[1], np.float32)
        degraded = bool(getattr(res, "degraded", False))
        reasons = dict(getattr(res, "reasons", {}) or {})
        docs = self.store.materialize(tenant, gids)
        now = time.perf_counter()
        lat_hist = self.metrics.histogram(
            f'tenant_request_ms{{tenant="{tenant}"}}')
        self.metrics.counter(
            f'tenant_requests_total{{tenant="{tenant}"}}').inc(len(chunk))
        if degraded:
            self.metrics.counter(
                f'tenant_degraded_total{{tenant="{tenant}"}}').inc(
                    len(chunk))
        for i, r in enumerate(chunk):
            lat = (now - (r.enqueued_at or t_flush)) * 1e3
            lat_hist.observe(lat)
            out[r.req_id] = ServeResult(
                req_id=r.req_id, tenant=tenant, docs=docs[i],
                gids=gids[i], dists=dists[i], degraded=degraded,
                reasons=reasons, latency_ms=lat)

    # -- async loop ----------------------------------------------------

    def start(self, interval_ms: float = 5.0) -> None:
        """Run the request loop on a supervised daemon thread: flush
        whenever work is queued, sleeping ``interval_ms`` between polls.
        Idempotent (at most one loop thread per service)."""
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                if self.queue:
                    self.flush()
                else:
                    self._stop.wait(interval_ms / 1e3)

        self.store.manager.supervisor.spawn("serving.loop", _loop)

    def stop(self) -> None:
        """Signal the async loop to exit (it drains nothing further)."""
        self._stop.set()
