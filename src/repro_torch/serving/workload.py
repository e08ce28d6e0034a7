"""Geo-temporal traffic harness for the multi-tenant serving tier — the
counterpart of ``repro.serving.workload``.

Drives :class:`~repro_torch.serving.service.CubeGraphService` with the
traffic
shape the paper's serving scenario describes, and measures what a real
deployment would watch:

* **moving time windows** — every step advances the stream clock; queries
  filter ``[now - window, now]``, so temporal pruning and the tiered
  prefetch predictor see a drifting window, not a static corpus;
* **skewed hot regions** — queries pick one of a few spatial hot spots
  with a Zipf-like weight (region 1 dominates), composed as a
  ``(spatial box ∧ time window)`` filter per request;
* **ingest bursts mid-query** — every ``burst_every`` steps each tenant
  ingests a burst *between* query flushes, so answers race seals and
  delta growth exactly as they would in production; a trickle of deletes
  rides along;
* **per-request SLOs** — a configurable fraction of requests carry
  ``deadline_ms``; the report separates SLO violations (answer later
  than ``slo_ms``) from degraded answers (deadline machinery skipped
  buckets).

Every answer is scored against a **numpy brute-force oracle** over the
tenant's live documents (recall@k on non-degraded answers — the exact
scan path must hold recall 1.0), and each step runs a **bit-for-bit
isolation probe**: one no-deadline request per tenant whose documents
and distances must exactly equal a dedicated single-tenant oracle
``DocumentStore`` that replayed only that tenant's writes.

``python -m repro_torch.serving.workload --smoke`` runs a tiny
configuration on the card and asserts the report schema
(:data:`SLO_REPORT_KEYS`); ``--device cpu`` runs it on the CPU (the
kernels' plain twins).  The store and the oracles live on
``WorkloadConfig.device`` (default: the card); the brute-force scoring
oracle is numpy on the host.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import BoxFilter
from ..core.cubegraph import CubeGraphConfig
from ..streaming import StreamConfig
from .batching import RetrievalFailure
from .rag import Document, DocumentStore
from .service import AdmissionController, CubeGraphService, ServeRequest
from .tenancy import MultiTenantStore

__all__ = ["GeoTemporalWorkload", "SLO_REPORT_KEYS", "WorkloadConfig"]

# The report schema contract: every run() report carries exactly these
# top-level keys (plus "latency_samples" rows for the bench digest).
SLO_REPORT_KEYS = (
    "n_tenants", "n_requests", "n_answered", "recall_at_10",
    "latency_ms_p50", "latency_ms_p99", "slo_violation_fraction",
    "degraded_fraction", "rejected_fraction", "isolation_checks",
    "isolation_ok",
)

_HOT_REGIONS = ((2.0, 2.0), (7.0, 6.0), (4.5, 8.0))
_REGION_WEIGHTS = (0.65, 0.25, 0.10)        # Zipf-ish skew: one hot spot


@dataclasses.dataclass
class WorkloadConfig:
    """Knobs for one harness run (defaults: a small but non-trivial
    2-tenant run; the bench scales it up, the CI smoke scales it down)."""

    n_tenants: int = 2
    d_emb: int = 16
    m: int = 3                       # (lon, lat, t)
    n_initial: int = 300             # per-tenant corpus before traffic
    n_steps: int = 6
    queries_per_step: int = 10       # per tenant per step
    k: int = 10
    window: float = 120.0            # moving time window width
    step_dt: float = 40.0            # stream-clock advance per step
    region_half_width: float = 2.5   # spatial box half-width
    burst_every: int = 2
    burst_points: int = 48           # per tenant per burst
    deletes_per_step: int = 2        # per tenant
    deadline_ms: Optional[float] = 250.0
    deadline_fraction: float = 0.5   # fraction of requests with an SLO
    slo_ms: float = 250.0
    warmup_steps: int = 0            # steps excluded from the report
    # (first dispatches pay jit compiles; the bench warms up, the CI
    # smoke keeps 0 so the schema path is exercised end-to-end)
    seal_max_points: int = 128
    n_shards: int = 2
    seed: int = 0
    device: Optional[str] = None     # None = the card


class GeoTemporalWorkload:
    """Runs the configured traffic against one shared
    :class:`MultiTenantStore` + per-tenant single-tenant oracles, and
    reports recall / latency percentiles / SLO + degraded fractions /
    isolation."""

    def __init__(self, cfg: WorkloadConfig = WorkloadConfig()):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        idx_cfg = CubeGraphConfig(n_layers=2, m_intra=8, m_cross=4)
        self._scfg = StreamConfig(time_dim=cfg.m - 1,
                                  seal_max_points=cfg.seal_max_points,
                                  n_shards=cfg.n_shards, index_cfg=idx_cfg)
        self.store = MultiTenantStore(cfg.d_emb, cfg.m,
                                      stream_cfg=self._scfg,
                                      device=cfg.device)
        self.service = CubeGraphService(
            self.store,
            AdmissionController(max_queue_per_tenant=10_000))
        self.tenants = [f"tenant{i}" for i in range(cfg.n_tenants)]
        self.oracles: Dict[str, DocumentStore] = {}
        # per tenant: ingestion-ordered (mt gid, oracle position) pairs
        self._order: Dict[str, List[int]] = {}
        self._next_doc_id = 0
        self.now = 0.0
        # per tenant: the oracle's stacked live corpus, rebuilt after a
        # write (the reference restacks it for every request)
        self._corpus: Dict[str, tuple] = {}

    # -- corpus / traffic generation -----------------------------------

    def _make_docs(self, n: int) -> List[Document]:
        cfg = self.cfg
        region = self.rng.choice(len(_HOT_REGIONS), size=n,
                                 p=_REGION_WEIGHTS)
        centers = np.asarray(_HOT_REGIONS)[region]
        lonlat = centers + self.rng.normal(scale=1.5, size=(n, 2))
        ts = self.now + self.rng.uniform(0, cfg.step_dt, size=n)
        docs = []
        for i in range(n):
            docs.append(Document(
                doc_id=self._next_doc_id,
                tokens=np.arange(4, dtype=np.int32),
                embedding=self.rng.standard_normal(cfg.d_emb)
                .astype(np.float32),
                metadata=np.array([lonlat[i, 0], lonlat[i, 1],
                                   float(ts[i])])))
            self._next_doc_id += 1
        return docs

    def _ingest(self, tenant: str, docs: List[Document]) -> None:
        self._corpus.pop(tenant, None)
        gids = self.store.insert(tenant, docs)
        self.oracles[tenant].insert(docs)
        self._order[tenant].extend(int(g) for g in gids)

    def _delete_some(self, tenant: str, n: int) -> None:
        coll = self.store.collection(tenant)
        live = [g for g in self._order[tenant] if g in coll.docs_by_gid]
        if len(live) <= n:
            return
        victims = list(self.rng.choice(live, size=n, replace=False))
        self._corpus.pop(tenant, None)
        self.store.delete(tenant, victims)
        # oracle positions == per-tenant ingestion order
        pos = [self._order[tenant].index(g) for g in victims]
        self.oracles[tenant].delete(pos)

    def _query_filter(self) -> Tuple[BoxFilter, np.ndarray, np.ndarray]:
        cfg = self.cfg
        region = _HOT_REGIONS[self.rng.choice(len(_HOT_REGIONS),
                                              p=_REGION_WEIGHTS)]
        w = cfg.region_half_width
        lo = np.array([region[0] - w, region[1] - w,
                       self.now - cfg.window], np.float32)
        hi = np.array([region[0] + w, region[1] + w, self.now],
                      np.float32)
        return BoxFilter(lo=lo, hi=hi), lo.astype(np.float64), \
            hi.astype(np.float64)

    # -- scoring -------------------------------------------------------

    def _brute_ids(self, tenant: str, q: np.ndarray, lo, hi,
                   k: int) -> set:
        """Exact numpy oracle: doc_ids of the tenant's best-k live
        matches under the box filter (ties broken like the kernels:
        distance then insertion order)."""
        coll = self.store.collection(tenant)
        if tenant not in self._corpus:
            gids = sorted(coll.docs_by_gid)        # == ingestion order
            self._corpus[tenant] = (
                np.stack([coll.docs_by_gid[g].embedding for g in gids])
                if gids else None,
                np.stack([coll.docs_by_gid[g].metadata for g in gids])
                if gids else None,
                np.asarray([coll.docs_by_gid[g].doc_id for g in gids]))
        emb, meta, doc_ids = self._corpus[tenant]
        if emb is None:
            return set()
        ok = np.all((meta >= lo) & (meta <= hi), axis=1)
        if not ok.any():
            return set()
        d2 = ((emb[ok].astype(np.float32) - q.astype(np.float32)) ** 2
              ).sum(axis=1)
        ids = doc_ids[ok]
        order = np.lexsort((ids, d2))[:k]
        return set(int(i) for i in ids[order])

    def _isolation_probe(self, tenant: str) -> bool:
        """One no-deadline request answered by the shared service must be
        bit-for-bit the single-tenant oracle store's answer."""
        cfg = self.cfg
        q = self.rng.standard_normal(cfg.d_emb).astype(np.float32)
        filt, _, _ = self._query_filter()
        ans = self.store.retrieve(tenant, q, filt, k=cfg.k)
        og, od = self.oracles[tenant].manager.query(q, filt, k=cfg.k)
        o_docs = [self.oracles[tenant].docs[i].doc_id
                  for i in np.asarray(og)[0] if i >= 0]
        m_docs = [d.doc_id for d in ans.docs[0]]
        return bool(m_docs == o_docs
                    and np.array_equal(ans.dists[0],
                                       np.asarray(od, np.float32)[0]))

    # -- the run -------------------------------------------------------

    def run(self) -> dict:
        """Execute the workload; returns the :data:`SLO_REPORT_KEYS`
        report (plus ``latency_samples`` rows for the bench digest)."""
        import time as _time
        cfg = self.cfg
        for t in self.tenants:
            self.oracles[t] = DocumentStore(
                self._make_docs(1), streaming=True,
                stream_cfg=dataclasses.replace(self._scfg),
                device=cfg.device)
            # DocumentStore() ingests its seed doc on construction; mirror
            # it into the shared store so both sides saw identical writes
            seed_doc = self.oracles[t].docs
            self.store.create_collection(t)
            self._order[t] = []
            gids = self.store.insert(t, seed_doc)
            self._order[t].extend(int(g) for g in gids)
            self._ingest(t, self._make_docs(cfg.n_initial - 1))

        latencies: List[float] = []
        recalls: List[float] = []
        lat_samples: List[dict] = []
        n_requests = n_rejected = n_degraded = n_violation = 0
        iso_checks, iso_ok = 0, True
        rid = 0
        pending: Dict[int, tuple] = {}

        for step in range(cfg.warmup_steps + cfg.n_steps):
            measuring = step >= cfg.warmup_steps
            self.now += cfg.step_dt
            if cfg.burst_every and step % cfg.burst_every == 1:
                for t in self.tenants:      # ingest burst mid-traffic
                    self._ingest(t, self._make_docs(cfg.burst_points))
                    self._delete_some(t, cfg.deletes_per_step)
            pending.clear()
            for t in self.tenants:
                for _ in range(cfg.queries_per_step):
                    q = self.rng.standard_normal(cfg.d_emb) \
                        .astype(np.float32)
                    filt, lo, hi = self._query_filter()
                    dl = (cfg.deadline_ms
                          if self.rng.uniform() < cfg.deadline_fraction
                          else None)
                    req = ServeRequest(req_id=rid, tenant=t, query_emb=q,
                                       filt=filt, k=cfg.k, deadline_ms=dl)
                    rid += 1
                    if measuring:
                        n_requests += 1
                    if isinstance(self.service.submit(req),
                                  RetrievalFailure):
                        n_rejected += measuring
                    else:
                        pending[req.req_id] = (t, q, lo, hi)
            t0 = _time.perf_counter()
            answers = self.service.flush()
            flush_s = _time.perf_counter() - t0
            if measuring:
                if pending:
                    lat_samples.append(
                        {"us_per_query":
                         round(flush_s / len(pending) * 1e6, 1)})
                for req_id, (t, q, lo, hi) in pending.items():
                    res = answers[req_id]
                    if isinstance(res, RetrievalFailure):
                        n_violation += 1
                        continue
                    latencies.append(res.latency_ms)
                    if res.latency_ms > cfg.slo_ms:
                        n_violation += 1
                    if res.degraded:
                        n_degraded += 1
                        continue             # recall on non-degraded only
                    want = self._brute_ids(t, q, lo, hi, cfg.k)
                    got = set(d.doc_id for d in res.docs)
                    if want:
                        recalls.append(len(got & want) / len(want))
            for t in self.tenants:           # per-step isolation probes
                iso_checks += 1
                iso_ok = self._isolation_probe(t) and iso_ok
            self.store.maintenance()
            for t in self.tenants:
                self.oracles[t].maintenance()

        lat = np.asarray(latencies if latencies else [0.0])
        return {
            "n_tenants": cfg.n_tenants,
            "n_requests": n_requests,
            "n_answered": len(latencies),
            "recall_at_10": round(float(np.mean(recalls)), 4)
            if recalls else None,
            "latency_ms_p50": round(float(np.percentile(lat, 50)), 3),
            "latency_ms_p99": round(float(np.percentile(lat, 99)), 3),
            "slo_violation_fraction": round(
                n_violation / max(n_requests, 1), 4),
            "degraded_fraction": round(
                n_degraded / max(n_requests, 1), 4),
            "rejected_fraction": round(
                n_rejected / max(n_requests, 1), 4),
            "isolation_checks": iso_checks,
            "isolation_ok": bool(iso_ok),
            "latency_samples": lat_samples,
        }


def _smoke(device: Optional[str] = None) -> dict:
    """Tiny run asserting the report schema."""
    report = GeoTemporalWorkload(WorkloadConfig(
        n_initial=80, n_steps=2, queries_per_step=3, burst_points=16,
        seal_max_points=64, window=200.0, device=device)).run()
    missing = [key for key in SLO_REPORT_KEYS if key not in report]
    assert not missing, f"SLO report missing keys: {missing}"
    assert report["isolation_ok"], "tenant isolation probe failed"
    assert report["n_requests"] > 0
    return report


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny run that asserts the report schema")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain twins)")
    args = ap.parse_args()
    if args.smoke:
        print(json.dumps(_smoke(args.device), indent=1))
    else:
        print(json.dumps(GeoTemporalWorkload(
            WorkloadConfig(device=args.device)).run(), indent=1))
