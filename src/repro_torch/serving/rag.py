"""Spatio-temporal RAG pipeline — CubeGraph's application layer, the
counterpart of ``repro.serving.rag``: embed query -> filtered top-k
retrieval (CubeGraph) -> context assembly -> generation.

The document store holds (embedding, metadata, token span) triples; the
query embedder is the reference's linear projection stub, drawn from the
same numpy generator so both packages retrieve the same documents.
Persistence (``restore`` / ``snapshot_to``), tiering
(``device_budget_bytes``) and grouped retrieval (``retrieve_grouped``)
work as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import CubeGraphConfig, CubeGraphIndex, Filter
from ..distributed.segment_shards import resolve_mesh
from ..obs import StreamObs, json_sanitize
from ..streaming import SegmentManager, StreamConfig
from .serve_step import generate


@dataclasses.dataclass
class Document:
    doc_id: int
    tokens: np.ndarray              # [t] int32 token span
    embedding: np.ndarray           # [d_emb]
    metadata: np.ndarray            # [m] (lon, lat, t, ...)


class RetrievedDocs(list):
    """One query's retrieved document row, carrying the streaming query's
    ``degraded`` / ``reasons`` markers (always False / empty for a static
    store)."""

    def __init__(self, docs=(), degraded: bool = False,
                 reasons: Optional[dict] = None):
        super().__init__(docs)
        self.degraded = bool(degraded)
        self.reasons = dict(reasons or {})


class DocumentStore:
    """Filtered-retrieval store with two backends:

    * static (default): one monolithic ``CubeGraphIndex`` built up front,
      grown via incremental ``insert_batch``;
    * streaming (``streaming=True``): the ``SegmentManager`` — continuous
      ingest, seal/compaction/TTL lifecycle, segment fan-out queries.
      Document list positions double as global point ids.

    ``quantize="int8"``, ``read_path="auto"|"graph"`` and
    ``device_budget_bytes`` overlay the streaming config and turn the
    sharded read path on, as in the reference: with a budget the store's
    device memory is a cache over the sealed corpus, cold buckets living
    in page-locked host memory and streaming through the same kernels.
    Indexes live on ``device`` (default: the first CUDA card).  Pass
    ``shard_mesh`` (``repro_torch.distributed.make_shard_mesh()``) to
    spread a streaming store's pack over several cards of one process;
    its home card is ``device``.
    """

    def __init__(self, docs: Sequence[Document],
                 index_cfg: CubeGraphConfig = CubeGraphConfig(),
                 streaming: bool = False,
                 stream_cfg: Optional[StreamConfig] = None,
                 quantize: Optional[str] = None,
                 read_path: Optional[str] = None,
                 device_budget_bytes: Optional[int] = None, device=None,
                 shard_mesh=None):
        self.docs = list(docs)
        self.streaming = bool(streaming)
        self.device = resolve_mesh(device, shard_mesh).home
        x = np.stack([d.embedding for d in self.docs]).astype(np.float32)
        s = np.stack([d.metadata for d in self.docs]).astype(np.float64)
        if self.streaming:
            if stream_cfg is None:
                stream_cfg = StreamConfig(index_cfg=index_cfg)
            if quantize is not None:
                stream_cfg = dataclasses.replace(
                    stream_cfg, quantize=quantize,
                    n_shards=max(stream_cfg.n_shards, 1))
            if read_path is not None:
                stream_cfg = dataclasses.replace(
                    stream_cfg, read_path=read_path,
                    n_shards=max(stream_cfg.n_shards, 1))
            if device_budget_bytes is not None:
                stream_cfg = dataclasses.replace(
                    stream_cfg, device_budget_bytes=device_budget_bytes,
                    n_shards=max(stream_cfg.n_shards, 1))
            self.manager = SegmentManager(x.shape[1], s.shape[1], stream_cfg,
                                          device=self.device,
                                          shard_mesh=shard_mesh)
            self.manager.ingest(x, s)
            self.index = None
        else:
            if quantize is not None:
                raise ValueError("quantize requires a streaming store "
                                 "(DocumentStore(streaming=True))")
            if read_path is not None and read_path != "scan":
                raise ValueError("read_path requires a streaming store "
                                 "(DocumentStore(streaming=True))")
            if device_budget_bytes is not None:
                raise ValueError("device_budget_bytes requires a streaming "
                                 "store (DocumentStore(streaming=True))")
            if shard_mesh is not None:
                raise ValueError("shard_mesh requires a streaming store "
                                 "(DocumentStore(streaming=True))")
            self.manager = None
            self.index = CubeGraphIndex.build(x, s, index_cfg,
                                              device=self.device)
        self._init_obs()

    def _init_obs(self) -> None:
        """A streaming store shares the manager's registry; a static store
        gets its own."""
        self.obs = self.manager.obs if self.streaming else StreamObs()
        self.metrics = self.obs.registry

    @classmethod
    def restore(cls, docs: Sequence[Document], directory: str,
                stream_cfg: Optional[StreamConfig] = None, device=None,
                resume: bool = True, shard_mesh=None) -> "DocumentStore":
        """Warm-start a streaming store from a snapshot directory (written
        by either package) instead of re-ingesting: the manager restores
        on ``device`` (default: the card) or ``shard_mesh`` via
        ``SegmentManager.restore`` and answers like the replica that wrote
        the snapshot.  ``docs`` must be the snapshot-time document list,
        in order — store positions double as global point ids."""
        obj = cls.__new__(cls)
        obj.docs = list(docs)
        obj.streaming = True
        obj.index = None
        obj.manager = SegmentManager.restore(directory, cfg=stream_cfg,
                                             device=device, resume=resume,
                                             shard_mesh=shard_mesh)
        obj.device = obj.manager.device
        obj._init_obs()
        if obj.manager.n_total != len(obj.docs):
            raise ValueError(
                f"snapshot knows {obj.manager.n_total} points but "
                f"{len(obj.docs)} documents were provided — pass exactly "
                "the snapshot-time document list (insert new documents "
                "through store.insert after restoring)")
        return obj

    def snapshot_to(self, directory: str) -> dict:
        """Durably snapshot the streaming backend (see
        ``SegmentManager.snapshot_to``); a static store has nothing
        incremental to persist (use ``core.cubegraph.save_index``)."""
        if not self.streaming:
            raise ValueError("snapshot_to requires a streaming store")
        return self.manager.snapshot_to(directory)

    def retrieve(self, query_emb: np.ndarray, filt: Filter, k: int,
                 ef: int = 64, trace=None,
                 deadline_ms: Optional[float] = None
                 ) -> List[RetrievedDocs]:
        """Filtered top-k document retrieval for a query-embedding batch;
        the latency lands in the ``retrieve_ms`` histogram.
        ``deadline_ms`` bounds a streaming query's time budget (a partial
        answer comes back with ``degraded=True``); static stores ignore
        it."""
        t0 = time.perf_counter()
        q = np.atleast_2d(query_emb)
        degraded, reasons = False, {}
        if self.streaming:
            res = self.manager.query(q, filt, k=k, ef=ef, trace=trace,
                                     deadline_ms=deadline_ms)
            ids, _ = res
            degraded = bool(getattr(res, "degraded", False))
            reasons = dict(getattr(res, "reasons", {}) or {})
        else:
            ids, _ = self.index.query(q, filt, k=k, ef=ef)
        out = [RetrievedDocs((self.docs[i] for i in row if i >= 0),
                             degraded=degraded, reasons=reasons)
               for row in np.asarray(ids)]
        self.metrics.counter("retrieve_requests_total").inc(q.shape[0])
        self.metrics.histogram("retrieve_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return out

    def retrieve_grouped(self, requests) -> dict:
        """Continuous filtered batching over heterogeneous requests:
        answer a batch of :class:`~repro_torch.serving.batching
        .RetrievalRequest` with different filters / ``k`` / deadlines in
        shared dispatches — a streaming store reads each sealed bucket's
        device block once for the whole batch
        (``SegmentManager.query_grouped``) instead of once per distinct
        filter.  Answers are bit for bit the per-request :meth:`retrieve`
        answers.  Returns ``{req_id: RetrievedDocs}``."""
        from .batching import _filter_key
        requests = list(requests)
        out: dict = {}
        if not requests:
            return out
        t0 = time.perf_counter()
        groups: dict = {}
        for r in requests:
            groups.setdefault((_filter_key(r.filt, r.k), r.deadline_ms),
                              []).append(r)
        members = list(groups.values())
        if self.streaming:
            from ..streaming import GroupQuery
            gqs = [GroupQuery(
                np.stack([r.query_emb for r in reqs]).astype(np.float32),
                reqs[0].filt, k=reqs[0].k,
                deadline_ms=reqs[0].deadline_ms) for reqs in members]
            for reqs, res in zip(members, self.manager.query_grouped(gqs)):
                ids = np.asarray(res[0])
                degraded = bool(getattr(res, "degraded", False))
                reasons = dict(getattr(res, "reasons", {}) or {})
                for r, row in zip(reqs, ids):
                    out[r.req_id] = RetrievedDocs(
                        (self.docs[i] for i in row if i >= 0),
                        degraded=degraded, reasons=reasons)
        else:
            for reqs in members:
                q = np.stack([r.query_emb for r in reqs]).astype(np.float32)
                ids, _ = self.index.query(q, reqs[0].filt, k=reqs[0].k)
                for r, row in zip(reqs, np.asarray(ids)):
                    out[r.req_id] = RetrievedDocs(
                        self.docs[i] for i in row if i >= 0)
        self.metrics.counter("retrieve_requests_total").inc(len(requests))
        self.metrics.histogram("retrieve_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return out

    def metrics_snapshot(self) -> dict:
        """Strict-JSON-safe export of every metric this store touches."""
        return json_sanitize(self.obs.snapshot())

    def insert(self, docs: Sequence[Document]):
        """Static: incremental graph insertion.  Streaming: delta-buffer
        ingest (the seal policy may cut a new segment)."""
        x = np.stack([d.embedding for d in docs]).astype(np.float32)
        s = np.stack([d.metadata for d in docs]).astype(np.float64)
        if self.streaming:
            self.manager.ingest(x, s)
        else:
            self.index.insert_batch(x, s)
        self.docs.extend(docs)

    def delete(self, positions: Sequence[int]) -> None:
        """Lazy-delete documents by store position (== global id)."""
        if self.streaming:
            self.manager.delete(np.asarray(positions, np.int64))
        else:
            self.index.delete(positions)

    def maintenance(self, async_compaction: bool = False) -> dict:
        """Streaming lifecycle tick (seal + TTL expiry + compaction + store
        GC); a static store has none."""
        if not self.streaming:
            return {}
        return self.manager.maintenance(async_compaction=async_compaction)


class RAGPipeline:
    """retrieve -> assemble -> generate."""

    SEP = 0                          # separator token id (synthetic vocab)

    def __init__(self, store: DocumentStore, model, params,
                 query_proj: Optional[np.ndarray] = None,
                 max_context: int = 512):
        self.store = store
        self.model = model
        self.params = params
        self.max_context = max_context
        d_emb = store.docs[0].embedding.shape[0]
        if query_proj is None:
            rng = np.random.default_rng(0)
            query_proj = (rng.normal(size=(model.cfg.d_model, d_emb))
                          / np.sqrt(model.cfg.d_model)).astype(np.float32)
        self.query_proj = query_proj

    def embed_query(self, query_tokens: np.ndarray) -> np.ndarray:
        """Stub encoder: mean-pooled token embeddings projected to doc
        space.  Only the query's rows of the embedding table leave the
        device; the pooling and projection are the reference's numpy
        arithmetic."""
        table = self.params["embed"]["embedding"]
        idx = np.asarray(query_tokens)
        rows = table[torch.as_tensor(idx, dtype=torch.long,
                                     device=table.device)]
        rows = rows.float().cpu().numpy()
        pooled = rows.mean(axis=-2)                           # [.., d_model]
        return pooled @ self.query_proj                       # [.., d_emb]

    def assemble(self, docs: List[Document],
                 query_tokens: np.ndarray) -> np.ndarray:
        ctx: List[int] = []
        for d in docs:
            remaining = self.max_context - len(ctx) - len(query_tokens) - 1
            if remaining <= 0:
                break
            ctx.extend(d.tokens[:remaining].tolist())
            ctx.append(self.SEP)
        return np.asarray(ctx + query_tokens.tolist(), np.int32)

    def answer(self, query_tokens: np.ndarray, filt: Filter, k: int = 4,
               max_new: int = 16, ef: int = 64
               ) -> Tuple[np.ndarray, List[Document]]:
        q_emb = self.embed_query(query_tokens)
        docs = self.store.retrieve(q_emb, filt, k, ef=ef)[0]
        prompt = self.assemble(docs, query_tokens)
        out = generate(self.model, self.params, prompt[None, :],
                       max_new=max_new)
        return out[0].cpu().numpy(), docs

