"""Serving-side batchers (host-side schedulers), the counterparts of
``repro.serving.batching``.

* ``ContinuousBatcher`` — continuous batching for decode.
* ``RetrievalBatcher`` — groups queued retrieval requests that share a
  filter value and routes each group as ONE batched query through the
  document store (one segment fan-out instead of per-request searches).

``ContinuousBatcher``: vLLM-style slot model: fixed ``n_slots`` lanes over one shared KV cache;
requests are admitted into free slots as they arrive, prefilled
individually, then decoded together in lockstep over all ``n_slots``
(each slot at its own position, so one tick hands kernel B5 ragged
lengths).  Finished slots (EOS, budget, or a full cache) free at once.

A prompt is prefilled straight into its slot of the shared cache (the
reference prefills a one-slot cache and copies it over): positions past
the prompt keep the previous occupant's K/V, which decode never reads (it
attends to ``[0, pos]`` only) and overwrites as the slot advances.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.filters import (BallFilter, BoxFilter, ComposeFilter, Filter,
                            IntervalFilter, PolygonFilter)
from ..obs.metrics import NULL_REGISTRY
from .serve_step import make_serve_fns, params_device


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray               # [t] int32
    max_new: int
    arrived_step: int = 0
    output: Optional[List[int]] = None


class ContinuousBatcher:
    def __init__(self, model, params, n_slots: int = 8, max_len: int = 512,
                 eos_id: int = 1, temperature: float = 0.0, metrics=None):
        self.model = model
        self.params = params
        self.device = params_device(params)
        self.metrics = NULL_REGISTRY if metrics is None else metrics
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: deque = deque()
        self.active: Dict[int, Request] = {}          # slot -> request
        self.cache = model.init_cache(n_slots, max_len, device=self.device)
        self.pos = np.zeros(n_slots, np.int32)
        self.budget = np.zeros(n_slots, np.int32)
        self.cur_tok = np.zeros((n_slots, 1), np.int32)
        self.free = list(range(n_slots))
        self.finished: List[Request] = []
        self.prefill_fn, self.decode_fn = make_serve_fns(model, temperature)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self.steps = 0

    def submit(self, req: Request):
        self.queue.append(req)

    # -- admission: prefill one request into a free slot ----------------------
    def admit(self) -> int:
        """Prefill queued requests into free slots; returns how many."""
        n = 0
        while self.free and self.queue:
            req = self.queue.popleft()
            t = len(req.prompt)
            if not 1 <= t < self.max_len:
                raise ValueError(f"request {req.req_id}: a prompt of {t} "
                                 f"tokens does not fit max_len "
                                 f"{self.max_len}")
            slot = self.free.pop()
            req.output = []
            view = {name: c[:, slot:slot + 1] for name, c in
                    self.cache.items()}
            tok, _ = self.prefill_fn(
                self.params, torch.as_tensor(req.prompt[None, :],
                                             device=self.device), view)
            tok = int(tok[0, 0])
            self.cur_tok[slot] = tok
            req.output.append(tok)
            self.pos[slot] = t
            self.budget[slot] = req.max_new - 1
            self.active[slot] = req
            n += 1
        return n

    # -- one decode tick over all slots ---------------------------------------
    def step(self) -> int:
        self.admit()
        if not self.active:
            return 0
        if int(self.pos.max()) >= self.max_len:
            raise RuntimeError(f"a slot position reached max_len "
                               f"{self.max_len}: {self.pos.tolist()}")
        tok, _, self.cache = self.decode_fn(
            self.params, torch.as_tensor(self.cur_tok, device=self.device),
            self.cache, torch.as_tensor(self.pos, device=self.device),
            self._gen)
        tok = tok.cpu().numpy()
        self.steps += 1
        # slot occupancy per decode tick: 1.0 means the lockstep decode
        # wasted no lanes, low values mean admission is starved
        self.metrics.counter("decode_steps_total").inc()
        self.metrics.histogram("decode_slot_occupancy").observe(
            len(self.active) / self.n_slots)
        done_slots = []
        for slot, req in list(self.active.items()):
            t = int(tok[slot, 0])
            req.output.append(t)
            self.pos[slot] += 1
            self.budget[slot] -= 1
            if t == self.eos_id or self.budget[slot] <= 0 \
                    or self.pos[slot] >= self.max_len - 1:
                done_slots.append(slot)
        for slot in done_slots:
            self.finished.append(self.active.pop(slot))
            self.free.append(slot)
        self.cur_tok = np.array(tok)
        return len(self.active)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        while (self.queue or self.active) and self.steps < max_steps:
            self.step()
        return self.finished


# ---------------------------------------------------------------------------
# Retrieval batching (streaming segment fan-out)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RetrievalRequest:
    req_id: int
    query_emb: np.ndarray            # [d_emb]
    filt: Optional[Filter]
    k: int = 10
    deadline_ms: Optional[float] = None   # per-request SLO budget
    enqueued_at: float = 0.0         # stamped by RetrievalBatcher.submit


@dataclasses.dataclass
class RetrievalFailure:
    """Error result for a request the serving layer could not answer.

    ``flush()`` never drops queued requests: a chunk whose store dispatch
    raises maps each of its requests to one of these while every other
    chunk drains normally.  ``reason`` is a stable tag — ``"error"`` for
    dispatch exceptions, ``"over_quota"`` for admission-control
    rejections (``serving/service.py``)."""
    req_id: int
    error: str
    reason: str = "error"


def _leaf_key(leaf):
    """One filter leaf -> hashable *value* key.

    Array-like leaves (tensors are moved to the CPU first) key on
    ``(dtype, shape, bytes)``, so a ``[2, 1]`` float32 bound never
    collides with a ``[2]`` one, nor an int32 leaf with a float32 of the
    same bits.  A leaf that numpy cannot turn into a numeric array (an
    object the walk in :func:`_filter_key` does not know) recurses over
    the object's field values (dataclass fields or ``__dict__``), falling
    back to ``repr`` for plain constants."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    a = np.asarray(leaf)
    if a.dtype != object:
        return (a.dtype.str, a.shape, a.tobytes())
    if dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
        state = {f.name: getattr(leaf, f.name)
                 for f in dataclasses.fields(leaf)}
    else:
        state = getattr(leaf, "__dict__", None)
    if state is not None:
        return (type(leaf).__name__,
                tuple((name, _leaf_key(v))
                      for name, v in sorted(state.items())))
    return (type(leaf).__name__, repr(leaf))


# the value fields of each filter class, in the reference's leaf order;
# IntervalFilter.dim and ComposeFilter.op are structure, not leaves
_FILTER_LEAVES = {BoxFilter: ("lo", "hi"), BallFilter: ("center", "radius"),
                  PolygonFilter: ("vertices", "rest_lo", "rest_hi")}


def _tree_key(f):
    """The structure-and-value key of one filter tree: the class, its
    structural fields, and a :func:`_leaf_key` per value field (``None``
    stands for itself, as an empty node)."""
    def leaf(v):
        return ("None",) if v is None else _leaf_key(v)
    if f is None:
        return ("None",)
    if isinstance(f, ComposeFilter):
        return ("ComposeFilter", f.op, _tree_key(f.a), _tree_key(f.b))
    if isinstance(f, IntervalFilter):
        return ("IntervalFilter", repr(f.dim), leaf(f.lo), leaf(f.hi))
    fields = _FILTER_LEAVES.get(type(f))
    if fields is not None:
        return (type(f).__name__,) + tuple(leaf(getattr(f, n))
                                           for n in fields)
    return _leaf_key(f)


def _filter_key(filt: Optional[Filter], k: int):
    """Hashable *value-based* identity for grouping: the filter tree's
    structure plus per-leaf ``(dtype, shape, bytes)`` — two equal-valued
    but distinct filter objects key the same and batch together.  The
    reference flattens the filter as a jax pytree; this walk of the port's
    filter dataclasses gives equal keys exactly where that one does."""
    return (k, _tree_key(filt))


class RetrievalBatcher:
    """Batches retrieval requests per shared filter.

    Requests arriving between flushes queue up; ``flush()`` partitions them
    by (filter value, k, deadline), stacks each group's query embeddings,
    and sends a single batched ``DocumentStore.retrieve`` per group — over
    a streaming store that is one pruned multi-segment fan-out amortized
    across the whole group.  Groups larger than ``max_batch`` are split.
    Each returned row is a :class:`~repro_torch.serving.rag.RetrievedDocs`
    carrying the underlying query's ``degraded`` / ``reasons`` markers.

    With ``maintenance_every > 0`` (streaming stores only), every that-many
    flushes trigger one lifecycle tick with compaction pushed to the
    manager's background thread.
    """

    def __init__(self, store, ef: int = 64, max_batch: int = 64,
                 maintenance_every: int = 0):
        self.store = store
        self.ef = int(ef)
        self.max_batch = int(max_batch)
        self.maintenance_every = int(maintenance_every)
        self._flushes = 0
        self.queue: deque = deque()
        # share the store's registry so queue-wait / batch-occupancy land
        # in the same snapshot as the retrieval latencies
        self.metrics = getattr(store, "metrics", None) or NULL_REGISTRY

    def submit(self, req: RetrievalRequest) -> None:
        if not req.enqueued_at:
            req.enqueued_at = time.perf_counter()
        self.queue.append(req)

    def __len__(self) -> int:
        return len(self.queue)

    def flush(self) -> Dict[int, list]:
        """Drain the queue; returns {req_id: [Document, ...]}.

        Every queued request gets an entry: a chunk whose store dispatch
        raises maps each of its requests to a :class:`RetrievalFailure`
        (counted in ``retrieval_failed_total``) and the remaining chunks
        keep draining."""
        groups: Dict[object, List[RetrievalRequest]] = {}
        while self.queue:
            req = self.queue.popleft()
            groups.setdefault(
                (_filter_key(req.filt, req.k), req.deadline_ms),
                []).append(req)
        results: Dict[int, list] = {}
        t_flush = time.perf_counter()
        wait_hist = self.metrics.histogram("retrieval_queue_wait_ms")
        occ_hist = self.metrics.histogram("retrieval_batch_occupancy")
        for reqs in groups.values():
            for lo in range(0, len(reqs), self.max_batch):
                chunk = reqs[lo:lo + self.max_batch]
                # occupancy: how full each dispatched batch is relative to
                # max_batch — persistently low means filters fragment the
                # queue and the fan-out amortization is not happening
                occ_hist.observe(len(chunk) / self.max_batch)
                for r in chunk:
                    if r.enqueued_at:
                        wait_hist.observe((t_flush - r.enqueued_at) * 1e3)
                q = np.stack([r.query_emb for r in chunk]).astype(np.float32)
                # deadline-free chunks call retrieve without the kwarg so
                # duck-typed stores without deadline_ms keep working
                kw = ({"deadline_ms": chunk[0].deadline_ms}
                      if chunk[0].deadline_ms is not None else {})
                try:
                    rows = self.store.retrieve(
                        q, chunk[0].filt, k=chunk[0].k, ef=self.ef, **kw)
                except Exception as exc:       # noqa: BLE001 — isolate chunk
                    self.metrics.counter("retrieval_failed_total").inc(
                        len(chunk))
                    for r in chunk:
                        results[r.req_id] = RetrievalFailure(
                            r.req_id, f"{type(exc).__name__}: {exc}")
                    continue
                for r, docs in zip(chunk, rows):
                    results[r.req_id] = docs
        self._flushes += 1
        if (self.maintenance_every > 0
                and self._flushes % self.maintenance_every == 0
                and getattr(self.store, "streaming", False)):
            self.store.maintenance(async_compaction=True)
        return results
