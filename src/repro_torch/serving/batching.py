"""Continuous batching for decode (host-side scheduler) — the counterpart
of ``repro.serving.batching.ContinuousBatcher``.

vLLM-style slot model: fixed ``n_slots`` lanes over one shared KV cache;
requests are admitted into free slots as they arrive, prefilled
individually, then decoded together in lockstep over all ``n_slots``
(each slot at its own position, so one tick hands kernel B5 ragged
lengths).  Finished slots (EOS, budget, or a full cache) free at once.

A prompt is prefilled straight into its slot of the shared cache (the
reference prefills a one-slot cache and copies it over): positions past
the prompt keep the previous occupant's K/V, which decode never reads (it
attends to ``[0, pos]`` only) and overwrites as the slot advances.  The
retrieval batcher is ROADMAP Queue A item 11.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

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
