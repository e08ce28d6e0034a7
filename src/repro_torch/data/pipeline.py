"""Deterministic sharded synthetic-token data pipeline.

Production shape without external deps: per-host sharding, background
prefetch, and an explicit ``(step, shard)`` cursor so training resumes
bit-identically after checkpoint restore or elastic resharding.

The synthetic stream is *learnable* (affine-recurrent sequences mod vocab)
so end-to-end training tests can assert the loss actually decreases.

The counterpart of ``repro.data.pipeline``, in numpy as the reference:
its batches equal the reference's bit for bit for every ``(step,
host_id, n_hosts)``.  The loader hands numpy batches to the caller,
which copies them to the card (``launch/train.py``: pinned memory, a
non-blocking copy).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    learnable: bool = True          # affine-recurrent (else iid uniform)
    n_hosts: int = 1
    host_id: int = 0


class SyntheticTokenPipeline:
    """Stateless batch generator: batch(step) is a pure function of
    (config, step), so any host can regenerate any shard at any time —
    the property fault-tolerant resume and elastic scaling rely on."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = []
        base = step * cfg.global_batch + self.cfg.host_id * self.local_batch
        # the affine rule is FIXED per dataset seed (x -> a*x+b mod V is then
        # a static vocab permutation a small model learns quickly); only the
        # starting point varies per row.
        rule = np.random.default_rng((cfg.seed, 0xA11CE))
        a = int(rule.integers(2, 8))
        b = int(rule.integers(0, cfg.vocab))
        for r in range(self.local_batch):
            rng = np.random.default_rng((cfg.seed, base + r))
            if cfg.learnable:
                x0 = int(rng.integers(0, cfg.vocab))
                seq = np.empty(cfg.seq_len + 1, np.int32)
                seq[0] = x0
                for t in range(cfg.seq_len):
                    seq[t + 1] = (a * seq[t] + b) % cfg.vocab
            else:
                seq = rng.integers(0, cfg.vocab,
                                   size=cfg.seq_len + 1).astype(np.int32)
            rows.append(seq)
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class PrefetchingLoader:
    """Background-thread prefetch (double buffering the host->device copy)."""

    def __init__(self, pipeline: SyntheticTokenPipeline, start_step: int = 0,
                 depth: int = 2):
        self.pipeline = pipeline
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self._q.put((s, self.pipeline.batch(s)), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
