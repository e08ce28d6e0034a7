"""Graph recall of a delta-kept sharded pack against a cold-built one, in
both packages.

A manager that answers a query early in its stream keeps its bucketed pack
by deltas from then on: each segment's graph is staged once, at seal or
compaction publish, and a later delete only masks the point's metadata.
A pack built cold at query time stages every segment's graph from its live
points instead.  Both answer exactly on the scan path; the stitched graph
traversal sees different graphs and seeds and so reaches a different
recall.  This file holds the port to the reference on both packs.

As a test it runs at a small size.  As a script it runs the sharded
smoke phase's settings (``StreamConfig(time_dim=2, seal_max_points=2048,
n_shards=2, read_path="auto", graph_ef=192, ttl=0.8)``, 1% deletes and a
TTL expiry, the box-and-interval filter) at n = 100,000 and d = 64 on the
CPU, and prints the forced-graph recall@10 of both packs in both
packages (about 20 minutes on 8 cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_pack_recall_witness.py
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.streaming as js
from repro.core import workloads as jw
import repro_torch.core as tc
import repro_torch.streaming as ts
from repro_torch.core import workloads as tw

torch.set_num_threads(1)

M, K = 3, 10
SCRIPT_N, SCRIPT_D, SCRIPT_Q = 100_000, 64, 200


def workload(n: int, d: int, nq: int, seed: int = 0):
    """Clustered vectors with event time in column 2 (time-ordered), and
    queries near stored points."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d)).astype(np.float32)
    x = (centers[rng.integers(0, 32, n)]
         + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    s = rng.uniform(size=(n, M))
    s[:, 2] = np.arange(n) / n
    q = (x[rng.integers(0, n, nq)]
         + 0.05 * rng.normal(size=(nq, d))).astype(np.float32)
    return x, s, q


def _filter(pkg):
    return pkg.ComposeFilter(
        pkg.BoxFilter(lo=np.asarray([0.2, 0.2, 0.0], np.float32),
                      hi=np.asarray([0.8, 0.8, 1.0], np.float32)),
        pkg.IntervalFilter(dim=2, lo=0.6, hi=1.0), "and")


def pack_recalls(streaming, core, wl, x, s, q, cfg, batch: int,
                 early_batch: int, **mgr_kw):
    """Ingest in batches with a maintenance tick each, one query after
    ``early_batch`` (so the pack is kept by deltas), 1% deletes and a TTL
    expiry; then the forced-graph answers of the delta-kept pack and of a
    cold rebuild.  Returns ``(answers_delta, answers_cold, recall_delta,
    recall_cold)``."""
    d = x.shape[1]
    mgr = streaming.SegmentManager(d, M, streaming.StreamConfig(**cfg),
                                   **mgr_kw)
    for bi, lo in enumerate(range(0, len(x), batch)):
        mgr.ingest(x[lo:lo + batch], s[lo:lo + batch])
        mgr.maintenance()
        if bi == early_batch:
            mgr.query(q[:4], None, k=K)
    assert mgr._pack is not None
    live = np.nonzero(mgr.alive)[0]
    dead = np.random.default_rng(1).choice(live, size=len(live) // 100,
                                           replace=False)
    mgr.delete(dead)
    mgr.expire(now=mgr.now + 0.15)
    f = _filter(core)
    gt, _ = wl.ground_truth(x, s.astype(np.float32), q, f, K,
                            valid=mgr.alive)
    g_delta, _ = mgr.query(q, f, k=K, read_path="graph")
    mgr._pack = None                        # the next query builds cold
    g_cold, _ = mgr.query(q, f, k=K, read_path="graph")
    return (g_delta, g_cold, wl.recall(g_delta, gt), wl.recall(g_cold, gt))


def smoke_cfg(seal: int, idx_cfg) -> dict:
    return dict(time_dim=2, seal_max_points=seal, n_shards=2,
                read_path="auto", graph_ef=192, ttl=0.8,
                pack_warm_compile=False, index_cfg=idx_cfg)


def test_delta_and_cold_packs_traverse_like_the_reference():
    """The port's forced-graph answers on the delta-kept pack and on the
    cold rebuild track the reference's answers on the same pack."""
    x, s, q = workload(3000, 16, 24)
    ref = pack_recalls(js, jc, jw, x, s, q,
                       smoke_cfg(250, jc.CubeGraphConfig()), 500, 1)
    port = pack_recalls(ts, tc, tw, x, s, q,
                        smoke_cfg(250, tc.CubeGraphConfig()), 500, 1,
                        device="cpu")
    for i in (0, 1):                        # delta-kept, cold
        assert (port[i] == ref[i]).mean() >= 0.95
        assert port[2 + i] >= ref[2 + i] - 0.02
        assert port[2 + i] >= 0.8


if __name__ == "__main__":
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    x, s, q = workload(SCRIPT_N, SCRIPT_D, SCRIPT_Q)
    for name, args in (
            ("reference", (js, jc, jw, x, s, q,
                           smoke_cfg(2048, jc.CubeGraphConfig()), 4096, 2)),
            ("port (cpu)", (ts, tc, tw, x, s, q,
                            smoke_cfg(2048, tc.CubeGraphConfig()), 4096, 2))):
        kw = {"device": "cpu"} if name.startswith("port") else {}
        _, _, r_delta, r_cold = pack_recalls(*args, **kw)
        print(f"n={SCRIPT_N} d={SCRIPT_D} {name}: forced-graph recall@{K} "
              f"delta-kept pack {r_delta:.4f}, cold-built pack "
              f"{r_cold:.4f}", flush=True)
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
