#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, started together), holds each kernel against its plain
PyTorch twin, then drives the port's main paths at deployment widths
(d = 768) — the exact filtered scan over 1M vectors, a CubeGraph index
built and queried on the card, the default streaming ``SegmentManager``,
the paper's baselines (PostFiltering, PreFiltering, ACORN-4, TreeGraph)
beside the index, and the sharded sealed read path (``n_shards=2``, fp32
and int8 packs, forced scan, forced graph and planner-chosen reads) — and
checks the answers against exact ground truth.  The sharded managers are
then snapshotted, restored on the card and held bit for bit to their
answers, and restored again under a device budget that leaves buckets
in pinned host memory (cold dispatches, admissions on a side stream).
Phase 5d drives a persistent, budgeted manager (fp32 and int8) through a
lifecycle tape under seeded crashes at the fault points and holds every
recovered answer bit for bit to a fault-free oracle.
It times each of those kernels beside its twin, its roofline bound and
one PyTorch library call computing the same function.  Then it frees those phases' tensors and
drives the generation side at the full width of ``internvl2-2b`` in bf16
(random weights drawn on the card from ``SEED``): a ``ContinuousBatcher``
run, decode checked against a full forward, and ``RAGPipeline.answer``
over a static ``DocumentStore``; the decode kernel (B5) is held against
its twin on the inputs one layer of a recorded batcher tick handed it,
and timed there.  Last (phase 8) it serves a geo-temporal workload of 4
tenants over one shared substrate through ``CubeGraphService`` (kernel
B1's grouped launch), checks isolation, recall and a recorded flush
answered grouped against the same requests answered solo, bit for bit,
and times the grouped launch on that flush.

The last three lines of standard output are the card's name and power
limit (from ``nvidia-smi``), a JSON object describing every kernel, and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
those lines; so does a machine without a CUDA card, or a directory that
does not hold the port's sources.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Main-path sizes.  D is the embedding width and is never cut; a cut of
# the n's is made here and listed in PERF.md.
D = 768
QUERIES = 1000
N_SCAN = 1_000_000
N_INDEX = 100_000       # cut from 1M: level-0 kNN is O(n^2 / 2^m * d)
N_STREAM = 100_000
N_SHARDED = 100_000     # points per manager in the sharded streaming phase
EARLY_QUERY_BATCH = 2   # the sharded managers' first query, after 3 batches
# Baselines (4b) on phase 4's data, queried at BASELINE_EF; not cut while
# the four builds stay under BASELINE_BUILD_S.  The monolithic graph counts
# as navigable when its unfiltered recall@10 reaches NAV_RECALL at NAV_EF
# and the approximate-leg floor of 0.8 at BASELINE_EF (PERF.md §6).
BASELINE_BUILD_S = 180.0
BASELINE_EF = 64
NAV_EF, NAV_RECALL = 256, 0.95
SEED = 0
# Resilience (5d): a persistent manager of CHAOS_N points at width D, fp32
# and int8, under seeded crashes; its queries carry CHAOS_DEADLINE_MS (met
# with room to spare, so the per-bucket deadline path runs exactly).
CHAOS_N = 20_000
CHAOS_QUERIES = 64
CHAOS_DEADLINE_MS = 60_000.0
# The serving tier (8): GeoTemporalWorkload at width D, 4 tenants of
# 25,000 points (100,000 as phase 5b), not cut.
SERVE = dict(n_tenants=4, d_emb=D, n_initial=25_000, seal_max_points=4096,
             n_shards=2, warmup_steps=2, n_steps=8, queries_per_step=64,
             k=10, burst_every=2, burst_points=1024, deletes_per_step=32,
             deadline_ms=250.0, deadline_fraction=0.5, slo_ms=250.0)

# Generation phase (7): the full width of ARCH, never cut.  N_RAG is cut
# from phase 4's 100,000 (the index build is O(n^2) and phase 4 covers
# that size); the other sizes are a serving deployment's own.
ARCH = "internvl2-2b"
SLOTS = 8               # batcher lanes over one KV cache
MAX_LEN = 4096          # cache positions per slot
N_REQUESTS = 16
PROMPT_LO, PROMPT_HI = 1024, 3584
MAX_NEW = 32
RECORD_TICK = 16        # the batcher tick (first wave) whose B5 inputs ...
RECORD_LAYER = 12       # ... of this layer are recorded, checked and timed
PROFILE_TICK = 24       # the batcher tick traced with torch.profiler
N_FORWARD = 2           # requests whose decode logits are held to a forward
# Decode vs forward: |diff| <= LOGIT_TOL * rms(row) of the forward's
# logits.  bf16 rounds each result to 8 bits (2^-9 relative); the decode
# step and the forward round at different points (B5's fp32 softmax
# against the forward's bf16 scores, one-row against many-row matmul
# kernels), about ten per layer over 24 layers: as a random walk about
# sqrt(240) x 0.2% = 3% of the logit scale; 0.15 leaves a 5x margin.
LOGIT_TOL = 0.15
N_RAG = 20_000          # documents (d_emb = D, metadata lon, lat, t)
RAG_SPAN = 256          # tokens per document
RAG_QUERIES = 8
RAG_QUERY_TOKENS = 32
RAG_K = 8
RAG_MAX_NEW = 16
RAG_CONTEXT = 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: no output"


class Phase:
    """Times one phase on the host clock (after a device sync) and records
    its peak device memory."""

    def __init__(self, name: str, torch):
        self.name, self.torch = name, torch

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.torch.cuda.synchronize()
            peak = self.torch.cuda.max_memory_allocated() / 2**30
            log(f"== phase {self.name}: {time.perf_counter() - self.t0:.2f} s,"
                f" peak device memory {peak:.2f} GiB")
        return False


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn``: the summed durations of the kernels
    ``iters`` calls ran, under ``torch.profiler``.  Unlike ``cuda_ms`` it
    leaves out the host's gaps between launches, which decide the
    back-to-back time of a kernel shorter than its wrapper's host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    check(us > 0, "torch.profiler recorded no device time")
    return us / 1e3 / iters


def compare_topk(torch, kd, ki, td, ti, scale, what: str) -> float:
    """Kernel (kd, ki) vs twin (td, ti) top-k lists [..., kpad].  The
    misses must coincide, distances agree within ``1e-5 * scale`` (fp32
    relative tolerance on |q|^2 + |x|^2: the two sum the products in
    different orders), and ids agree wherever the twin's distance is
    separated from its neighbours in the list by more than twice that.
    Returns the largest absolute distance difference."""
    fk, ft = torch.isfinite(kd), torch.isfinite(td)
    check(bool(torch.equal(fk, ft)), f"{what}: miss pattern differs")
    check(bool(torch.equal(ki < 0, ~fk)), f"{what}: -1 ids not at misses")
    tol = 1e-5 * scale
    diff = torch.where(fk, (kd - td).abs(), torch.zeros_like(kd))
    err = float(diff.max()) if diff.numel() else 0.0
    check(bool((diff <= tol).all()), f"{what}: distance error {err:.3g} "
          f"above tolerance")
    big = torch.full_like(td[..., :1], float("inf"))
    tf = torch.where(ft, td, torch.full_like(td, 3e38))
    gap_prev = torch.cat([big, tf[..., 1:] - tf[..., :-1]], dim=-1)
    gap_next = torch.cat([tf[..., 1:] - tf[..., :-1], big], dim=-1)
    unique = ft & (gap_prev > 2 * tol) & (gap_next > 2 * tol)
    unique[..., -1] = False         # the next candidate is not in the list
    bad = unique & (ki != ti)
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} ids differ at "
          "untied distances")
    return err


def compare_hop(torch, args, tol, what: str) -> float:
    """B4 kernel vs twin on one hop's ``args`` (q, pos, block, meta,
    params, kind, metric, scales): equal masks, ``+inf`` at missing
    positions, distances within ``tol`` ([b, 1]) at the others.  Returns
    the largest absolute distance difference."""
    from repro_torch.kernels.graph_topk import (beam_step_plain,
                                                beam_step_scores)
    *head, sc = args
    pos = args[1]
    kd, kok = beam_step_scores(*head, scales=sc)
    torch.cuda.synchronize()
    td, tok = beam_step_plain(*head, scales=sc)
    valid = pos >= 0
    check(bool(torch.equal(kok, tok)), f"{what}: masks differ")
    check(bool(torch.isinf(kd[~valid]).all()),
          f"{what}: missing positions not +inf")
    diff = torch.where(valid, (kd - td).abs(), torch.zeros_like(kd))
    err = float(diff.max()) if diff.numel() else 0.0
    check(bool((diff <= tol).all()),
          f"{what}: distance error {err:.3g} above tolerance")
    return err


def row_scale(torch, q, x):
    """Per-query |q|^2 + max |x|^2, shaped to broadcast over [bq, k]."""
    qn = (q.float() ** 2).sum(-1)
    xn = (x.float() ** 2).sum(-1).max()
    return (qn + xn)[:, None]


def phase_kernels(torch, dev, seed: int, errs: dict) -> None:
    """Kernel vs twin at small ragged shapes: every filter kind x metric x
    k, a batched call (g = 3), the polygon fallback, and the distance
    kernel in fp32 and bf16."""
    from repro_torch.core import (BallFilter, ComposeFilter, IntervalFilter,
                                  PolygonFilter)
    from repro_torch.core.workloads import (make_box_filter,
                                            make_compose_filter,
                                            make_dataset_device)
    from repro_torch.kernels import ops
    from repro_torch.kernels.distance import (pairwise_dist_call,
                                              pairwise_dist_plain)
    from repro_torch.kernels.filtered_topk import (filtered_topk_call,
                                                   filtered_topk_plain)
    m, bq, n, d = 3, 37, 5003, 130
    x, s = make_dataset_device(n, d, m, seed=seed, device=dev)
    q = x[:bq] + 0.05
    ball = BallFilter(center=[0.5, 0.5], radius=0.4)
    filters = {
        "none": None,
        "box": make_box_filter(m, 0.3, seed=seed),
        "ball": ball,
        "box_ball": ComposeFilter(ball, IntervalFilter(dim=2, lo=0.2, hi=0.8),
                                  "and"),
        "box_not_ball": make_compose_filter(m, 0.3, seed=seed),
    }
    scale = row_scale(torch, q, x)[None]
    for kind, f in filters.items():
        got_kind, params = ops.encode_filter(f, m, mpad=m)
        check(got_kind == kind, f"encode_filter gave {got_kind} for {kind}")
        p = torch.as_tensor(params, device=dev)[None]
        for metric in ("l2", "ip"):
            for k in (10, 100, 300):
                kpad = ops.next_pow2(max(k, 8))
                kd, ki = filtered_topk_call(q[None], x[None], s[None], p,
                                            kind, kpad, metric)
                torch.cuda.synchronize()
                td, ti = filtered_topk_plain(q[None], x[None], s[None], p,
                                             kind, kpad, metric)
                e = compare_topk(torch, kd, ki, td, ti, scale,
                                 f"B1 {kind}/{metric}/k={k}")
                errs["filtered_topk"] = max(errs["filtered_topk"], e)
    # batch axis: three candidate sets, shared queries, per-set params
    xs = torch.stack([x[:4000], x[1000:5000], x[1003:]])
    ss = torch.stack([s[:4000], s[1000:5000], s[1003:]])
    box = torch.as_tensor(ops.encode_filter(filters["box"], m, mpad=m)[1],
                          device=dev)
    ps = torch.stack([box, box, box])
    ps[1, 0, 0] = 0.1                   # a different box for set 1
    kd, ki = filtered_topk_call(q[None], xs, ss, ps, "box", 16, "l2")
    td, ti = filtered_topk_plain(q[None], xs, ss, ps, "box", 16, "l2")
    errs["filtered_topk"] = max(errs["filtered_topk"], compare_topk(
        torch, kd, ki, td, ti, scale, "B1 batched g=3"))
    # a filter with no kernel encoding: PAD_META rows + kind "none"
    poly = PolygonFilter(vertices=[[0.1, 0.1], [0.9, 0.2], [0.6, 0.9]],
                         rest_lo=[0.0], rest_hi=[0.7])
    ki, kd = ops.filtered_topk(q, x, s, poly, 10)
    ok = poly.contains(s)
    s_pad = torch.where(ok[:, None], s, torch.full_like(s, ops.PAD_META))
    none = torch.as_tensor(ops.encode_filter(None, m, mpad=m)[1], device=dev)
    td, ti = filtered_topk_plain(q[None], x[None], s_pad[None], none[None],
                                 "none", 16, "l2")
    errs["filtered_topk"] = max(errs["filtered_topk"], compare_topk(
        torch, kd[None], ki[None], td[..., :10], ti[..., :10], scale,
        "B1 polygon fallback"))
    log(f"B1 vs twin: 5 kinds x 2 metrics x k in (10, 100, 300), batched "
        f"g=3 and polygon fallback agree; max |err| "
        f"{errs['filtered_topk']:.3g}")
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-5)):
        qq, xx = q.to(dtype), x.to(dtype)
        for metric in ("l2", "ip"):
            got = pairwise_dist_call(qq, xx, metric)
            torch.cuda.synchronize()
            want = pairwise_dist_plain(qq, xx, metric)
            tol = rtol * row_scale(torch, qq, xx)
            e = float((got - want).abs().max())
            check(bool(((got - want).abs() <= tol).all()),
                  f"B2 {dtype}/{metric}: error {e:.3g} above tolerance")
            errs["pairwise_dist"] = max(errs["pairwise_dist"], e)
    log(f"B2 vs twin: fp32 and bf16 x 2 metrics agree; max |err| "
        f"{errs['pairwise_dist']:.3g}")
    # B3 / B4 at a width with d % 4 != 0 (B4's element loads and tail
    # piece) and at the deployment width D (its 16-byte / 4-byte loads)
    phase_kernels_sharded(torch, dev, x, s, q, filters, errs)
    xw, sw = make_dataset_device(n, D, m, seed=seed + 1, device=dev)
    phase_kernels_sharded(torch, dev, xw, sw, xw[:bq] + 0.05, filters, errs)


def phase_kernels_sharded(torch, dev, x, s, q, filters, errs) -> None:
    """B3 and B4 against their twins on ragged shard stacks (g = 3) built
    from ``x``: every filter kind x metric, B3 at kpad 16 / 512 / 2048
    (the quantized over-fetch of k = 300 needs 2048), B4 on fp32 and int8
    blocks with missing positions."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_topk import (quant_topk_call,
                                                quant_topk_plain)
    from repro_torch.quant import dequantize, encode_segment
    g, cap = 3, 1664
    n, d = x.shape
    m = s.shape[1]
    fills = (cap, 1500, 777)
    codes = torch.zeros((g, cap, d), dtype=torch.int8, device=dev)
    ss = torch.full((g, cap, m), ops.PAD_META, device=dev)
    xsq = torch.zeros((g, cap), device=dev)
    scales = torch.zeros((g, d), device=dev)
    deq = torch.zeros((g, cap, d), device=dev)
    for gi, fill in enumerate(fills):
        lo = gi * 1000
        sq = encode_segment(x[lo:lo + fill].cpu().numpy())
        codes[gi, :fill] = torch.as_tensor(sq.codes, device=dev)
        ss[gi, :fill] = s[lo:lo + fill]
        xsq[gi, :fill] = torch.as_tensor(sq.xsq, device=dev)
        scales[gi] = torch.as_tensor(sq.scales, device=dev)
        deq[gi, :fill] = torch.as_tensor(dequantize(sq.codes, sq.scales),
                                         device=dev)
    qs = q[None] * scales[:, None, :]
    scale = row_scale(torch, q, deq.reshape(-1, d))[None]
    for kind, f in filters.items():
        params = torch.as_tensor(ops.encode_filter(f, m, mpad=m)[1],
                                 device=dev)
        for metric in ("l2", "ip"):
            for kpad in (16, 512, 2048):
                kd, ki = quant_topk_call(qs, codes, ss, xsq, params, kind,
                                         kpad, metric)
                torch.cuda.synchronize()
                td, ti = quant_topk_plain(qs, codes, ss, xsq, params, kind,
                                          kpad, metric)
                e = compare_topk(torch, kd, ki, td, ti, scale,
                                 f"B3 {kind}/{metric}/kpad={kpad}")
                errs["quant_topk"] = max(errs["quant_topk"], e)
    log(f"B3 vs twin: 5 kinds x 2 metrics x kpad in (16, 512, 2048) on "
        f"g={g} int8 stacks at d={d} agree; max |err| "
        f"{errs['quant_topk']:.3g}")
    rng = np.random.default_rng(7)
    xb = torch.zeros((g, cap, d), device=dev)
    for gi, fill in enumerate(fills):
        xb[gi, :fill] = x[gi * 1000: gi * 1000 + fill]
    b, c = q.shape[0], 512
    pos = torch.as_tensor(rng.integers(-1, g * cap, size=(b, c)),
                          dtype=torch.int32, device=dev)
    # the lanes a traversal hands B4: about 80% -1, whole rows included
    sparse = torch.where(torch.as_tensor(rng.uniform(size=(b, c)) < 0.2,
                                         device=dev), pos, -1)
    sparse[:b // 4] = -1
    for name, block, sc, ref_x in (("fp32", xb, None, xb),
                                   ("int8", codes, scales, deq)):
        tol = 1e-5 * row_scale(torch, q, ref_x.reshape(-1, d))
        for kind, f in filters.items():
            params = torch.as_tensor(ops.encode_filter(f, m, mpad=m)[1],
                                     device=dev)
            for metric in ("l2", "ip"):
                for lanes, pp in (("dense", pos), ("sparse", sparse)):
                    err = compare_hop(
                        torch, (q, pp, block, ss, params, kind, metric, sc),
                        tol, f"B4 {name} d={d} {kind}/{metric} {lanes}")
                    errs["graph_step"] = max(errs["graph_step"], err)
    log(f"B4 vs twin: fp32 and int8 blocks x 5 kinds x 2 metrics x dense "
        f"and sparse lanes, b={b} c={c} d={d} agree; max |err| "
        f"{errs['graph_step']:.3g}")


def phase_kernels_grouped(torch, dev, seed: int, errs: dict) -> None:
    """B1's grouped launch against its twin at ragged shapes (d = 130 and
    768, uneven shard rows, box and ball classes, both metrics), and
    bit for bit against the same groups launched solo at a row count where
    the grouped launch picks other candidate splits than the solo one."""
    import numpy as np
    from repro_torch.core import BallFilter
    from repro_torch.core.workloads import make_box_filter, make_dataset_device
    from repro_torch.kernels import ops
    from repro_torch.kernels.filtered_topk import (
        filtered_topk_call, filtered_topk_grouped_call,
        filtered_topk_grouped_plain, launch_config)
    for d, n, G, bq in ((130, 1500, 3, 19), (D, 20_000, 4, 200)):
        x, s = make_dataset_device(2 * n, d, 3, seed=seed + d, device=dev)
        xs, ss = x.reshape(2, n, d), s.reshape(2, n, 3)
        q = x[:G * bq].reshape(G, bq, d) + 0.05
        for kind, fs, kpad in (
                ("box", [make_box_filter(3, 0.1 + 0.2 * i, seed=i)
                         for i in range(G)], 16),
                ("ball", [BallFilter(center=np.asarray([0.5, 0.5]),
                                     radius=0.1 + 0.1 * i)
                          for i in range(G)], 32)):
            p = torch.stack([torch.as_tensor(
                ops.encode_filter(f, 3, mpad=3)[1], device=dev)
                for f in fs])
            for metric in ("l2", "ip"):
                kd, ki = filtered_topk_grouped_call(q, xs, ss, p, kind, kpad,
                                                    metric)
                torch.cuda.synchronize()
                td, ti = filtered_topk_grouped_plain(q, xs, ss, p, kind,
                                                     kpad, metric)
                for g in range(G):
                    errs["filtered_topk"] = max(
                        errs["filtered_topk"], compare_topk(
                            torch, kd[g], ki[g], td[g], ti[g],
                            row_scale(torch, q[g], x),
                            f"B1 grouped {kind}/{metric} d={d} group {g}"))
                    sd, si = filtered_topk_call(q[g][None], xs, ss,
                                                p[g][None], kind, kpad,
                                                metric)
                    check(bool(torch.equal(kd[g], sd)
                               and torch.equal(ki[g], si)),
                          f"B1 grouped {kind}/{metric} d={d}: group {g} "
                          f"differs from its solo launch")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        sp = [launch_config(g, bq, n, d, 16, 0, 0, sms)["splits"]
              for g in (2, 2 * G)]
        log(f"B1 grouped d={d}: {G} groups x 2 shard rows x {n}: splits "
            f"{sp[1]} grouped, {sp[0]} solo; == solo bit for bit")


def main_scan(torch, dev, n: int, d: int, nq: int, seed: int, errs: dict,
              keep: dict) -> None:
    """Exact filtered scan (kernel B1) over n vectors resident on the card,
    plus the public distance matrix (kernel B2) over the first 128K."""
    from repro_torch.core import BallFilter, ComposeFilter, IntervalFilter
    from repro_torch.core.workloads import (make_box_filter,
                                            make_compose_filter,
                                            make_dataset_device)
    from repro_torch.kernels import ops
    from repro_torch.kernels.filtered_topk import filtered_topk_plain
    from repro_torch.kernels.distance import pairwise_dist_plain
    m, k = 3, 10
    x, s = make_dataset_device(n, d, m, seed=seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    idx = torch.randint(0, n, (nq,), generator=gen, device=dev)
    q = x[idx] + 0.05 * torch.randn((nq, d), generator=gen, device=dev)
    log(f"data: x [{n}, {d}] fp32 = {x.numel() * 4 / 1e9:.2f} GB on the card")
    filters = {
        "box": make_box_filter(m, 0.1, seed=seed),
        "interval": IntervalFilter(dim=2, lo=0.3, hi=0.4),
        "ball_and_interval": ComposeFilter(
            BallFilter(center=[0.5, 0.5], radius=0.25),
            IntervalFilter(dim=2, lo=0.2, hi=0.7), "and"),
        "box_not_ball": make_compose_filter(m, 0.1, seed=seed),
    }
    scale = row_scale(torch, q[:32], x)
    for name, f in filters.items():
        t0 = time.perf_counter()
        ids, dd = ops.exact_filtered_search(q, x, s, f, k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(tuple(ids.shape) == (nq, k) and tuple(dd.shape) == (nq, k),
              f"scan {name}: shape {tuple(ids.shape)}")
        check(bool((ids >= 0).all()) and bool(torch.isfinite(dd).all()),
              f"scan {name}: misses on a filter that passes ~10% of points")
        kind, params = ops.encode_filter(f, m, mpad=m)
        td, ti = filtered_topk_plain(
            q[None, :32], x[None], s[None],
            torch.as_tensor(params, device=dev)[None], kind, 16, "l2")
        e = compare_topk(torch, dd[None, :32], ids[None, :32], td[..., :k],
                         ti[..., :k], scale, f"scan {name} vs twin")
        errs["filtered_topk"] = max(errs["filtered_topk"], e)
        log(f"scan {name} ({kind}): {nq} queries x {n} in {dt * 1e3:.1f} ms"
            f" (host clock), 32 queries match the twin, max |err| {e:.3g}")
    npd = min(n, 1 << 17)
    t0 = time.perf_counter()
    pd = ops.pairwise_dist(q, x[:npd])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(tuple(pd.shape) == (nq, npd) and bool(torch.isfinite(pd).all()),
          "pairwise_dist: bad result")
    want = pairwise_dist_plain(q[:32], x[:npd])
    e = float((pd[:32] - want).abs().max())
    check(bool(((pd[:32] - want).abs() <= 1e-5 * row_scale(
        torch, q[:32], x[:npd])).all()), f"pairwise_dist error {e:.3g}")
    errs["pairwise_dist"] = max(errs["pairwise_dist"], e)
    # the matrix's row minima are the unfiltered exact top-k
    ids, dd = ops.exact_filtered_search(q, x[:npd], s[:npd], None, k)
    srt = torch.sort(pd, dim=1).values[:, :k]
    check(bool(((srt - dd).abs() <= 1e-5 * row_scale(
        torch, q, x[:npd])).all()), "B1 unfiltered top-k != sorted B2 rows")
    log(f"pairwise_dist [{nq}, {npd}] in {dt * 1e3:.1f} ms (host clock), "
        f"matches the twin (max |err| {e:.3g}) and B1's unfiltered top-{k}")
    keep.update(x=x, s=s, q=q, box=filters["box"], npd=npd)


def main_index(torch, dev, n: int, d: int, nq: int, seed: int,
               keep: dict) -> None:
    """CubeGraph index built on the card and queried with both planners;
    ground truth from the exact scan.  Keeps the data, queries and index
    for phase 4b."""
    from repro_torch.core import CubeGraphConfig, CubeGraphIndex
    from repro_torch.core.workloads import (make_ball_filter,
                                            make_box_filter,
                                            make_compose_filter,
                                            make_dataset_device, recall)
    from repro_torch.kernels import ops
    m, k = 3, 10
    x, s = make_dataset_device(n, d, m, seed=seed + 10, device=dev)
    s_np = s.cpu().numpy().astype("float64")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    idx = torch.randint(0, n, (nq,), generator=gen, device=dev)
    q = x[idx] + 0.05 * torch.randn((nq, d), generator=gen, device=dev)
    t0 = time.perf_counter()
    index = CubeGraphIndex.build(x, s_np, CubeGraphConfig(), device=dev)
    torch.cuda.synchronize()
    log(f"index build: n={n} d={d} m={m}, {time.perf_counter() - t0:.1f} s,"
        f" {index.stats()}")
    q_np = q.cpu().numpy()
    for ratio in (0.01, 0.1):
        legs = {"box/predetermined": make_box_filter(m, ratio, seed=seed),
                "ball/onthefly": make_ball_filter(m, ratio, seed=seed),
                "box_not_ball/onthefly": make_compose_filter(m, ratio,
                                                             seed=seed)}
        for name, f in legs.items():
            gt, _ = ops.exact_filtered_search(q, x, s, f, k)
            gt = gt.cpu().numpy()
            t0 = time.perf_counter()
            ids, dd, st = index.query(q_np, f, k=k, ef=128,
                                      return_stats=True)
            dt = time.perf_counter() - t0
            check(ids.shape == (nq, k) and dd.shape == (nq, k),
                  f"index {name}: shape {ids.shape}")
            r = recall(ids, gt)
            log(f"index {name} ratio={ratio}: recall@10 {r:.4f}, "
                f"{nq / dt:.0f} QPS (host clock), hops {st.hops}, layer "
                f"{st.layer}, active cubes {st.n_active_cubes}, "
                f"mode {st.mode}")
            check(int((gt >= 0).sum()) > 0, f"index {name}: empty truth")
            check(r >= 0.8, f"index {name} ratio={ratio}: recall {r:.4f} "
                  "< 0.8")
    keep["index4"] = (x, s, q, index)


def main_baselines(torch, dev, nq: int, seed: int, keep: dict) -> dict:
    """The paper's baselines beside phase 4's CubeGraph index, on its data
    and queries: PostFiltering, PreFiltering,
    ACORN-4 and TreeGraph (leaves of 512) are built on the card and
    queried at ef 64 with box filters at ratios 0.01 and 0.1.  Fails only
    on a miswire: an unnavigable monolithic graph (PostFiltering's
    unfiltered recall@10 below 0.8 at ef 64 or below 0.95 at ``NAV_EF``)
    or CubeGraph not above PostFiltering at the same ef.  Returns the
    launches of B1 and B2 in this phase."""
    import numpy as np
    from repro_torch.core import (AcornIndex, BoxFilter, PostFilteringIndex,
                                  PreFilteringIndex, TreeGraphIndex)
    from repro_torch.core.workloads import make_box_filter, recall
    from repro_torch.kernels import ops
    mods = {name: importlib.import_module(f"repro_torch.kernels.{mod}")
            for name, mod in (("filtered_topk", "filtered_topk"),
                              ("pairwise_dist", "distance"))}
    for mod in mods.values():
        mod.reset_launch_count()
    m, k, ef = 3, 10, BASELINE_EF
    x, s, q, index = keep.pop("index4")
    n = x.shape[0]
    s_np = s.cpu().numpy().astype("float64")
    q_np = q.cpu().numpy()
    builds = {}
    for name, cls, kw in (("PostFiltering", PostFilteringIndex, {}),
                          ("PreFiltering", PreFilteringIndex, {}),
                          ("ACORN-4", AcornIndex, {"gamma": 4}),
                          ("TreeGraph", TreeGraphIndex, {"leaf_size": 512})):
        torch.cuda.synchronize()
        idx = cls(x, s_np, device=dev, **kw)
        torch.cuda.synchronize()
        builds[name] = idx
        log(f"baseline {name}: built in {idx.build_seconds:.2f} s, index "
            f"{idx.index_bytes()} bytes")
    total = sum(idx.build_seconds for idx in builds.values())
    log(f"baselines: four builds {total:.1f} s at n={n} (limit "
        f"{BASELINE_BUILD_S:.0f} s); CubeGraph index "
        f"{index.index_bytes()} bytes")
    f_all = BoxFilter(lo=np.full(m, -1.0, np.float32),
                      hi=np.full(m, 2.0, np.float32))
    gt_all = ops.exact_filtered_search(q, x, s, f_all, k)[0].cpu().numpy()
    r_all = {}
    for e in (ef, 128, NAV_EF):
        ids, _ = builds["PostFiltering"].query(q_np, f_all, k=k, ef=e)
        r_all[e] = recall(ids, gt_all)
    log("baseline PostFiltering unfiltered: recall@10 " + ", ".join(
        f"{r:.4f} at ef {e}" for e, r in r_all.items()))
    check(r_all[ef] >= 0.8 and r_all[NAV_EF] >= NAV_RECALL,
          f"PostFiltering unfiltered recall {r_all}: the monolithic graph "
          "is not navigable")
    for ratio in (0.01, 0.1):
        f = make_box_filter(m, ratio, seed=seed)
        gt = ops.exact_filtered_search(q, x, s, f, k)[0].cpu().numpy()
        check(int((gt >= 0).sum()) > 0, f"baselines {ratio}: empty truth")
        rec = {}
        for name, idx in [("CubeGraph", index)] + list(builds.items()):
            extra = ""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "TreeGraph":
                ids, dd, nsub = idx.query(q_np, f, k=k, ef=ef,
                                          return_n_subqueries=True)
                extra = f", {nsub} subqueries"
            else:
                ids, dd = idx.query(q_np, f, k=k, ef=ef)[:2]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(ids.shape == (nq, k) and dd.shape == (nq, k),
                  f"baseline {name}: shape {ids.shape}")
            rec[name] = recall(ids, gt)
            log(f"baseline {name} ratio={ratio}: recall@10 {rec[name]:.4f},"
                f" {nq / dt:.0f} QPS (host clock){extra}")
        check(rec["CubeGraph"] > rec["PostFiltering"],
              f"ratio {ratio}: CubeGraph recall {rec['CubeGraph']:.4f} not "
              f"above PostFiltering's {rec['PostFiltering']:.4f} at ef {ef}")
    launches = {kn: mod.launch_count() for kn, mod in mods.items()}
    keep["b2_knn"] = measure_knn_tile(torch, x, keep)
    return launches


def measure_knn_tile(torch, x, keep: dict, rows: int = 2048) -> dict:
    """B2 at the shape the monolithic builds launch it 7,203 times: one
    point chunk against one column chunk (``[rows, d] x [rows, d]``),
    held against its twin and timed beside its bound and the library's
    product."""
    from repro_torch.kernels.distance import (pairwise_dist_call,
                                              pairwise_dist_plain)
    qv, xc = x[:rows], x[rows:2 * rows]
    d = x.shape[1]
    got = pairwise_dist_call(qv, xc)
    want = pairwise_dist_plain(qv, xc)
    err = float((got - want).abs().max())
    tol = 1e-5 * float((qv * qv).sum(1).max() + (xc * xc).sum(1).max())
    check(err <= tol, f"B2 vs twin on the kNN tile: {err} > {tol}")
    keep["b2_knn_err"] = err
    ms = cuda_ms(torch, lambda: pairwise_dist_call(qv, xc), iters=20)
    plain = cuda_ms(torch, lambda: pairwise_dist_plain(qv, xc), iters=5)
    lib = cuda_ms(torch, lambda: (qv * qv).sum(1)[:, None]
                  - 2.0 * torch.matmul(qv, xc.T)
                  + (xc * xc).sum(1)[None, :], iters=5)
    flops = 2.0 * rows * rows * d
    nbytes = 4.0 * (2 * rows * d + rows * rows)
    bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    out = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
               bound_by="operations" if flops / PEAK_FP32_FLOPS
               >= nbytes / PEAK_BYTES else "bytes",
               max_abs_err=err, shape=f"q[{rows},{d}] x[{rows},{d}] fp32 l2")
    log(f"B2 on the monolithic build's kNN tile {out['shape']}: agrees with "
        f"the twin (max |err| {err:.3g}); kernel {ms:.4f} ms, twin "
        f"{plain:.4f} ms, library {lib:.4f} ms, bound {bound:.4f} ms "
        f"({out['bound_by']})")
    return out


class B1Tiles:
    """While active, records the metadata, parameters, kind and shape of
    every B1 launch made through ``repro_torch.kernels.ops`` (the scans of
    the read paths), so that the share of candidate tiles the kernel
    multiplies can be counted after the timed work (``take``)."""

    def __enter__(self):
        self.ops = importlib.import_module("repro_torch.kernels.ops")
        self.real, self.calls = self.ops.filtered_topk_call, []

        def recorder(q, x, s, params, kind, kpad, metric="l2"):
            self.calls.append((s, params, kind, q.shape[1], x.shape[2],
                               kpad))
            return self.real(q, x, s, params, kind, kpad, metric=metric)
        self.ops.filtered_topk_call = recorder
        return self

    def __exit__(self, *exc):
        self.ops.filtered_topk_call = self.real
        return False

    def take(self):
        """``(computed tiles, tiles)`` of 128 candidates over the launches
        recorded since the last call: each split of a launch packs its
        passing candidates into tiles of 128 (``_pass1.packed_tiles``,
        with the launch's own splits)."""
        import torch
        from repro_torch.kernels import _pass1
        b1 = importlib.import_module("repro_torch.kernels.filtered_topk")
        done = tiles = 0
        for s, params, kind, bq, d, kpad in self.calls:
            g, n = s.shape[:2]
            sms = (torch.cuda.get_device_properties(s.device)
                   .multi_processor_count if s.device.type == "cuda"
                   else 132)
            splits = b1.launch_config(g, bq, n, d, kpad, 0, 0,
                                      sms)["splits"]
            for gi in range(g):
                p = params[gi if params.shape[0] > 1 else 0]
                done += _pass1.packed_tiles(s[gi:gi + 1], p, kind, splits)
            tiles += g * -(-n // _pass1.TN)
        self.calls = []
        return done, tiles


def main_stream(torch, dev, n: int, d: int, nq: int, seed: int) -> float:
    """Default streaming SegmentManager: time-ordered ingest with seals,
    sync and async compaction, delete, TTL expiry, filtered queries.
    Returns the share of candidate tiles B1 computed in the queries."""
    import numpy as np
    from repro_torch.core import BoxFilter, ComposeFilter, IntervalFilter
    from repro_torch.core.workloads import make_dataset_device, recall
    from repro_torch.kernels import ops
    from repro_torch.streaming import SegmentManager, StreamConfig
    b1 = importlib.import_module("repro_torch.kernels.filtered_topk")
    m, k, batch = 3, 10, 4096
    xt, st_ = make_dataset_device(n, d, m, seed=seed + 20, device=dev)
    x, s = xt.cpu().numpy(), st_.cpu().numpy().astype(np.float64)
    s[:, 2] = np.arange(n) / n                    # event time
    cfg = StreamConfig(time_dim=2, ttl=0.8)
    mgr = SegmentManager(d, m, cfg, device=dev)
    t0 = time.perf_counter()
    n_batches = math.ceil(n / batch)
    for bi, lo in enumerate(range(0, n, batch)):
        mgr.ingest(x[lo:lo + batch], s[lo:lo + batch])
        if bi == n_batches // 2:
            out = mgr.maintenance(async_compaction=True)
            check(out["compaction_ops"] is None, "async tick returned ops")
            mgr.wait_for_compaction()
        else:
            mgr.maintenance()
    torch.cuda.synchronize()
    st = mgr.stats()
    log(f"stream ingest: {n} points in batches of {batch}, "
        f"{time.perf_counter() - t0:.1f} s; sealed {st['sealed']}, "
        f"compactions {st['compactions']}, segments {st['n_segments']}, "
        f"delta {st['delta_live']}")
    check(st["health"].get("compactor", {}).get("runs", 0) >= 1,
          "async compaction did not run")
    rng = np.random.default_rng(seed)
    live = np.nonzero(mgr.alive)[0]
    dead = rng.choice(live, size=len(live) // 100, replace=False)
    mgr.delete(dead)
    expired = mgr.expire(now=mgr.now + 0.15)
    log(f"stream: deleted {len(dead)}, expired {expired}; live "
        f"{mgr.n_live} of {mgr.n_total}")
    check(mgr.delta.n_live > 0, "delta buffer is empty: no delta scan")
    qi = rng.integers(0, n, nq)
    q = x[qi] + 0.05 * rng.normal(size=(nq, d)).astype(np.float32)
    alive = mgr.alive
    live = np.nonzero(alive)[0]
    filters = {
        "interval": IntervalFilter(dim=2, lo=0.9),
        "box_and_interval": ComposeFilter(
            BoxFilter(lo=np.asarray([0.2, 0.2, 0.0], np.float32),
                      hi=np.asarray([0.8, 0.8, 1.0], np.float32)),
            IntervalFilter(dim=2, lo=0.6, hi=1.0), "and"),
    }
    tiles = [0, 0]           # B1's computed and all candidate tiles
    for name, f in filters.items():
        before = b1.launch_count()
        with B1Tiles() as b1_tiles:
            t0 = time.perf_counter()
            gids, dd, stats = mgr.query(q, f, k=k, ef=128,
                                        return_stats=True)
            dt = time.perf_counter() - t0
        live_t, all_t = b1_tiles.take()
        scans = b1.launch_count() - before
        check(any(t.kind == "delta" and not t.pruned for t in stats),
              f"stream {name}: the delta buffer was pruned")
        check(scans >= 1, f"stream {name}: the delta scan did not launch B1")
        check(not bool(np.isin(gids[gids >= 0], dead).any()),
              f"stream {name}: returned a deleted point")
        gt, _ = ops.exact_filtered_search(q, x[live], s[live], f, k,
                                          device=dev)
        gt = gt.cpu().numpy()
        gt = np.where(gt >= 0, live[np.maximum(gt, 0)], -1)
        r = recall(gids, gt)
        searched = sum(1 for t in stats if not t.pruned)
        log(f"stream {name}: recall@10 {r:.4f}, {nq / dt:.0f} QPS (host "
            f"clock), {searched} of {len(stats)} segments searched, B1 "
            f"launches {scans}, computing {live_t} of {all_t} candidate "
            f"tiles ({live_t / max(all_t, 1):.4f})")
        check(r >= 0.8, f"stream {name}: recall {r:.4f} < 0.8")
        tiles[0] += live_t
        tiles[1] += all_t
    return tiles[0] / max(tiles[1], 1)


def main_sharded(torch, dev, n: int, d: int, nq: int, seed: int,
                 keep: dict) -> dict:
    """The sharded sealed read path: two SegmentManagers (fp32 and int8
    packs, the exp13/exp15 settings) ingest a time-ordered stream with a
    maintenance tick per batch, then 1% deletes and a TTL expiry; each
    filter is queried with forced scan, forced graph and the planner's
    choice.  Returns the launches of B1 / B3 / B4 in this phase."""
    import numpy as np
    from repro_torch.core import BoxFilter, ComposeFilter, IntervalFilter
    from repro_torch.core.workloads import make_dataset_device, recall
    from repro_torch.kernels import ops
    from repro_torch.streaming import SegmentManager, StreamConfig
    mods = {name: importlib.import_module(f"repro_torch.kernels.{mod}")
            for name, mod in (("filtered_topk", "filtered_topk"),
                              ("quant_topk", "quant_topk"),
                              ("graph_step", "graph_topk"))}
    m, k, batch = 3, 10, 4096
    xt, st_ = make_dataset_device(n, d, m, seed=seed + 30, device=dev)
    x, s = xt.cpu().numpy(), st_.cpu().numpy().astype(np.float64)
    s[:, 2] = np.arange(n) / n                    # event time
    rng = np.random.default_rng(seed + 31)
    qi = rng.integers(0, n, nq)
    q = x[qi] + 0.05 * rng.normal(size=(nq, d)).astype(np.float32)
    filters = {
        "interval": IntervalFilter(dim=2, lo=0.9),
        "box_and_interval": ComposeFilter(
            BoxFilter(lo=np.asarray([0.2, 0.2, 0.0], np.float32),
                      hi=np.asarray([0.8, 0.8, 1.0], np.float32)),
            IntervalFilter(dim=2, lo=0.6, hi=1.0), "and"),
    }
    for mod in mods.values():
        mod.reset_launch_count()
    managers, packs = {}, {}
    for quantize in (None, "int8"):
        cfg = StreamConfig(time_dim=2, seal_max_points=2048, n_shards=2,
                           read_path="auto", graph_ef=192, rerank_multiple=4,
                           ttl=0.8, quantize=quantize)
        mgr = SegmentManager(d, m, cfg, device=dev)
        t0 = time.perf_counter()
        for bi, lo in enumerate(range(0, n, batch)):
            mgr.ingest(x[lo:lo + batch], s[lo:lo + batch])
            mgr.maintenance()
            if bi == EARLY_QUERY_BATCH:
                # a query while the stream is young builds the pack; from
                # here on every seal, compaction, delete and expiry reaches
                # it through the copy-on-write deltas
                mgr.query(q[:64], None, k=k)
                packs[quantize or "fp32"] = mgr._pack
                check(mgr._pack is not None, "the early query built no pack")
        torch.cuda.synchronize()
        st = mgr.stats()
        log(f"sharded[{quantize or 'fp32'}] ingest: {n} points, "
            f"{time.perf_counter() - t0:.1f} s; sealed {st['sealed']}, "
            f"compactions {st['compactions']}, segments {st['n_segments']}")
        managers[quantize or "fp32"] = mgr
    dead = None
    for name, mgr in managers.items():
        live = np.nonzero(mgr.alive)[0]
        if dead is None:
            dead = np.random.default_rng(seed + 32).choice(
                live, size=len(live) // 100, replace=False)
        mgr.delete(dead)
        expired = mgr.expire(now=mgr.now + 0.15)
        log(f"sharded[{name}]: deleted {len(dead)}, expired {expired}; "
            f"live {mgr.n_live} of {mgr.n_total}")
        pack_errors = mgr.stats()["health"].get("pack_delta", {})
        check(mgr._pack is packs[name] and not pack_errors.get("errors"),
              f"sharded[{name}]: the pack was rebuilt instead of kept by "
              f"deltas ({pack_errors.get('last_error')})")
    check(bool(np.array_equal(managers["fp32"].alive,
                              managers["int8"].alive)),
          "the two managers disagree on liveness")
    live = np.nonzero(managers["fp32"].alive)[0]
    truth = {}
    for fname, f in filters.items():
        gt, _ = ops.exact_filtered_search(q, x[live], s[live], f, k,
                                          device=dev)
        gt = gt.cpu().numpy()
        truth[fname] = np.where(gt >= 0, live[np.maximum(gt, 0)], -1)
    tiles_5b = [0, 0]        # B1's computed and all candidate tiles
    with B4Split() as b4split:
        for name, mgr in managers.items():
            for fname, f in filters.items():
                for rp in ("scan", "graph", "auto"):
                    before = {kn: mod.launch_count() for kn, mod in mods.items()}
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    with B1Tiles() as b1_tiles:
                        t0 = time.perf_counter()
                        gids, dd = mgr.query(q, f, k=k, read_path=rp)
                        torch.cuda.synchronize()
                        dt = time.perf_counter() - t0
                    live_t, all_t = b1_tiles.take()
                    tiles_5b[0] += live_t
                    tiles_5b[1] += all_t
                    # the query's own working memory (visited bitmaps, beams,
                    # kernel outputs)
                    work = (torch.cuda.max_memory_allocated() - base) / 2**30
                    used = {kn: mod.launch_count() - before[kn]
                            for kn, mod in mods.items()}
                    check(gids.shape == (nq, k) and dd.shape == (nq, k),
                          f"sharded {name}/{fname}/{rp}: shape {gids.shape}")
                    check(not bool(np.isin(gids[gids >= 0], dead).any()),
                          f"sharded {name}/{fname}/{rp}: a deleted point")
                    r = recall(gids, truth[fname])
                    plan = ({c: p.mode for c, p in mgr.last_plan.items()}
                            if rp != "scan" and mgr.last_plan else {})
                    b1_share = (f", B1 computes {live_t} of {all_t} candidate "
                                f"tiles ({live_t / all_t:.4f})" if all_t else "")
                    log(f"sharded[{name}] {fname} read_path={rp}: recall@10 "
                        f"{r:.4f}, {nq / dt:.0f} QPS (host clock), query "
                        f"working memory {work:.3f} GiB, launches {used}, "
                        f"plan {plan}{b1_share}")
                    floor = 0.999 if (name, rp) == ("fp32", "scan") else 0.8
                    check(r >= floor, f"sharded {name}/{fname}/{rp}: recall "
                          f"{r:.4f} < {floor}")
    # the int8 exact rerank also launches B4: the traversal's own launches
    # show that the graph read path ran
    log(f"sharded phase: B4 launches by the traversals "
        f"{b4split.traversal}, by the int8 rerank {b4split.other}")
    check(b4split.traversal >= 1, "no graph traversal launched B4 in 5b")
    launches = {kn: mod.launch_count() for kn, mod in mods.items()}
    log(f"sharded phase launches: {launches}")
    for kn, c in launches.items():
        check(c >= 1, f"kernel {kn} was not launched in the sharded phase")
    nb = {name: mgr.stats()["pack_nbytes"] for name, mgr in managers.items()}
    log(f"sharded pack device bytes: fp32 {nb['fp32']}, int8 {nb['int8']},"
        f" ratio {nb['fp32'] / max(nb['int8'], 1):.3f}; buckets "
        f"{managers['fp32'].stats()['pack_buckets']}")
    log(f"sharded phase: B1 computed {tiles_5b[0]} of {tiles_5b[1]} "
        f"candidate tiles of 128 ({tiles_5b[0] / max(tiles_5b[1], 1):.4f})")
    keep.update(managers=managers, q_sharded=q, sharded_filters=filters,
                sharded_filter=filters["box_and_interval"],
                b1_live_share_5b=tiles_5b[0] / max(tiles_5b[1], 1))
    return launches


class B4Split:
    """While active, counts B4 launches made by a graph traversal (each
    follows the traversal's ``_unique_mask`` of that hop's lanes) apart
    from the others (the int8 exact rerank's)."""

    def __enter__(self):
        self.gmod = importlib.import_module("repro_torch.kernels.graph_topk")
        self.real = self.gmod.beam_step_scores
        self.real_unique = self.gmod._unique_mask
        self.traversal = self.other = self._pending = 0

        def unique(ids):
            self._pending += 1
            return self.real_unique(ids)

        def recorder(*a, **kw):
            if self._pending:
                self._pending -= 1
                self.traversal += 1
            else:
                self.other += 1
            return self.real(*a, **kw)
        self.gmod.beam_step_scores, self.gmod._unique_mask = recorder, unique
        return self

    def __exit__(self, *exc):
        self.gmod.beam_step_scores = self.real
        self.gmod._unique_mask = self.real_unique
        return False


def record_hops(torch, mgr, q, f, k: int) -> dict:
    """One forced-graph read of ``mgr``, recording the arguments of every
    B4 launch and the hop's raw lanes: ``{block data_ptr: [((q, pos,
    block, meta, params, kind, metric, scales), raw), ...]}`` in launch
    order (the seed scoring, then one per hop).  ``pos`` holds the lanes
    the traversal keeps (-1 elsewhere), ``raw`` every lane before that
    mask (the seeds, or the frontier's neighbours): the argument of the
    traversal's ``_unique_mask`` just before the launch."""
    gmod = importlib.import_module("repro_torch.kernels.graph_topk")
    real, real_unique = gmod.beam_step_scores, gmod._unique_mask
    calls: dict = {}
    raw = []

    def unique(ids):
        raw.append(ids.to(torch.int32))
        return real_unique(ids)

    def recorder(q, pos, x, s, params, kind, metric="l2", scales=None):
        if raw:        # a hop of the traversal (not the int8 rerank)
            calls.setdefault(x.data_ptr(), []).append(
                ((q, pos.clone(), x, s, params, kind, metric, scales),
                 raw.pop()))
        return real(q, pos, x, s, params, kind, metric, scales=scales)
    gmod.beam_step_scores, gmod._unique_mask = recorder, unique
    try:
        mgr.query(q, f, k=k, read_path="graph")
    finally:
        gmod.beam_step_scores, gmod._unique_mask = real, real_unique
    return calls


def measure_sharded(torch, keep: dict, nq: int, errs: dict) -> dict:
    """B3 over the largest int8 bucket (kpad 64, the over-fetch of k = 10
    at rerank_multiple 4), and B4 on one hop as a traversal makes it (the
    middle hop of a forced-graph box-and-interval read, on the largest
    bucket it traverses) in the fp32 and int8 managers, on two lane sets:
    the lanes the traversal hands B4 (the fresh ones, -1 elsewhere) and
    the hop's raw lanes (every neighbour of the expanded frontier).  Each
    is held against its twin on these inputs, then timed beside the twin,
    its bound and a library yardstick.  The forced-graph read is also
    timed whole on the host clock, with its hops and the fresh share of
    every hop."""
    from repro_torch.kernels import ops
    from repro_torch.kernels._pass1 import packed_tiles
    from repro_torch.kernels.graph_topk import (beam_step_plain,
                                                beam_step_scores)
    from repro_torch.kernels.quant_topk import (quant_topk_call,
                                                quant_topk_plain)
    b3mod = importlib.import_module("repro_torch.kernels.quant_topk")
    managers, f = keep["managers"], keep["sharded_filter"]
    q_np = keep["q_sharded"]
    dev = managers["fp32"].device
    q = torch.as_tensor(q_np, device=dev)
    d = q.shape[1]
    qn = (q * q).sum(-1)[:, None]
    out = {}
    view = managers["int8"]._pack.view()
    bv = max(view.buckets, key=lambda b: b.gids.numel())
    rows, cap = bv.gids.shape
    m = bv.s.shape[2]
    kind, params = ops.encode_filter(f, m, mpad=m)
    p = torch.as_tensor(params, device=dev)
    kpad = 64
    qs = q[None] * bv.scales[:, None, :]
    args = (qs, bv.codes, bv.s, bv.xsq, p, kind, kpad, "l2")
    kd, ki = quant_topk_call(*args)
    torch.cuda.synchronize()
    td, ti = quant_topk_plain(*args)
    e = compare_topk(torch, kd, ki, td, ti, qn + bv.xsq.max(),
                     f"B3 main-path bucket [{rows}, {cap}]")
    errs["quant_topk"] = max(errs["quant_topk"], e)
    log(f"B3 vs twin on the largest int8 bucket [{rows}, {cap}, {d}], "
        f"{nq} queries, {kind}, kpad {kpad}: agree, max |err| {e:.3g}")
    ms = cuda_ms(torch, lambda: quant_topk_call(*args), iters=10)
    plain = cuda_ms(torch, lambda: quant_topk_plain(*args), iters=2,
                    warmup=1)
    # the same codes with every candidate passing: the kernel computes all
    # tiles, so this is its dense tile rate
    every = (qs, bv.codes, torch.zeros_like(bv.s), bv.xsq, torch.as_tensor(
        ops.encode_filter(None, m, mpad=m)[1], device=dev), "none", kpad,
        "l2")
    dense_ms = cuda_ms(torch, lambda: quant_topk_call(*every), iters=5)
    lo = p[0, :m]
    hi = p[1, :m]

    def b3_library():
        deqb = bv.codes.float() * bv.scales[:, None, :]
        dm = bv.xsq[:, None, :] - 2.0 * torch.matmul(q[None],
                                                     deqb.transpose(1, 2))
        ok = ((bv.s >= lo) & (bv.s <= hi)).all(-1)
        return torch.topk(dm.masked_fill_(~ok[:, None, :], float("inf")),
                          kpad, dim=-1, largest=False)
    lib = cuda_ms(torch, b3_library, iters=3, warmup=1)
    # what these inputs need: the products of the candidates that pass the
    # predicate; all metadata and norms, the passing codes, the folded
    # queries and the lists.  dense_bound_ms counts every position, as the
    # bound did before the kernel skipped tiles.
    npos = rows * cap
    passing, live, tiles = b3mod.live_tiles(bv.s, p, kind, b3mod.TN)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = b3mod.launch_config(rows, nq, cap, d, kpad, 0, 0,
                                 sms)["splits"]
    packed = packed_tiles(bv.s, p, kind, splits)
    rest = 4.0 * rows * nq * d + 8.0 * rows * nq * kpad
    flops = 2.0 * nq * passing * d
    nbytes = npos * (4 * m + 4) + passing * d + rest
    dense_flops = 2.0 * nq * npos * d
    dense_bytes = npos * (d + 4 * m + 4) + rest
    log(f"B3 bucket: {passing} of {npos} candidates pass "
        f"({passing / npos:.4f}), {live} of {tiles} tiles of {b3mod.TN} "
        f"hold one ({live / tiles:.4f}); the kernel multiplies {packed} "
        f"packed tiles ({packed / tiles:.4f})")
    out["quant_topk"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib,
        bound_ms=max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        bound_by="operations" if flops / PEAK_FP32_FLOPS
        >= nbytes / PEAK_BYTES else "bytes",
        dense_bound_ms=max(dense_flops / PEAK_FP32_FLOPS,
                           dense_bytes / PEAK_BYTES) * 1e3,
        pass_share=passing / npos, live_tile_share=live / tiles,
        tile_share=packed / tiles,
        dense_ms=dense_ms,
        shape=f"q[{nq},{d}] codes[{rows},{cap},{d}] int8 {kind} kpad={kpad}")
    for name in ("fp32", "int8"):
        mgr = managers[name]
        # the read alone on the host clock, then again with B4's arguments
        # recorded (the same hops: the traversal is deterministic)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.query(q_np, f, k=10, read_path="graph")
        torch.cuda.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        calls = record_hops(torch, mgr, q_np, f, 10)
        check(bool(calls), f"B4 {name}: the graph read traversed no bucket")
        n_read, live_all, valid_all, shares = 0, 0, 0, []
        for seq in calls.values():
            per = []
            for args, raw in seq[1:]:
                live = int((args[1] >= 0).sum())
                valid = int((raw >= 0).sum())
                per.append(live / max(valid, 1))
                live_all += live
                valid_all += valid
            n_read += len(per)
            shares.append(" ".join(f"{v:.2f}" for v in per))
        fresh = live_all / max(valid_all, 1)
        log(f"B4 {name}: the forced-graph read takes {read_ms:.2f} ms for "
            f"{n_read} hops over {len(calls)} buckets, "
            f"{read_ms / max(n_read, 1):.3f} ms per hop (host clock); "
            f"fresh share of the valid lanes {fresh:.4f}, per hop: "
            + " | ".join(shares))
        # the largest traversed bucket, its middle hop (launch 0 scores
        # the seeds)
        seq = max(calls.values(),
                  key=lambda c: c[0][0][2].shape[0] * c[0][0][2].shape[1])
        n_hops = len(seq) - 1
        check(n_hops >= 1, f"B4 {name}: the traversal made no hop")
        hop = (n_hops + 1) // 2
        args, raw = seq[hop]
        del calls, seq
        res = {lanes: measure_hop(torch, hargs, name,
                                  f"{lanes} lanes of hop {hop} of {n_hops}",
                                  errs)
               for lanes, hargs in (("traversal", args),
                                    ("raw", args[:1] + (raw,) + args[2:]))}
        out[f"graph_step_{name}"] = dict(
            res["traversal"], raw=res["raw"], fresh_share=fresh,
            read_hops=n_read, read_ms=read_ms,
            ms_per_hop=read_ms / max(n_read, 1))
    return out


def measure_hop(torch, args, name: str, what: str, errs: dict) -> dict:
    """B4 on one recorded hop's ``args`` (q, pos, block, meta, params,
    kind, metric, scales) of the ``name`` (fp32 / int8) manager: held
    against its twin, then timed beside the twin, a library call on the
    same lanes, its bound (each distinct row read once) and the time its
    gathers would take if each came from HBM."""
    from repro_torch.kernels.graph_topk import (beam_step_plain,
                                                beam_step_scores)
    hq, pos, block, s_blk, hp, hkind, metric, sc = args
    rows, cap, d = block.shape
    b, c = pos.shape
    m = s_blk.shape[2]
    valid = pos >= 0
    n_valid = int(valid.sum())
    uniq = int(torch.unique(pos[valid]).numel())
    neg = 1.0 - n_valid / max(b * c, 1)
    deq = (block.float() * sc[:, None, :] if name == "int8"
           else block).reshape(rows * cap, d)
    tol = 1e-5 * ((hq * hq).sum(-1)[:, None] + (deq * deq).sum(-1).max())
    del deq
    e = compare_hop(torch, args, tol, f"B4 {name} {what}")
    errs["graph_step"] = max(errs["graph_step"], e)
    log(f"B4 {name} vs twin on the {what} of the forced-graph read, block "
        f"[{rows}, {cap}, {d}], b={b} c={c}: agree, max |err| {e:.3g}; "
        f"{neg:.4f} of the lanes are -1, {uniq} distinct rows in "
        f"{n_valid} gathers")
    kw = {"scales": sc}
    head = args[:7]
    ms = cuda_ms(torch, lambda: beam_step_scores(*head, **kw), iters=10)
    plain = cuda_ms(torch, lambda: beam_step_plain(*head, **kw), iters=3,
                    warmup=1)
    flat_x = block.reshape(rows * cap, d)
    flat_s = s_blk.reshape(rows * cap, m)
    pl = pos.long().clamp_min(0)
    lo = hp[0, :m]
    hi = hp[1, :m]

    def b4_library():
        cx = flat_x[pl]
        if name == "int8":
            cx = cx.float() * sc[pl // cap]
        ip = torch.bmm(cx, hq[:, :, None])[:, :, 0]
        dm = (cx * cx).sum(-1) - 2.0 * ip + (hq * hq).sum(-1)[:, None]
        cm = flat_s[pl]
        ok = ((cm >= lo) & (cm <= hi)).all(-1) & valid
        return dm.masked_fill(~valid, float("inf")), ok
    lib = cuda_ms(torch, b4_library, iters=3, warmup=1)
    row_b = d * (1 if name == "int8" else 4) + 4 * m
    nbytes = uniq * row_b + 4.0 * b * c + 4.0 * b * d + 8.0 * b * c
    if name == "int8":
        nbytes += 4.0 * rows * d
    flops = 4.0 * n_valid * d
    gathered = n_valid * row_b
    no_reuse = gathered / PEAK_BYTES * 1e3
    log(f"B4 {name} {what}: {uniq} distinct rows of {rows * cap} gathered "
        f"{n_valid} times ({gathered / 1e9:.3f} GB if every gather came "
        f"from HBM, {no_reuse:.3f} ms)")
    return dict(
        ms=ms, plain_ms=plain, library_ms=lib,
        bound_ms=max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        bound_by="operations" if flops / PEAK_FP32_FLOPS
        >= nbytes / PEAK_BYTES else "bytes",
        no_reuse_ms=no_reuse, neg_share=neg, distinct_rows=uniq,
        gathers=n_valid,
        shape=f"{what} of a forced-graph read: q[{b},{d}] pos[{b},{c}] "
              f"({neg:.4f} of lanes -1, {uniq} distinct rows) "
              f"block[{rows},{cap},{d}] {name} {hkind}")


def measure(torch, keep: dict, nq: int, d: int) -> dict:
    """Kernel, twin and library times at the main path's shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels._pass1 import TN, live_tiles, packed_tiles
    from repro_torch.kernels.distance import (pairwise_dist_call,
                                              pairwise_dist_plain)
    from repro_torch.kernels.filtered_topk import (filtered_topk_call,
                                                   filtered_topk_plain)
    b1mod = importlib.import_module("repro_torch.kernels.filtered_topk")
    x, s, q, f = keep["x"], keep["s"], keep["q"], keep["box"]
    n, m, k = x.shape[0], s.shape[1], 10
    kind, params = ops.encode_filter(f, m, mpad=m)
    p = torch.as_tensor(params, device=x.device)[None]
    kpad = ops.next_pow2(max(k, 8))
    args = (q[None], x[None], s[None], p, kind, kpad, "l2")
    b1_ms = cuda_ms(torch, lambda: filtered_topk_call(*args), iters=10)
    b1_plain = cuda_ms(torch, lambda: filtered_topk_plain(*args), iters=2,
                       warmup=1)
    lo = torch.as_tensor(params[0, :m], device=x.device)
    hi = torch.as_tensor(params[1, :m], device=x.device)

    def b1_library():
        dm = (q * q).sum(1)[:, None] - 2.0 * torch.matmul(q, x.T) \
            + (x * x).sum(1)[None, :]
        ok = ((s >= lo) & (s <= hi)).all(1)
        return torch.topk(dm.masked_fill_(~ok[None, :], float("inf")), k,
                          dim=1, largest=False)
    b1_lib = cuda_ms(torch, b1_library, iters=3, warmup=1)

    def b1_gather_library():
        # the filter is shared by every query: gather the passing vectors
        # once, then one product over them (the nonzero syncs the host)
        idx = ((s >= lo) & (s <= hi)).all(1).nonzero()[:, 0]
        xg = x[idx]
        dm = (q * q).sum(1)[:, None] - 2.0 * torch.matmul(q, xg.T) \
            + (xg * xg).sum(1)[None, :]
        dd, jj = torch.topk(dm, k, dim=1, largest=False)
        return dd, idx[jj]
    kd, ki = filtered_topk_call(*args)
    gd, gi = b1_gather_library()
    compare_topk(torch, kd[0, :, :k], ki[0, :, :k], gd, gi.int(),
                 row_scale(torch, q, x), "B1 vs the gather-first "
                 "library call")
    b1_gather = cuda_ms(torch, b1_gather_library, iters=3, warmup=1)
    # what these inputs need: the products of the candidates that pass
    # the filter (the same for every query); every metadata row, the
    # passing vectors, the queries and the lists.  dense_bound_ms counts
    # every candidate, as the dense library call does.
    passing, live, tiles = live_tiles(s[None], p[0], kind)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = b1mod.launch_config(1, nq, n, d, kpad, 0, 0, sms)["splits"]
    packed = packed_tiles(s[None], p[0], kind, splits)
    rest = 4.0 * (n * m + nq * d + 4 * m) + 8.0 * nq * kpad
    flops = 2.0 * nq * passing * d
    nbytes = 4.0 * passing * d + rest
    b1_bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    b1_dense = max(2.0 * nq * n * d / PEAK_FP32_FLOPS,
                   (4.0 * n * d + rest) / PEAK_BYTES) * 1e3
    log(f"B1 scan: {passing} of {n} candidates pass ({passing / n:.4f}), "
        f"{live} of {tiles} tiles of {TN} hold one; the kernel multiplies "
        f"{packed} packed tiles ({packed / tiles:.4f}); library: "
        f"gather-first {b1_gather:.3f} ms, dense {b1_lib:.3f} ms")
    npd = keep["npd"]
    xp = x[:npd]
    b2_ms = cuda_ms(torch, lambda: pairwise_dist_call(q, xp), iters=10)
    b2_plain = cuda_ms(torch, lambda: pairwise_dist_plain(q, xp), iters=5)
    b2_lib = cuda_ms(torch, lambda: (q * q).sum(1)[:, None]
                     - 2.0 * torch.matmul(q, xp.T)
                     + (xp * xp).sum(1)[None, :], iters=5)
    flops2 = 2.0 * nq * npd * d
    bytes2 = 4.0 * (nq * d + npd * d + nq * npd)
    b2_bound = max(flops2 / PEAK_FP32_FLOPS, bytes2 / PEAK_BYTES) * 1e3
    return {
        "filtered_topk": dict(
            ms=b1_ms, plain_ms=b1_plain, library_ms=b1_lib,
            bound_ms=b1_bound, bound_by="operations"
            if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes",
            dense_bound_ms=b1_dense, pass_share=passing / n,
            gather_library_ms=b1_gather, scan_tile_share=packed / tiles,
            shape=f"q[{nq},{d}] x[{n},{d}] s[{n},{m}] {kind} k={k}"),
        "pairwise_dist": dict(
            ms=b2_ms, plain_ms=b2_plain, library_ms=b2_lib,
            bound_ms=b2_bound, bound_by="operations"
            if flops2 / PEAK_FP32_FLOPS >= bytes2 / PEAK_BYTES else "bytes",
            shape=f"q[{nq},{d}] x[{npd},{d}] fp32 l2"),
    }


# ---------------------------------------------------------------------------
# Kernel B5 (decode attention) and the generation side
# ---------------------------------------------------------------------------
def _dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, files in os.walk(root) for f in files)


def _locked_pack(mgr):
    with mgr._lock:
        return mgr._pack, mgr._pack.view(), mgr._pack.nbytes


def main_durability(torch, dev, keep: dict, nq: int) -> dict:
    """Snapshots, restores and tiering on phase 5b's two managers (fp32 and
    int8): each is snapshotted into a temporary directory, restored on the
    card, and queried with 5b's queries and filters under scan, graph and
    auto — bit for bit the original's answers (the scans against its
    delta-kept pack as well as a rebuilt one, the traversals against its
    pack rebuilt from the same live segments, as a restore builds it).  It is then restored again
    under a device budget of a third of its pack (the largest bucket stays
    cold) and must answer the scans bit for bit as all-resident, with the
    resident bytes within the budget after every query and tier misses
    counted.  Then one cold dispatch is timed against the same bucket
    resident, with its host-to-device copy, and one side-stream admission.
    Returns the launches of B1 / B3 / B4 in the checked part (the timed
    part after it is not counted)."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.streaming import SegmentManager
    mods = {name: importlib.import_module(f"repro_torch.kernels.{mod}")
            for name, mod in (("filtered_topk", "filtered_topk"),
                              ("quant_topk", "quant_topk"),
                              ("graph_step", "graph_topk"))}
    for mod in mods.values():
        mod.reset_launch_count()
    k = 10
    q, filters = keep["q_sharded"], keep["sharded_filters"]
    root = tempfile.mkdtemp(prefix="cubegraph-5c-")
    timed = []
    try:
        for name, mgr in keep["managers"].items():
            snap = os.path.join(root, name)
            t0 = time.perf_counter()
            man = mgr.snapshot_to(snap)
            dt = time.perf_counter() - t0
            nbytes = _dir_bytes(snap)
            log(f"durability[{name}]: snapshot {dt:.2f} s, {nbytes} bytes "
                f"written ({nbytes / dt / 1e9:.2f} GB/s), "
                f"{len(man['segments'])} segment artifacts")
            t0 = time.perf_counter()
            rest = SegmentManager.restore(snap, device=dev, resume=False)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            t0 = time.perf_counter()
            rest.query(q, filters["interval"], k=k, read_path="scan")
            torch.cuda.synchronize()
            log(f"durability[{name}]: restore {t_restore:.2f} s, first "
                f"query (the pack's cold build) "
                f"{time.perf_counter() - t0:.2f} s")
            for fname, f in filters.items():
                ga, da = mgr.query(q, f, k=k, read_path="scan")
                gb, db = rest.query(q, f, k=k, read_path="scan")
                check(bool(np.array_equal(ga, gb))
                      and bool(np.array_equal(da, db)),
                      f"restored[{name}] {fname}/scan: answers differ from "
                      "the original's delta-kept pack")
            # the pack is derived state: a traversal follows the graph the
            # pack staged, and a delta-kept pack keeps the edges of points
            # deleted after their segment was packed, where a cold build
            # (a restore's) has only the live rows' edges.  So the graph
            # and auto legs hold the restored manager to the original
            # with its pack rebuilt from the same live segments.
            with mgr._lock:
                mgr._pack = None
            for fname, f in filters.items():
                for rp in ("scan", "graph", "auto"):
                    ga, da = mgr.query(q, f, k=k, read_path=rp)
                    pa = ({c: p.mode for c, p in mgr.last_plan.items()}
                          if rp != "scan" else None)
                    gb, db = rest.query(q, f, k=k, read_path=rp)
                    pb = ({c: p.mode for c, p in rest.last_plan.items()}
                          if rp != "scan" else None)
                    check(pa == pb, f"restored[{name}] {fname}/{rp}: plan "
                          f"{pb} != the original's {pa}")
                    check(bool(np.array_equal(ga, gb))
                          and bool(np.array_equal(da, db)),
                          f"restored[{name}] {fname}/{rp}: answers differ "
                          "from the original's")
            log(f"durability[{name}]: restored == original bit for bit on "
                f"{len(filters)} filters x scan (delta-kept and rebuilt "
                "pack) / graph / auto (rebuilt pack)")
            pack, _, full = _locked_pack(rest)
            largest = max(b.full_nbytes for b in pack.buckets.values())
            budget = min(full // 3, largest - 1)   # the largest stays cold
            tier = SegmentManager.restore(
                snap, cfg=dataclasses.replace(
                    rest.cfg, device_budget_bytes=budget),
                device=dev, resume=False)
            for fname, f in filters.items():
                ga, da = rest.query(q, f, k=k, read_path="scan")
                gb, db = tier.query(q, f, k=k, read_path="scan")
                check(bool(np.array_equal(ga, gb))
                      and bool(np.array_equal(da, db)),
                      f"budget[{name}] {fname}: answers differ from "
                      "all-resident")
                if tier._prefetch_thread is not None:
                    tier._prefetch_thread.join(timeout=120)
                _, _, resident = _locked_pack(tier)
                check(resident <= budget, f"budget[{name}] {fname}: "
                      f"{resident} resident bytes > budget {budget}")
            st = tier.stats()
            misses = st["obs"]["metrics"]["counters"].get("tier_miss_total",
                                                          0)
            check(misses > 0, f"budget[{name}]: no tier miss counted")
            # no injector is installed: no admission may have been absorbed
            check("tier_admission" not in st["health"],
                  f"budget[{name}]: an admission failed "
                  f"{st['health'].get('tier_admission')}")
            log(f"durability[{name}]: budget {budget} of {full} pack bytes:"
                f" scans == all-resident bit for bit; tier {st['tier']}, "
                f"misses {misses}, buckets {st['pack_buckets']}")
            timed.append((name, rest, tier))
        launches = {kn: mod.launch_count() for kn, mod in mods.items()}
        log(f"durability phase launches: {launches}")
        for kn, c in launches.items():
            check(c >= 1, f"kernel {kn} was not launched in phase 5c")
        for name, rest, tier in timed:
            measure_cold(torch, dev, name, rest, tier, q, k)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Resilience (5d) and the serving tier (8)
# ---------------------------------------------------------------------------
def _kernel_mods():
    return {name: importlib.import_module(f"repro_torch.kernels.{mod}")
            for name, mod in (("filtered_topk", "filtered_topk"),
                              ("quant_topk", "quant_topk"),
                              ("graph_step", "graph_topk"))}


def main_chaos(torch, dev, n: int, d: int, seed: int) -> dict:
    """Phase 5d: a persistent manager on the card (``n_shards=2``, fp32
    then int8, a device budget of a third of its pack) driven through the
    lifecycle tape (``streaming.chaos.lifecycle_ops``: varied seals,
    windowed queries with a generous deadline, deletes, compactions, a
    backfill reader) under ``FaultInjector(rate=0.18, max_faults=5)`` over
    the ten crash points.  Every injected crash is recovered (restore from
    disk, re-apply what did not land) and every answer must equal the
    fault-free, unbudgeted oracle's bit for bit; then the final answers,
    live and from a fresh restore, on two filters with the scan and the
    (scan-priced) planner legs, and a grouped query of four groups.  Each
    leg must hit all eleven fault points.  Returns the B1 / B3 / B4
    launches of the phase."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core import IntervalFilter
    from repro_torch.streaming import (FAULT_POINTS, FaultInjector,
                                       GroupQuery, SegmentManager,
                                       StreamConfig)
    from repro_torch.streaming.chaos import (CRASH_POINTS, apply_op,
                                             lifecycle_ops, run_chaos)
    from repro_torch.streaming.planner import PlannerCosts
    mods = _kernel_mods()
    for mod in mods.values():
        mod.reset_launch_count()
    tape = lifecycle_ops(seed + 50, n, d, n_query=CHAOS_QUERIES)
    kinds = {}
    for op in tape:
        kinds[op[0]] = kinds.get(op[0], 0) + 1
    log(f"chaos tape: {len(tape)} ops {kinds} over {n} points x {d}")
    rng = np.random.default_rng(seed + 51)
    q = rng.normal(size=(CHAOS_QUERIES, d)).astype(np.float32)
    t_end = max(float(op[2][:, 2].max()) for op in tape
                if op[0] == "ingest")
    finals = [None, IntervalFilter(dim=2, lo=np.float32(t_end / 3),
                                   hi=np.float32(2 * t_end / 3))]
    scan_priced = PlannerCosts(hop_cost=1e12)
    for quantize in (None, "int8"):
        name = quantize or "fp32"
        base = dict(time_dim=2, seal_max_points=1 << 30, n_shards=2,
                    compact_max_segments=3, quantize=quantize,
                    wal_fsync_every=32)
        t0 = time.perf_counter()
        oracle = SegmentManager(d, 3, StreamConfig(**base), device=dev)
        want = [apply_op(oracle, op) for op in tape]
        torch.cuda.synchronize()
        t_oracle = time.perf_counter() - t0
        budget = oracle._pack.nbytes // 3
        root = tempfile.mkdtemp(prefix="chaos_")
        try:
            cfg = StreamConfig(**base, persist_dir=os.path.join(root, "p"),
                               device_budget_bytes=budget)
            inj = FaultInjector(seed=seed + 52, rate=0.18, max_faults=5,
                                points=CRASH_POINTS)

            def restore():
                mgr = SegmentManager.restore(cfg.persist_dir, cfg=cfg,
                                             device=dev)
                mgr.install_fault_injector(inj)
                return mgr

            mgr = SegmentManager(d, 3, cfg, device=dev)
            mgr.install_fault_injector(inj)
            t0 = time.perf_counter()
            rec = run_chaos(mgr, tape, want, inj, restore,
                            deadline_ms=CHAOS_DEADLINE_MS)
            torch.cuda.synchronize()
            t_chaos = time.perf_counter() - t0
            mgr = rec["mgr"]
            if mgr._prefetch_thread is not None:
                mgr._prefetch_thread.join(60)
            log(f"chaos[{name}]: oracle {t_oracle:.1f} s; faulted run "
                f"{t_chaos:.1f} s, {rec['queries']} answers checked bit for "
                f"bit; budget {budget} of {oracle._pack.nbytes} pack bytes")
            log(f"chaos[{name}]: faults injected {len(inj.fired)} "
                f"{inj.fired}; caught on the write/read path "
                f"{rec['faults']}, restores {rec['restores']}, recovery s "
                f"{[round(x, 3) for x in rec['recovery_s']]}")
            log(f"chaos[{name}]: hits {dict(sorted(inj.hits.items()))}")
            missing = [p for p in FAULT_POINTS if not inj.hits.get(p)]
            check(not missing, f"chaos[{name}]: fault points never hit: "
                  f"{missing}")
            check(len(inj.fired) >= 1, f"chaos[{name}]: no fault injected")
            health = mgr.stats()["health"]
            log(f"chaos[{name}]: health errors " + str(
                {w: h["errors"] for w, h in health.items()}))
            inj.disarm()
            fresh = SegmentManager.restore(cfg.persist_dir, cfg=cfg,
                                           device=dev)
            for label, m in (("live", mgr), ("restored", fresh)):
                for f in finals:
                    for leg in ("scan", "auto"):
                        keep_o, keep_m = oracle.cfg, m.cfg
                        if leg == "auto":
                            oracle.cfg = dataclasses.replace(
                                keep_o, planner_costs=scan_priced)
                            m.cfg = dataclasses.replace(
                                keep_m, planner_costs=scan_priced)
                        try:
                            og, od = oracle.query(q, f, k=10, read_path=leg)
                            gg, dd = m.query(q, f, k=10, read_path=leg)
                        finally:
                            oracle.cfg, m.cfg = keep_o, keep_m
                        check(bool(np.array_equal(og, gg)
                                   and np.array_equal(od, dd)),
                              f"chaos[{name}] {label} {leg} {f}: the final "
                              f"answer differs from the oracle's")
                        check(bool((gg >= 0).any()), f"chaos[{name}]: "
                              f"{label} {leg} answered nothing")
                st = m.stats()["tier"]
                check(st["resident_bytes"] <= budget,
                      f"chaos[{name}] {label}: {st} over the budget")
            groups = [GroupQuery(q[i::4], finals[i % 2], k=10)
                      for i in range(4)]
            for g, r in zip(groups, fresh.query_grouped(groups)):
                og, od = oracle.query(g.queries, g.filt, k=10)
                check(bool(np.array_equal(og, r[0])
                           and np.array_equal(od, r[1])),
                      f"chaos[{name}]: a grouped answer differs")
            log(f"chaos[{name}]: final answers (live and restored, 2 "
                f"filters x scan/auto) and a grouped query equal the "
                f"oracle's bit for bit")
        finally:
            shutil.rmtree(root, ignore_errors=True)
    launches = {kn: mod.launch_count() for kn, mod in mods.items()}
    log(f"chaos phase launches: {launches}")
    for kn in ("filtered_topk", "quant_topk"):
        check(launches[kn] >= 1, f"kernel {kn} was not launched in 5d")
    return launches


class B1Grouped:
    """While active, keeps the inputs of every grouped B1 launch (the
    serving tier's shared bucket reads) and each launched group's real
    row count (the launch zero-pads its groups to the widest), for the
    measurement after it."""

    def __enter__(self):
        self.ops = importlib.import_module("repro_torch.kernels.ops")
        self.shards = importlib.import_module(
            "repro_torch.distributed.segment_shards")
        self.real = self.ops.filtered_topk_grouped_call
        self.real_grouped = self.shards.sharded_filtered_topk_grouped
        self.calls, self.rows = [], []

        def grouped(groups, xs, ss, metric="l2", m=None):
            # the row counts of the classes that launch grouped, in launch
            # order (``ops.sharded_filtered_topk_grouped``'s classing)
            groups = list(groups)
            mm = ss.shape[2] if m is None else int(m)
            classes: dict = {}
            for q, filt, k in groups:
                enc = self.ops.encode_filter(filt, mm, mpad=max(mm, 2))
                if enc is not None:
                    classes.setdefault(
                        (enc[0], self.ops.next_pow2(max(int(k), 8))),
                        []).append(len(q))
            self.rows.extend(r for r in classes.values() if len(r) > 1)
            return self.real_grouped(groups, xs, ss, metric=metric, m=m)

        def recorder(q, x, s, params, kind, kpad, metric="l2"):
            rows = self.rows.pop(0)
            check(len(rows) == q.shape[0] and max(rows) == q.shape[1],
                  f"B1 grouped spy: rows {rows} for a launch of "
                  f"{tuple(q.shape)}")
            self.calls.append((q.clone(), x, s, params.clone(), kind, kpad,
                               metric, rows))
            return self.real(q, x, s, params, kind, kpad, metric=metric)
        self.ops.filtered_topk_grouped_call = recorder
        self.shards.sharded_filtered_topk_grouped = grouped
        return self

    def __exit__(self, *exc):
        self.ops.filtered_topk_grouped_call = self.real
        self.shards.sharded_filtered_topk_grouped = self.real_grouped
        return False


def main_serving(torch, dev, seed: int, keep: dict) -> dict:
    """Phase 8: the multi-tenant serving tier on the card.
    ``GeoTemporalWorkload`` (``SERVE`` below: 4 tenants at d_emb = D,
    25,000 points each, seals of 4,096, 2 shards, bursts and deletes
    between flushes, half the requests with a 250 ms deadline) must keep
    isolation at every step and recall@10 of 1.0 on every non-degraded
    answer.  Then one recorded flush (64 requests per tenant, no
    deadline) is answered grouped (one B1 launch per filter class and
    bucket) and again solo, request by request, bit for bit; a second
    identical flush is traced for the device idle share; and a store on
    the graph read path (tenant 0's documents) answers a heterogeneous
    ``retrieve_grouped`` batch group by group (B4), equal to solo
    retrieves.  Returns the B1 / B3 / B4 launches."""
    import numpy as np
    import dataclasses
    from repro_torch.core import BoxFilter
    from repro_torch.serving.batching import (RetrievalFailure,
                                              RetrievalRequest, _filter_key)
    from repro_torch.serving.rag import DocumentStore
    from repro_torch.serving.service import ServeRequest
    from repro_torch.serving.workload import (SLO_REPORT_KEYS,
                                              GeoTemporalWorkload,
                                              WorkloadConfig)
    mods = _kernel_mods()
    b1 = mods["filtered_topk"]
    for mod in mods.values():
        mod.reset_launch_count()
    cfg = WorkloadConfig(seed=seed, device=str(dev), **SERVE)
    t0 = time.perf_counter()
    wl = GeoTemporalWorkload(cfg)
    report = wl.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    check(set(report) - {"latency_samples"} == set(SLO_REPORT_KEYS),
          f"serving report keys {sorted(report)}")
    us = [row["us_per_query"] for row in report["latency_samples"]]
    rps = 1e6 / float(np.mean(us)) if us else 0.0
    g_run = b1.grouped_launch_stats()
    log(f"serving: {cfg.n_tenants} tenants x {cfg.n_initial} points x "
        f"{cfg.d_emb}, {cfg.warmup_steps} + {cfg.n_steps} steps of "
        f"{cfg.queries_per_step} requests per tenant in {t_run:.1f} s; "
        f"report { {k: v for k, v in report.items() if k != 'latency_samples'} }")
    log(f"serving: {rps:.1f} requests/s (flush host clock over the "
        f"measured steps), p50 {report['latency_ms_p50']} ms, p99 "
        f"{report['latency_ms_p99']} ms, degraded share "
        f"{report['degraded_fraction']}; B1 grouped launches "
        f"{g_run['launches']} ({g_run['groups'] / max(g_run['launches'], 1):.2f}"
        f" groups and {g_run['shard_rows'] / max(g_run['launches'], 1):.2f} "
        f"shard rows per launch), all B1 launches {b1.launch_count()}")
    check(report["isolation_ok"] and report["isolation_checks"]
          == cfg.n_tenants * (cfg.warmup_steps + cfg.n_steps),
          f"serving: isolation {report['isolation_ok']} over "
          f"{report['isolation_checks']} checks")
    check(report["recall_at_10"] == 1.0, f"serving: recall@10 "
          f"{report['recall_at_10']} on the non-degraded answers")
    n_rejected = round(report["rejected_fraction"] * report["n_requests"])
    check(report["n_answered"] == report["n_requests"] - n_rejected > 0,
          f"serving: {report['n_answered']} of {report['n_requests']} "
          f"requests answered, {n_rejected} rejected")
    check(g_run["launches"] >= 1, "serving: B1 never launched grouped")

    def no_fallback(what):
        # a flush that fell back to solo queries, a failed request or an
        # absorbed admission fails the phase (no injector is installed)
        counters = wl.store.metrics.snapshot()["counters"]
        health = wl.store.manager.stats()["health"]
        for name in ("retrieval_grouped_fallback_total",
                     "retrieval_failed_total"):
            check(not counters.get(name), f"serving: {what}: {name} = "
                  f"{counters.get(name)}")
        check("tier_admission" not in health, f"serving: {what}: an "
              f"admission failed {health.get('tier_admission')}")
    no_fallback("the workload run")

    def requests(rid0):
        reqs = []
        for t in wl.tenants:
            for i in range(cfg.queries_per_step):
                filt, _, _ = wl._query_filter()
                reqs.append(ServeRequest(
                    req_id=rid0 + len(reqs), tenant=t,
                    query_emb=wl.rng.standard_normal(cfg.d_emb)
                    .astype(np.float32), filt=filt, k=cfg.k))
        return reqs
    reqs = requests(10_000_000)
    for r in reqs:
        check(wl.service.submit(r) is None, "serving: a request rejected")
    g0 = b1.grouped_launch_stats()
    with B1Grouped() as spy:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = wl.service.flush()
        torch.cuda.synchronize()
        t_grouped = time.perf_counter() - t0
    g1 = b1.grouped_launch_stats()
    no_fallback("the recorded flush")
    check(g1["launches"] - g0["launches"] >= 1,
          "serving: the recorded flush launched no grouped B1")
    t0 = time.perf_counter()
    solo = [wl.store.retrieve(r.tenant, r.query_emb, r.filt, k=r.k)
            for r in reqs]
    torch.cuda.synchronize()
    t_solo = time.perf_counter() - t0
    for r, s in zip(reqs, solo):
        a = answers[r.req_id]
        check(not isinstance(a, RetrievalFailure) and not a.degraded,
              f"serving: recorded request {r.req_id} failed or degraded")
        check(bool(np.array_equal(a.gids, s.gids[0])
                   and np.array_equal(a.dists, s.dists[0])),
              f"serving: request {r.req_id} grouped != solo")
    n_groups = len({(r.tenant, _filter_key(r.filt, r.k)) for r in reqs})
    log(f"serving: recorded flush of {len(reqs)} requests: grouped "
        f"{t_grouped * 1e3:.1f} ms ({g1['launches'] - g0['launches']} "
        f"grouped B1 launches, {g1['groups'] - g0['groups']} groups), solo "
        f"{t_solo * 1e3:.1f} ms ({len(reqs)} retrieves); grouped == solo "
        f"bit for bit")
    reqs2 = requests(20_000_000)
    for r in reqs2:
        wl.service.submit(r)
    t0 = time.perf_counter()
    prof = profile_tick(torch, wl.service.flush)
    wall = (time.perf_counter() - t0) * 1e3
    idle = 1.0 - prof["device_ms"] / wall
    log(f"serving: a traced flush: {wall:.1f} ms host clock (profiler on), "
        f"{prof['device_ms']:.3f} ms device time in {prof['kernels']} "
        f"kernels, idle share {idle:.3f}; top {prof['top']}")
    # the per-group fallback: a store on the graph read path (tenant 0's
    # documents) answers a heterogeneous batch group by group (B4)
    coll = wl.store.collection(wl.tenants[0])
    docs = [coll.docs_by_gid[g] for g in sorted(coll.docs_by_gid)]
    t0 = time.perf_counter()
    gstore = DocumentStore(docs, streaming=True,
                           stream_cfg=dataclasses.replace(wl._scfg),
                           read_path="graph", device=dev)
    gstore.maintenance()
    t_build = time.perf_counter() - t0
    w = cfg.region_half_width
    greqs = [RetrievalRequest(
        req_id=i, query_emb=wl.rng.standard_normal(cfg.d_emb)
        .astype(np.float32), k=cfg.k,
        filt=BoxFilter(lo=np.float32([cx - w, cy - w, -np.inf]),
                       hi=np.float32([cx + w, cy + w, np.inf])))
        for i, (cx, cy) in enumerate([(2.0, 2.0), (7.0, 6.0), (4.5, 8.0)]
                                     * 8)]
    before = mods["graph_step"].launch_count()
    grouped = gstore.retrieve_grouped(greqs)
    modes = {dec.mode for dec in (gstore.manager.last_plan or {}).values()}
    check("graph" in modes, f"serving: the graph-path store planned {modes}")
    check(mods["graph_step"].launch_count() > before,
          "serving: the graph-path store launched no B4")
    found = 0
    for r in greqs:
        solo = gstore.retrieve(r.query_emb, r.filt, k=r.k)[0]
        check([d.doc_id for d in grouped[r.req_id]]
              == [d.doc_id for d in solo],
              f"serving: graph-path request {r.req_id} grouped != solo")
        found += len(solo)
    check(found > 0, "serving: the graph-path store answered nothing")
    log(f"serving: graph-path store of {len(docs)} documents built in "
        f"{t_build:.1f} s; {len(greqs)} requests in 3 filter groups "
        f"answered group by group (B4) == solo retrieves")
    launches = {kn: mod.launch_count() for kn, mod in mods.items()}
    log(f"serving phase launches: {launches}")
    for kn in ("filtered_topk", "graph_step"):
        check(launches[kn] >= 1, f"kernel {kn} was not launched in 8")
    keep["serving"] = dict(
        rps=rps, p50=report["latency_ms_p50"], p99=report["latency_ms_p99"],
        degraded=report["degraded_fraction"], grouped_ms=t_grouped * 1e3,
        solo_ms=t_solo * 1e3, idle=idle, groups=n_groups,
        grouped_launches=g_run["launches"] + g1["launches"] - g0["launches"],
        calls=spy.calls)
    return launches


def measure_grouped(torch, keep: dict, errs: dict) -> dict:
    """B1's grouped launch on the recorded flush's largest launch: held
    against its twin, then timed beside its twin, the same groups as G
    solo launches (each at its real rows, as a solo query makes them),
    one dense library computation over the real rows and its bound (the
    real rows' work: the launch also computes the zero rows that pad
    each group to the widest)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.filtered_topk import (
        filtered_topk_call, filtered_topk_grouped_call,
        filtered_topk_grouped_plain)
    calls = keep["serving"]["calls"]
    q, xs, ss, params, kind, kpad, metric, rows = max(
        calls, key=lambda c: sum(c[7]) * c[1].shape[1])
    G, bq, d = q.shape
    S, n, m = ss.shape
    k = 10
    args = (q, xs, ss, params, kind, kpad, metric)
    kd, ki = filtered_topk_grouped_call(*args)
    torch.cuda.synchronize()
    td, ti = filtered_topk_grouped_plain(*args)
    err = max(compare_topk(torch, kd[g], ki[g], td[g], ti[g],
                           row_scale(torch, q[g], xs.reshape(-1, d)),
                           f"B1 grouped vs twin, group {g}")
              for g in range(G))
    errs["filtered_topk"] = max(errs["filtered_topk"], err)
    ms = cuda_ms(torch, lambda: filtered_topk_grouped_call(*args), iters=20)
    plain = cuda_ms(torch, lambda: filtered_topk_grouped_plain(*args),
                    iters=2, warmup=1)
    real_q = [q[g, :b].contiguous() for g, b in enumerate(rows)]

    def solo():
        for g in range(G):
            filtered_topk_call(real_q[g][None], xs, ss, params[g][None],
                               kind, kpad, metric)
    solo_ms = cuda_ms(torch, solo, iters=10)
    qf, xf = torch.cat(real_q), xs.reshape(S * n, d)
    oks = [ref.filter_mask_ref(ss, kind, params[g]).reshape(S * n)
           for g in range(G)]
    ok_rows = torch.cat([ok[None].expand(b, -1) for ok, b in zip(oks, rows)])

    def library():
        dm = (qf * qf).sum(1)[:, None] - 2.0 * torch.matmul(qf, xf.T) \
            + (xf * xf).sum(1)[None, :]
        dm = dm.masked_fill(~ok_rows, float("inf"))
        return torch.topk(dm, k, dim=1, largest=False)
    lib_ms = cuda_ms(torch, library, iters=5, warmup=1)
    # what these inputs need: each group's real rows against its passing
    # candidates; every metadata row, the vectors that pass some group
    # (each read once), the real query rows, parameters and their lists
    passing = [int(ok.sum()) for ok in oks]
    union = int(torch.stack(oks).any(0).sum())
    n_rows = sum(rows)
    flops = 2.0 * d * sum(b * p for b, p in zip(rows, passing))
    nbytes = 4.0 * (S * n * m + union * d + n_rows * d
                    + G * 4 * params.shape[2]) + 8.0 * S * n_rows * kpad
    bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    out = dict(ms=ms, plain_ms=plain, solo_ms=solo_ms, library_ms=lib_ms,
               bound_ms=bound, bound_by="operations"
               if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes",
               pass_share=sum(passing) / (G * S * n), max_abs_err=err,
               shape=f"G={G} groups of {n_rows} real rows (padded to "
                     f"q[{bq},{d}] each) over x[{S},{n},{d}] "
                     f"s[{S},{n},{m}] {kind} kpad={kpad}")
    log(f"B1 grouped at {out['shape']}: kernel {ms:.3f} ms, {G} solo "
        f"launches {solo_ms:.3f} ms, twin {plain:.3f} ms, library "
        f"{lib_ms:.3f} ms, bound {bound:.4f} ms ({out['bound_by']}; "
        f"{out['pass_share']:.4f} of the group x candidate pairs pass; "
        f"rows per group {rows}), max |err| {err:.3g}")
    return out


def measure_cold(torch, dev, name, rest, tier, q, k: int) -> None:
    """The largest cold bucket of ``tier``: its dispatch (copy from pinned
    memory + the scan kernel) against the same bucket resident in ``rest``
    (host clock around calls that end in a copy to the host), the
    host-to-device copy alone (CUDA events), and one admission uploaded on
    the side stream (host clock until its event completes)."""
    import dataclasses
    import numpy as np
    from repro_torch.distributed.segment_shards import (pack_search_blocks,
                                                        stage_bucket)
    tpack, tview, _ = _locked_pack(tier)
    _, rview, _ = _locked_pack(rest)
    cold = [bv for bv in tview.buckets if not bv.resident]
    check(bool(cold), f"budget[{name}]: no cold bucket to time")
    bc = max(cold, key=lambda bv: bv.stage_bytes)
    br = next(bv for bv in rview.buckets if bv.cap == bc.cap)
    vc = dataclasses.replace(tview, buckets=(bc,))
    vr = dataclasses.replace(rview, buckets=(br,))

    def host_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters
    gc_, dc_ = pack_search_blocks(vc, q, None, k)[0]
    gr_, dr_ = pack_search_blocks(vr, q, None, k)[0]
    check(bool(np.array_equal(gc_, gr_)) and bool(np.array_equal(dc_, dr_)),
          f"cold[{name}]: the cold dispatch differs from the resident one")
    ms_cold = host_ms(lambda: pack_search_blocks(vc, q, None, k))
    ms_res = host_ms(lambda: pack_search_blocks(vr, q, None, k))
    ms_copy = cuda_ms(torch, lambda: stage_bucket(bc, dev), iters=5)
    with tier._lock:
        staged = tpack.stage_admission(bc.cap)
    t0 = time.perf_counter()
    _, up = tpack.upload_admission(staged)
    up.event.synchronize()
    ms_admit = (time.perf_counter() - t0) * 1e3
    del up
    gauges = tier.stats()["obs"]["metrics"]["gauges"]
    log(f"cold[{name}] bucket cap {bc.cap} ({bc.stage_bytes} bytes): "
        f"cold dispatch {ms_cold:.3f} ms vs resident {ms_res:.3f} ms (host "
        f"clock, {q.shape[0]} queries, no filter); host-to-device copy "
        f"{ms_copy:.3f} ms = {bc.stage_bytes / ms_copy / 1e6:.2f} GB/s from "
        f"pinned memory; one side-stream admission {ms_admit:.3f} ms; "
        f"torch.cuda.memory_allocated {torch.cuda.memory_allocated()} bytes "
        f"vs tier_resident_bytes {gauges.get('tier_resident_bytes')}")


def compare_decode(torch, q, k, v, lengths, what: str) -> float:
    """B5 kernel vs twin on one input.  Both compute in fp32 and round the
    output once to q's dtype, so they differ by the summation order
    (fp32: within 2e-4, the reference's own kernel-test bound) and, in
    bf16, by at most one rounding of the output (1e-2 absolute and
    relative: two bf16 ulps at |o| ~ 1).  Returns the largest absolute
    difference."""
    from repro_torch.kernels.flash_decode import (flash_decode_call,
                                                  flash_decode_plain)
    got = flash_decode_call(q, k, v, lengths)
    torch.cuda.synchronize()
    want = flash_decode_plain(q, k, v, lengths)
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"{what}: output {got.dtype} {tuple(got.shape)}")
    tol = 2e-4 if q.dtype == torch.float32 else 1e-2
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    check(bool(torch.isfinite(got.float()).all()), f"{what}: not finite")
    check(bool((diff <= tol + tol * want.float().abs()).all()),
          f"{what}: error {err:.3g} above tolerance")
    return err


def phase_kernels_decode(torch, dev, seed: int, errs: dict) -> None:
    """B5 against its twin in fp32 and bf16: the reference's own test
    shapes, GQA groups 1 / 2 / 12 at hd = 64, ragged smax, lengths 0 and
    smax - 1, and a shape with one split per row."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 60)
    shapes = [(4, 8, 512, 128), (2, 16, 1024, 128), (8, 8, 256, 256),
              (5, 1, 300, 64), (6, 2, 777, 64), (3, 12, 1000, 64),
              (7, 2, 4099, 128), (600, 2, 50, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        for bkv, g, smax, hd in shapes:
            q, k, v = (torch.randn(shape, generator=gen, device=dev
                                   ).to(dtype)
                       for shape in ((bkv, g, hd), (bkv, smax, hd),
                                     (bkv, smax, hd)))
            lengths = torch.randint(0, smax, (bkv,), generator=gen,
                                    device=dev, dtype=torch.int32)
            lengths[0] = 0
            lengths[1] = smax - 1
            e = compare_decode(torch, q, k, v, lengths,
                               f"B5 {dtype} [{bkv}, {g}, {smax}, {hd}]")
            errs["flash_decode"] = max(errs["flash_decode"], e)
    log(f"B5 vs twin: fp32 and bf16 x {len(shapes)} shapes (g 1..16, hd "
        f"64 / 128 / 256, ragged smax, lengths 0 and smax - 1) agree; max "
        f"|err| {errs['flash_decode']:.3g}")


def profile_tick(torch, step) -> dict:
    """One call of ``step`` under ``torch.profiler``: the device time of
    the kernels it ran (their summed durations), their count and the five
    largest by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(device_ms=sum(by_name.values()), kernels=n,
                top=[(name[:60], round(ms, 4)) for name, ms in top])


def main_generate(torch, dev, seed: int, errs: dict, keep: dict) -> dict:
    """The generation side at the full width of ARCH in bf16: a
    ContinuousBatcher run, decode held to a full forward, and RAG answers
    over a static DocumentStore.  Resets every kernel's launch count
    before and returns the launches of each in this phase."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import CubeGraphConfig
    from repro_torch.core.workloads import (make_box_filter,
                                            make_dataset_device)
    from repro_torch.models import build_model, count_params, init_params
    from repro_torch.serving import (ContinuousBatcher, Document,
                                     DocumentStore, RAGPipeline, Request)
    mods = {name: importlib.import_module(f"repro_torch.kernels.{mod}")
            for name, mod in (("filtered_topk", "filtered_topk"),
                              ("pairwise_dist", "distance"),
                              ("quant_topk", "quant_topk"),
                              ("graph_step", "graph_topk"),
                              ("flash_decode", "flash_decode"))}
    fdm = mods["flash_decode"]
    cfg = get_config(ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model.param_specs(), seed=seed, device=dev)
    torch.cuda.synchronize()
    n_par = count_params(model.param_specs())
    log(f"{ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads} / kv {cfg.n_kv} (g = {cfg.n_heads // cfg.n_kv}), hd "
        f"{cfg.hd}, vocab {cfg.vocab}; {n_par} parameters "
        f"({n_par * 2 / 1e9:.2f} GB bf16) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed + 70)
    lens = rng.integers(PROMPT_LO, PROMPT_HI + 1, N_REQUESTS)
    prompts = [rng.integers(2, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]
    for mod in mods.values():
        mod.reset_launch_count()

    # -- 7a: the batcher ----------------------------------------------------
    batcher = ContinuousBatcher(model, params, n_slots=SLOTS,
                                max_len=MAX_LEN, eos_id=-1)
    kv_bytes = sum(c.numel() * c.element_size()
                   for c in batcher.cache.values())
    log(f"KV cache [{cfg.n_layers}, {SLOTS}, {cfg.n_kv}, {MAX_LEN}, "
        f"{cfg.hd}] x 2: {kv_bytes / 1e9:.2f} GB")
    for i, p in enumerate(prompts):
        batcher.submit(Request(req_id=i, prompt=p, max_new=MAX_NEW))
    prefill_ms, tick_ms, recorded, busy, t_prof = [], [], {}, {}, 0.0
    real_prefill, real_fd = batcher.prefill_fn, fdm.flash_decode_call
    calls = [0]

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_prefill(*a, **kw)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def recorder(q, k, v, lengths):
        if calls[0] == RECORD_TICK * cfg.n_layers + RECORD_LAYER:
            recorded.update(q=q.clone(), k=k.clone(), v=v.clone(),
                            lengths=lengths.clone())
        calls[0] += 1
        return real_fd(q, k, v, lengths)
    batcher.prefill_fn = timed_prefill
    fdm.flash_decode_call = recorder
    t_run = time.perf_counter()
    try:
        while batcher.queue or batcher.active:
            batcher.admit()
            torch.cuda.synchronize()
            if batcher.steps == PROFILE_TICK:
                t = time.perf_counter()
                busy = profile_tick(torch, batcher.step)
                t_prof = time.perf_counter() - t
                continue
            t = time.perf_counter()
            batcher.step()          # ends in a host copy of the tokens
            tick_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        fdm.flash_decode_call = real_fd
    # the traced tick counts as a median tick (the profiler's own start-up
    # is not the batcher's time)
    t_run = (time.perf_counter() - t_run - t_prof
             + float(np.median(tick_ms)) / 1e3)
    b5_batcher = fdm.launch_count()
    done = batcher.finished
    check(len(done) == N_REQUESTS, f"batcher finished {len(done)} of "
          f"{N_REQUESTS} requests")
    for r in done:
        out = np.asarray(r.output)
        check(len(out) == MAX_NEW and bool(((out >= 0)
                                            & (out < cfg.vocab)).all()),
              f"request {r.req_id}: {len(out)} tokens, range "
              f"[{out.min()}, {out.max()}]")
    check(b5_batcher == cfg.n_layers * batcher.steps,
          f"B5 launched {b5_batcher} times in {batcher.steps} decode ticks "
          f"of {cfg.n_layers} layers")
    check(bool(recorded), "no B5 call was recorded")
    n_tok = N_REQUESTS * MAX_NEW
    dec_tok = N_REQUESTS * (MAX_NEW - 1)
    tick = np.asarray(tick_ms)
    log(f"batcher: {N_REQUESTS} requests (prompts {int(lens.min())}.."
        f"{int(lens.max())} tokens, mean {lens.mean():.0f}) through "
        f"{SLOTS} slots, {batcher.steps} decode ticks, {t_run:.2f} s, "
        f"{n_tok / t_run:.1f} tokens/s end to end; B5 launches "
        f"{b5_batcher} = {cfg.n_layers} x {batcher.steps} ticks")
    log(f"prefill ms per request: {[round(x, 2) for x in prefill_ms]} "
        f"(mean {np.mean(prefill_ms):.2f}, "
        f"{lens.sum() / (sum(prefill_ms) / 1e3):.0f} prompt tokens/s)")
    log(f"decode ms per tick: mean {tick.mean():.3f}, p50 "
        f"{np.median(tick):.3f}, min {tick.min():.3f}, max "
        f"{tick.max():.3f} over the {len(tick)} ticks not traced; "
        f"{dec_tok / batcher.steps / (tick.mean() / 1e3):.1f} decode "
        f"tokens/s at the mean tick")
    check(bool(busy), f"the batcher ran no tick {PROFILE_TICK}")
    if busy["device_ms"] > 0:
        idle = 1.0 - busy["device_ms"] / float(np.median(tick))
        log(f"tick {PROFILE_TICK} under torch.profiler: device busy "
            f"{busy['device_ms']:.3f} ms in {busy['kernels']} kernels, "
            f"{idle:.3f} of the median tick idle; top kernels (ms): "
            f"{busy['top']}")
    else:
        idle = None
        log(f"tick {PROFILE_TICK} under torch.profiler: no device time "
            f"recorded; device idle share not measured")
    keep["decode"] = recorded
    keep["generation"] = dict(
        prefill_ms_mean=float(np.mean(prefill_ms)),
        decode_tick_ms_mean=float(tick.mean()),
        decode_tick_ms_p50=float(np.median(tick)), device_idle_share=idle,
        tokens_per_s=n_tok / t_run, ticks=batcher.steps)
    del batcher

    # -- 7b: decode == forward ----------------------------------------------
    worst, worst_gap_tok, checked = 0.0, 0, 0
    cache = model.init_cache(N_FORWARD, MAX_LEN, device=dev)
    steps = [[] for _ in range(N_FORWARD)]
    cur = torch.zeros((N_FORWARD, 1), dtype=torch.int32, device=dev)
    for i in range(N_FORWARD):
        view = {name: c[:, i:i + 1] for name, c in cache.items()}
        lg, _ = model.prefill(params, torch.as_tensor(
            prompts[i][None], device=dev), view)
        steps[i].append(lg[0, -1].float())
        cur[i, 0] = torch.argmax(lg[0, -1].float())
    pos = torch.tensor(lens[:N_FORWARD], dtype=torch.long, device=dev)
    gen_toks = [cur.clone()]
    for _ in range(MAX_NEW - 1):
        lg, cache = model.decode_step(params, cur, cache, pos)
        for i in range(N_FORWARD):
            steps[i].append(lg[i, 0].float())
        cur = torch.argmax(lg[:, 0].float(), dim=-1)[:, None].to(torch.int32)
        gen_toks.append(cur.clone())
        pos += 1
    gen_toks = torch.cat(gen_toks, dim=1)              # [N_FORWARD, MAX_NEW]
    del cache
    for i in range(N_FORWARD):
        full = torch.cat([torch.as_tensor(prompts[i], device=dev).long(),
                          gen_toks[i, :-1].long()])[None]
        fwd, _ = model.logits(params, full)
        n = int(lens[i])
        fwd = fwd[0, n - 1:n - 1 + MAX_NEW].float()    # [MAX_NEW, vocab]
        dec = torch.stack(steps[i])
        rms = fwd.pow(2).mean(-1, keepdim=True).sqrt()
        rel = ((dec - fwd).abs() / rms).max(-1).values
        worst = max(worst, float(rel.max()))
        check(bool((rel <= LOGIT_TOL).all()),
              f"request {i}: decode logits differ from the forward's by "
              f"{float(rel.max()):.4f} x rms > {LOGIT_TOL}")
        top2 = torch.topk(fwd, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) / rms[:, 0]
        sure = gap > LOGIT_TOL
        agree = gen_toks[i].long() == fwd.argmax(-1)
        check(bool(agree[sure].all()),
              f"request {i}: a greedy token differs from the forward's "
              f"argmax where the top-2 gap exceeds the tolerance")
        checked += int(sure.sum())
        worst_gap_tok += int((~agree).sum())
    log(f"decode vs forward ({N_FORWARD} requests x {MAX_NEW} steps, "
        f"ragged positions): max |diff| / rms(row) {worst:.4f} (tolerance "
        f"{LOGIT_TOL}); greedy tokens equal the forward's argmax at all "
        f"{checked} steps whose top-2 gap exceeds it ({worst_gap_tok} "
        f"near-tie steps differ)")
    keep["generation"]["decode_vs_forward_rel"] = worst

    # -- 7c: RAG ----------------------------------------------------------------
    m = 3
    xt, st = make_dataset_device(N_RAG, D, m, seed=seed + 72, device=dev)
    x_np, s_np = xt.cpu().numpy(), st.cpu().numpy().astype(np.float64)
    del xt, st
    toks = rng.integers(2, cfg.vocab, size=(N_RAG, RAG_SPAN)).astype(
        np.int32)
    docs = [Document(i, toks[i], x_np[i], s_np[i]) for i in range(N_RAG)]
    t0 = time.perf_counter()
    store = DocumentStore(docs, CubeGraphConfig(), device=dev)
    torch.cuda.synchronize()
    log(f"RAG store: {N_RAG} documents, d_emb {D}, spans of {RAG_SPAN} "
        f"tokens; index built in {time.perf_counter() - t0:.1f} s")
    pipe = RAGPipeline(store, model, params, max_context=RAG_CONTEXT)
    f = make_box_filter(m, 0.1, seed=seed + 73)
    rag_ms, n_docs, prompt_lens = [], [], []
    b5_before = fdm.launch_count()
    for qi in range(RAG_QUERIES):
        query = rng.integers(2, cfg.vocab, size=RAG_QUERY_TOKENS).astype(
            np.int32)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, got = pipe.answer(query, f, k=RAG_K, max_new=RAG_MAX_NEW)
        rag_ms.append((time.perf_counter() - t) * 1e3)
        check(1 <= len(got) <= RAG_K, f"RAG query {qi}: {len(got)} docs")
        meta = torch.as_tensor(np.stack([d.metadata for d in got]))
        check(bool(f.contains(meta).all()),
              f"RAG query {qi}: a retrieved document fails the filter")
        check(len(out) == RAG_MAX_NEW and bool(((out >= 0)
                                                & (out < cfg.vocab)).all()),
              f"RAG query {qi}: output {out}")
        n_docs.append(len(got))
        prompt_lens.append(len(pipe.assemble(got, query)))
    b5_rag = fdm.launch_count() - b5_before
    check(b5_rag == cfg.n_layers * RAG_QUERIES * (RAG_MAX_NEW - 1),
          f"RAG: B5 launched {b5_rag} times")
    log(f"RAG: {RAG_QUERIES} answers (box filter ratio 0.1, k {RAG_K}, "
        f"max_new {RAG_MAX_NEW}, max_context {RAG_CONTEXT}): docs "
        f"{n_docs}, prompts {prompt_lens} tokens, ms per answer "
        f"{[round(x, 1) for x in rag_ms]}; every document passes the "
        f"filter")
    launches = {name: mod.launch_count() for name, mod in mods.items()}
    log(f"generation phase launches: {launches}")
    expect = cfg.n_layers * (keep["generation"]["ticks"] + (MAX_NEW - 1)
                             + RAG_QUERIES * (RAG_MAX_NEW - 1))
    check(launches["flash_decode"] == expect,
          f"B5 launched {launches['flash_decode']} times, {expect} decode "
          "layer-steps in the phase")
    return launches


def measure_decode(torch, keep: dict, errs: dict) -> dict:
    """B5 on the inputs one layer of a recorded batcher tick handed it:
    held against its twin, then timed beside the twin, its bound (the
    filled prefix's K / V bytes plus q and o over HBM bandwidth) and
    ``scaled_dot_product_attention`` with a boolean length mask."""
    from repro_torch.kernels.flash_decode import (flash_decode_call,
                                                  flash_decode_plain)
    rec = keep["decode"]
    q, k, v, lengths = rec["q"], rec["k"], rec["v"], rec["lengths"]
    bkv, g, hd = q.shape
    smax = k.shape[1]
    e = compare_decode(torch, q, k, v, lengths, "B5 on the recorded tick")
    errs["flash_decode"] = max(errs["flash_decode"], e)
    filled = int((lengths.long() + 1).sum())
    log(f"B5 vs twin on layer {RECORD_LAYER} of tick {RECORD_TICK}: "
        f"[{bkv}, {g}, {smax}, {hd}] {q.dtype}, lengths per slot "
        f"{lengths.view(SLOTS, -1)[:, 0].tolist()}, {filled} filled "
        f"positions of {bkv * smax}: agree, max |err| {e:.3g}")
    # CUDA events around back-to-back calls, the timer of every kernel
    # here; and device time alone (the kernel is about as short as its
    # wrapper's host time, which events around back-to-back calls include)
    kern = lambda: flash_decode_call(q, k, v, lengths)  # noqa: E731
    ms = cuda_ms(torch, kern, iters=50, warmup=5)
    ms_device = device_ms(torch, kern, iters=50, warmup=5)
    plain = cuda_ms(torch, lambda: flash_decode_plain(q, k, v, lengths),
                    iters=10)
    import torch.nn.functional as F
    b = SLOTS
    n_kv = bkv // b
    ql = q.view(b, n_kv * g, 1, hd)
    kl, vl = k.view(b, n_kv, smax, hd), v.view(b, n_kv, smax, hd)
    mask = (torch.arange(smax, device=q.device)[None, :]
            <= lengths.view(b, n_kv)[:, :1].long())[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                              enable_gqa=True)
    lib_out = library()
    lib_err = float((lib_out.reshape(bkv, g, hd).float()
                     - flash_decode_plain(q, k, v, lengths).float()
                     ).abs().max())
    lib = cuda_ms(torch, library, iters=50, warmup=5)
    lib_device = device_ms(torch, library, iters=50, warmup=5)
    es = q.element_size()
    nbytes = 2.0 * filled * hd * es + 2.0 * q.numel() * es + 4.0 * bkv
    flops = 4.0 * filled * g * hd
    bound = max(nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS) * 1e3
    log(f"B5 library yardstick: scaled_dot_product_attention (GQA, bool "
        f"mask) differs from the twin by {lib_err:.3g}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by="bytes" if nbytes / PEAK_BYTES
                >= flops / PEAK_FP32_FLOPS else "operations",
                filled=filled, device_ms=ms_device,
                library_device_ms=lib_device,
                shape=f"layer {RECORD_LAYER} of batcher tick {RECORD_TICK}:"
                      f" q[{bkv},{g},{hd}] k/v[{bkv},{smax},{hd}] "
                      f"{str(q.dtype).replace('torch.', '')}, {filled} "
                      f"filled positions")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels, hold them against their twins "
                         "and stop (no main path, no result lines)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build
        # the package re-exports functions under the module names
        b1 = importlib.import_module("repro_torch.kernels.filtered_topk")
        b2 = importlib.import_module("repro_torch.kernels.distance")
        importlib.import_module("repro_torch.kernels.quant_topk")
        importlib.import_module("repro_torch.kernels.graph_topk")
        importlib.import_module("repro_torch.kernels.flash_decode")
    except ImportError as exc:
        print(f"chip_smoke: the port's sources are not here ({exc})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "fp32 matmuls are not in full fp32")

    with Phase("0 card", torch):
        smi = smi_line()
        log(f"nvidia-smi: {smi}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
            f"{torch.cuda.get_device_name(0)}, python "
            f"{sys.version.split()[0]}; fp32 matmul precision highest, "
            f"tf32 off")
    with Phase("1 build", torch):
        logs = _build.build()
        for name in _build.KERNEL_SOURCES:
            lines = [ln.strip() for ln in logs.get(name, "").splitlines()
                     if "ptxas" in ln or "spill" in ln]
            log(f"[{name}] " + ("\n[{name}] ".format(name=name).join(lines)
                                if lines else "already built"))
            if name in ("filtered_topk", "distance", "quant_topk",
                        "graph_step", "flash_decode"):
                # the redesigned kernels must keep every register in the
                # register file
                spills = [int(v) for ln in lines for v in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", ln)]
                check(not any(spills), f"{name}: ptxas reports spills")
    errs = {"filtered_topk": 0.0, "pairwise_dist": 0.0, "quant_topk": 0.0,
            "graph_step": 0.0, "flash_decode": 0.0}
    with Phase("2 kernels vs twins", torch):
        phase_kernels(torch, dev, SEED, errs)
        phase_kernels_grouped(torch, dev, SEED, errs)
        phase_kernels_decode(torch, dev, SEED, errs)
    if args.kernels_only:
        return 0

    # ---- the main path: counts are read only around these phases -------
    b1.reset_launch_count()
    b2.reset_launch_count()
    keep: dict = {}
    with Phase("3 exact filtered scan", torch):
        main_scan(torch, dev, N_SCAN, D, QUERIES, SEED, errs, keep)
    with Phase("4 index", torch):
        main_index(torch, dev, N_INDEX, D, QUERIES, SEED, keep)
    with Phase("5 streaming", torch):
        keep["b1_live_share_stream"] = main_stream(torch, dev, N_STREAM, D,
                                                   QUERIES, SEED)
    launches = {"filtered_topk": b1.launch_count(),
                "pairwise_dist": b2.launch_count()}
    log(f"main-path launches (phases 3-5): {launches}")
    for name, c in launches.items():
        check(c >= 1, f"kernel {name} was not launched on the main path")
    with Phase("4b baselines", torch):
        # the phase resets every count just before it and reads it after
        for name, c in main_baselines(torch, dev, QUERIES, SEED,
                                      keep).items():
            launches[name] += c
    with Phase("5b sharded streaming", torch):
        # the phase resets every count just before it and reads it after
        sharded = main_sharded(torch, dev, N_SHARDED, D, QUERIES, SEED, keep)
    launches["filtered_topk"] += sharded["filtered_topk"]
    launches["quant_topk"] = sharded["quant_topk"]
    launches["graph_step"] = sharded["graph_step"]

    with Phase("6 measure", torch):
        meas = measure(torch, keep, QUERIES, D)
        meas.update(measure_sharded(torch, keep, QUERIES, errs))
        for name, mm in list(meas.items()) + [
                (f"{key} raw lanes", meas[key]["raw"])
                for key in ("graph_step_fp32", "graph_step_int8")]:
            extra = "".join(
                f"; {what} {mm[key]:.3f} ms" for key, what in (
                    ("dense_ms", "every tile computed"),
                    ("dense_bound_ms", "dense bound"),
                    ("gather_library_ms", "gather-first library"),
                    ("no_reuse_ms", "every gather from HBM"),
                    ("ms_per_hop", "host clock per hop of the read"))
                if key in mm)
            log(f"{name} at {mm['shape']}: kernel {mm['ms']:.3f} ms, twin "
                f"{mm['plain_ms']:.3f} ms, library {mm['library_ms']:.3f} "
                f"ms, bound {mm['bound_ms']:.3f} ms ({mm['bound_by']})"
                + extra)
    with Phase("5c durability and tiering", torch):
        # the phase resets every count just before it and reads it after
        for name, c in main_durability(torch, dev, keep, QUERIES).items():
            launches[name] += c
    with Phase("5d resilience", torch):
        # the phase resets every count just before it and reads it after
        for name, c in main_chaos(torch, dev, CHAOS_N, D, SEED).items():
            launches[name] += c

    # ---- the generation side, after the retrieval phases' tensors go ---
    b1_live = {"stream": keep["b1_live_share_stream"],
               "sharded": keep["b1_live_share_5b"]}
    b2_knn = keep["b2_knn"]
    errs["pairwise_dist"] = max(errs["pairwise_dist"], b2_knn["max_abs_err"])
    keep.clear()
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("7 generation", torch):
        # the phase resets every count just before it and reads it after
        gen = main_generate(torch, dev, SEED, errs, keep)
    for name in ("filtered_topk", "pairwise_dist", "quant_topk",
                 "graph_step"):
        launches[name] += gen[name]
    launches["flash_decode"] = gen["flash_decode"]
    with Phase("7d B5 on the recorded tick (measure)", torch):
        meas["flash_decode"] = mm = measure_decode(torch, keep, errs)
        log(f"flash_decode at {mm['shape']}: kernel {mm['ms']:.4f} ms, "
            f"library {mm['library_ms']:.4f} ms (events around back-to-"
            f"back calls), twin {mm['plain_ms']:.4f} ms; device time kernel "
            f"{mm['device_ms']:.4f} ms, library "
            f"{mm['library_device_ms']:.4f} ms; bound {mm['bound_ms']:.4f} "
            f"ms ({mm['bound_by']})")
    g = keep["generation"]
    log(f"generation: prefill {g['prefill_ms_mean']:.2f} ms per request, "
        f"decode {g['decode_tick_ms_mean']:.3f} ms per tick (p50 "
        f"{g['decode_tick_ms_p50']:.3f}), {g['tokens_per_s']:.1f} tokens/s "
        f"end to end, decode vs forward {g['decode_vs_forward_rel']:.4f} x "
        f"rms")

    # ---- the serving tier, after the generation side's tensors go ------
    keep.clear()
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("8 serving tier", torch):
        # the phase resets every count just before it and reads it after
        for name, c in main_serving(torch, dev, SEED, keep).items():
            launches[name] += c
    with Phase("8 measure (B1 grouped on the recorded flush)", torch):
        meas["filtered_topk_grouped"] = measure_grouped(torch, keep, errs)
    sv = keep["serving"]
    sources = {"filtered_topk": ("src/repro_torch/csrc/filtered_topk.cu",
                                 "src/repro/kernels/filtered_topk.py:131"),
               "pairwise_dist": ("src/repro_torch/csrc/distance.cu",
                                 "src/repro/kernels/distance.py:36"),
               "quant_topk": ("src/repro_torch/csrc/quant_topk.cu",
                              "src/repro/kernels/quant_topk.py:128"),
               "graph_step": ("src/repro_torch/csrc/graph_step.cu",
                              "src/repro/kernels/graph_topk.py:75"),
               "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_decode.py:64")}
    kernels = []
    for name, mkey in (("filtered_topk", "filtered_topk"),
                       ("pairwise_dist", "pairwise_dist"),
                       ("quant_topk", "quant_topk"),
                       ("graph_step", "graph_step_fp32"),
                       ("flash_decode", "flash_decode")):
        mm = meas[mkey]
        entry = {
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": mm["ms"],
            "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
            "bound_by": mm["bound_by"], "library_ms": mm["library_ms"],
            "shape": mm["shape"]}
        if name == "pairwise_dist":
            # phase 4b's monolithic builds launch it at the kNN tile shape
            entry["knn"] = b2_knn
        if name == "flash_decode":
            entry["device_ms"] = mm["device_ms"]
            entry["library_device_ms"] = mm["library_device_ms"]
        if name == "filtered_topk":
            for key in ("dense_bound_ms", "pass_share", "gather_library_ms",
                        "scan_tile_share"):
                entry[key] = mm[key]
            entry["tile_share"] = {"stream": b1_live["stream"],
                                   "sharded": b1_live["sharded"]}
            # the grouped launch of the serving tier (phase 8), timed on
            # the recorded flush's largest launch
            mg = meas["filtered_topk_grouped"]
            entry["grouped"] = {
                key: mg[key] for key in (
                    "ms", "plain_ms", "solo_ms", "library_ms", "bound_ms",
                    "bound_by", "pass_share", "max_abs_err", "shape")}
            entry["grouped"]["launches"] = sv["grouped_launches"]
            entry["grouped"]["flush"] = {
                key: sv[key] for key in ("rps", "p50", "p99", "degraded",
                                         "grouped_ms", "solo_ms", "idle",
                                         "groups")}
        if name == "quant_topk":
            for key in ("dense_bound_ms", "pass_share", "live_tile_share",
                        "tile_share", "dense_ms"):
                entry[key] = mm[key]
        if name == "graph_step":
            # fp32 on the traversal's lanes at the top level; each block
            # type carries the hop's raw lanes too
            hop_keys = ("ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "no_reuse_ms", "neg_share",
                        "distinct_rows", "gathers", "shape")
            for key in ("no_reuse_ms", "neg_share", "distinct_rows",
                        "gathers", "fresh_share", "read_hops", "read_ms",
                        "ms_per_hop"):
                entry[key] = mm[key]
            entry["raw"] = {key: mm["raw"][key] for key in hop_keys}
            m8 = meas["graph_step_int8"]
            entry["int8"] = {key: m8[key] for key in hop_keys + (
                "fresh_share", "read_hops", "read_ms", "ms_per_hop")}
            entry["int8"]["raw"] = {key: m8["raw"][key] for key in hop_keys}
        kernels.append(entry)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
