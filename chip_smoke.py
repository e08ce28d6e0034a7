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
recovered answer bit for bit to a fault-free oracle.  Phase 5e restores
5c's snapshots on a shard mesh over every visible card (two entries on
the one card when only one is visible) and holds every read, a grouped
flush, a budgeted restore and the same ingest / delete / seal ops on both
bit for bit to the single-card managers; a 1M-vector pack is scanned on
the mesh and on one card, bit for bit, and both are timed.
It times each of those kernels beside its twin, its roofline bound and
one PyTorch library call computing the same function.  Then it frees those phases' tensors and
drives the generation side at the full width of ``internvl2-2b`` in bf16
(random weights drawn on the card from ``SEED``): a ``ContinuousBatcher``
run, decode checked against a full forward, and ``RAGPipeline.answer``
over a static ``DocumentStore``; the decode kernel (B5) is held against
its twin on the inputs one layer of a recorded batcher tick handed it,
and timed there.  Phase 7b then serves the other generation families at
their published widths, each model freed before the next: gemma3-1b
(sliding window; B5 windowed) and qwen2-moe-a2.7b through the batcher,
falcon-mamba-7b, zamba2-2.7b (B5 at head width 80) and whisper-medium
(frames in, B5 over its cross K/V) through ``serve_step.generate``;
each family's decode is held to a forward (the state families block by
block), and B5 is checked and timed on a windowed, a global and an hd-80
call it made.  Last (phase 8) it serves a geo-temporal workload of 4
tenants over one shared substrate through ``CubeGraphService`` (kernel
B1's grouped launch), checks isolation, recall and a recorded flush
answered grouped against the same requests answered solo, bit for bit,
and times the grouped launch on that flush.  Phase 9 then trains
gemma3-1b at its published width in bf16 (remat on, AdamW, the synthetic
stream at 4 x 1024 tokens): the loss must fall, accumulation over two
microbatches must give the one-batch loss, and the step is timed, traced
and split into its parts; one train step of each family's smoke config
in fp32 is held to the same step on the CPU, and the training launcher
checkpoints, resumes and must consume the same batches.  Phase 10 holds
the mesh side: int8 gradient compression (``compressed_psum``) over one
step's gradients on a one-rank NCCL group, bit for bit against the CPU;
a DTensor train step on a 1 x 1 mesh, bit for bit against the plain step;
and the dry run, whose peak-memory estimate of phase 9's cell is printed
beside phase 9's measured peak, with one production record (256 fake
ranks) that a subprocess computes on the host from the start.

The last three lines of standard output are the card's name and power
limit (from ``nvidia-smi``), a JSON object describing every kernel, and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
those lines; so does a machine without a CUDA card, or a directory that
does not hold the port's sources.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): fp32 outside the tensor cores, bf16 on
# the tensor cores, HBM3.  One source, ``repro_torch.launch.mesh.HW``:
# ``load_peaks`` sets these once the port is importable.
PEAK_FP32_FLOPS = PEAK_BF16_FLOPS = PEAK_BYTES = None

# Main-path sizes.  D is the embedding width and is never cut; a cut of
# the n's is made here and listed in PERF.md.
D = 768
QUERIES = 1000
N_SCAN = 1_000_000
N_INDEX = 100_000       # cut from 1M: level-0 kNN is O(n^2 / 2^m * d)
N_STREAM = 100_000
N_SHARDED = 100_000     # points per manager in the sharded streaming phase
MESH_SEGMENTS = 16      # phase 5e: the 1M scan's data as segments ...
MESH_SCAN_SHARDS = 4    # ... of this many shards each (one [64, 16384] bucket)
MESH_OPS_N = 8192       # points each mesh manager ingests in 5e's ops
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
PROFILE_TRIES = 3       # profiler sessions before a device time counts as
                        # not measured (a CUPTI trace can come back empty)
N_FORWARD = 2           # requests whose decode logits are held to a forward
# Decode vs forward: |diff| <= LOGIT_TOL * rms(row) of the forward's
# logits.  bf16 rounds each result to 8 bits (2^-9 relative); the decode
# step and the forward round at different points (B5's fp32 softmax
# against the forward's bf16 scores, one-row against many-row matmul
# kernels), about ten per layer over 24 layers: as a random walk about
# sqrt(240) x 0.2% = 3% of the logit scale; 0.15 leaves a 5x margin.
LOGIT_TOL = 0.15
# Generation families (7b): each at its published width in bf16, random
# weights drawn on the card from SEED, freed before the next; depth is
# never cut.  "batcher" families run through a ContinuousBatcher (prompt
# lengths drawn in [lo, hi]), the others through serve_step.generate
# (one batch of `prompt` tokens; whisper with frames [batch, 1500, d]).
# gemma3's prompts pass its 512-token window; qwen2-moe's 8 requests
# fill the 8 slots.  The SSM and hybrid families hold REPLAY decode steps
# from position 0 to a forward over the same tokens, block by block.
FAMILIES = (
    ("gemma3-1b", dict(run="batcher", slots=8, max_len=4096, requests=16,
                       lo=600, hi=3000, new=32)),
    ("qwen2-moe-a2.7b", dict(run="batcher", slots=8, max_len=2048,
                             requests=8, lo=512, hi=1536, new=16)),
    ("falcon-mamba-7b", dict(run="generate", batch=4, prompt=512, new=16)),
    ("zamba2-2.7b", dict(run="generate", batch=4, prompt=512, new=16)),
    ("whisper-medium", dict(run="generate", batch=2, prompt=64, new=16)),
)
FAMILY_PROFILE_STEP = 8     # the decode step traced with torch.profiler
FAMILY_RECORD_STEP = 12     # the decode step whose B5 inputs are recorded:
# gemma3's layer 1 (window 512) and layer 6 (global), zamba2's group 5
# (hd 80); as (arch, B5 call within the step, name)
FAMILY_RECORDS = (("gemma3-1b", 0, "windowed"), ("gemma3-1b", 5, "global"),
                  ("zamba2-2.7b", 4, "hd80"))
REPLAY = 256
N_RAG = 20_000          # documents (d_emb = D, metadata lon, lat, t)
RAG_SPAN = 256          # tokens per document
RAG_QUERIES = 8
RAG_QUERY_TOKENS = 32
RAG_K = 8
RAG_MAX_NEW = 16
RAG_CONTEXT = 2048
# Training (9): gemma3-1b at its published width in bf16 (default remat
# "full"), random weights from SEED, the synthetic learnable stream at
# TRAIN_BATCH x TRAIN_SEQ (past the 512-token window), OptConfig defaults
# but TRAIN_LR (the training launcher's default); TRAIN_WARMUP untimed
# steps, then TRAIN_STEPS timed.  Then one step of each family's smoke
# config in fp32 on the card against the CPU (TRAIN_FAMILIES, the CPU
# parity tests' tolerances), and the launcher's resume leg (RESUME_STEPS
# with a checkpoint every RESUME_EVERY, then a second run from the last).
TRAIN_ARCH = "gemma3-1b"
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_LR = 1e-3
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
TRAIN_ACCUM_RTOL = 2e-2         # accum 2 vs accum 1 on one batch (bf16)
TRAIN_FAMILIES = ("codeqwen1.5-7b", "gemma3-1b", "qwen2-moe-a2.7b",
                  "internvl2-2b", "falcon-mamba-7b", "zamba2-2.7b",
                  "whisper-medium")
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4
RESUME_STEPS, RESUME_EVERY = 12, 4
# The resumed run's losses against the uninterrupted run's: the state
# restored is equal bit for bit, but the card's atomics (embedding and
# index_add_ backward) need not add in the same order twice.
RESUME_LOSS_RTOL = 1e-3
# Phase 10 (mesh and compression): 10a compresses one TRAIN_ARCH step's
# gradients (phase 9's shape) over a one-rank NCCL group, COMPRESS_ITERS
# timed calls; 10b trains MESH_ARCHS' smoke configs in fp32 as DTensors on
# a 1 x 1 ("data", "model") mesh under each of MESH_VARIANTS (the dry run's
# perf variants) against the plain step; 10c dry-runs phase 9's own cell
# on one fake rank and prints the production record DRYRUN_CELL, which a
# subprocess computes on 256 fake ranks while the earlier phases run.
COMPRESS_ITERS = 5
MESH_ARCHS = ("gemma3-1b", "qwen2-moe-a2.7b")
MESH_VARIANTS = ("baseline", "sp", "localdisp")
DRYRUN_CELL = ("gemma3-1b", "train_4k", "pod1")
DRYRUN_WAIT_S = 900.0


def load_peaks() -> None:
    """The H100 constants of ``repro_torch.launch.mesh.HW``, as this
    script's module constants."""
    from repro_torch.launch.mesh import HW
    global PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES
    PEAK_FP32_FLOPS, PEAK_BF16_FLOPS = HW.PEAK_FP32_FLOPS, HW.PEAK_BF16_FLOPS
    PEAK_BYTES = HW.HBM_BW


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


def device_ms(torch, fn, iters: int, warmup: int = 2,
              tries: int = PROFILE_TRIES):
    """Mean device time of ``fn``: the summed durations of the kernels
    ``iters`` calls ran, under ``torch.profiler``.  Unlike ``cuda_ms`` it
    leaves out the host's gaps between launches, which decide the
    back-to-back time of a kernel shorter than its wrapper's host time.
    A session whose CUPTI trace comes back without a device event is made
    again, up to ``tries`` sessions; after that the device time is not
    measured (None) and the CUDA-event times stand alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    log(f"torch.profiler recorded no device time in {tries} sessions: "
        f"device time not measured")
    return None


def fmt_ms(ms, digits: int = 4) -> str:
    """``ms`` with ``digits`` decimals and its unit, or "not measured"
    where the profiler recorded no device time."""
    return "not measured" if not ms else f"{ms:.{digits}f} ms"


def fmt_share(share) -> str:
    """An idle share to three decimals, or "not measured" (None)."""
    return "not measured" if share is None else f"{share:.3f}"


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
    bv = max(view.buckets, key=lambda b: b.n_rows * b.cap)
    b_codes, b_s, b_xsq, b_scales = (bv.block(name) for name in
                                     ("codes", "s", "xsq", "scales"))
    rows, cap = bv.n_rows, bv.cap
    m = b_s.shape[2]
    kind, params = ops.encode_filter(f, m, mpad=m)
    p = torch.as_tensor(params, device=dev)
    kpad = 64
    qs = q[None] * b_scales[:, None, :]
    args = (qs, b_codes, b_s, b_xsq, p, kind, kpad, "l2")
    kd, ki = quant_topk_call(*args)
    torch.cuda.synchronize()
    td, ti = quant_topk_plain(*args)
    e = compare_topk(torch, kd, ki, td, ti, qn + b_xsq.max(),
                     f"B3 main-path bucket [{rows}, {cap}]")
    errs["quant_topk"] = max(errs["quant_topk"], e)
    log(f"B3 vs twin on the largest int8 bucket [{rows}, {cap}, {d}], "
        f"{nq} queries, {kind}, kpad {kpad}: agree, max |err| {e:.3g}")
    ms = cuda_ms(torch, lambda: quant_topk_call(*args), iters=10)
    plain = cuda_ms(torch, lambda: quant_topk_plain(*args), iters=2,
                    warmup=1)
    # the same codes with every candidate passing: the kernel computes all
    # tiles, so this is its dense tile rate
    every = (qs, b_codes, torch.zeros_like(b_s), b_xsq, torch.as_tensor(
        ops.encode_filter(None, m, mpad=m)[1], device=dev), "none", kpad,
        "l2")
    dense_ms = cuda_ms(torch, lambda: quant_topk_call(*every), iters=5)
    lo = p[0, :m]
    hi = p[1, :m]

    def b3_library():
        deqb = b_codes.float() * b_scales[:, None, :]
        dm = b_xsq[:, None, :] - 2.0 * torch.matmul(q[None],
                                                     deqb.transpose(1, 2))
        ok = ((b_s >= lo) & (b_s <= hi)).all(-1)
        return torch.topk(dm.masked_fill_(~ok[:, None, :], float("inf")),
                          kpad, dim=-1, largest=False)
    lib = cuda_ms(torch, b3_library, iters=3, warmup=1)
    # what these inputs need: the products of the candidates that pass the
    # predicate; all metadata and norms, the passing codes, the folded
    # queries and the lists.  dense_bound_ms counts every position, as the
    # bound did before the kernel skipped tiles.
    npos = rows * cap
    passing, live, tiles = b3mod.live_tiles(b_s, p, kind, b3mod.TN)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = b3mod.launch_config(rows, nq, cap, d, kpad, 0, 0,
                                 sms)["splits"]
    packed = packed_tiles(b_s, p, kind, splits)
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


def main_durability(torch, dev, keep: dict, nq: int, root: str) -> dict:
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
    part after it is not counted).  The snapshots stay under ``root``
    (phase 5e restores them on the shard mesh; the caller removes it)."""
    import dataclasses
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
    timed = []
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
    return launches


# ---------------------------------------------------------------------------
# The shard mesh (5e)
# ---------------------------------------------------------------------------
def smoke_mesh(torch, dev):
    """Phase 5e's mesh: every visible card, home ``dev``; two entries on
    ``dev`` when it is the only card (placement, the per-card launches and
    the merge run, but no copy crosses cards).  Returns ``(mesh,
    distinct cards)``."""
    from repro_torch.distributed import ShardMesh, make_shard_mesh
    if torch.cuda.device_count() > 1:
        mesh = make_shard_mesh()
    else:
        mesh = ShardMesh((dev, dev))
    check(mesh.home == dev, f"the mesh's home {mesh.home} is not {dev}")
    return mesh, len(set(mesh.devices))


def hold_mesh(one, many, q, filters, what: str, rps=("scan", "graph",
                                                     "auto")) -> int:
    """Every filter x read path of ``many`` (on the mesh) bit for bit
    ``one``'s (on one card), with the same planner decisions.  Returns
    the reads held."""
    import numpy as np
    n = 0
    for fname, f in filters.items():
        for rp in rps:
            ga, da = one.query(q, f, k=10, read_path=rp)
            gb, db = many.query(q, f, k=10, read_path=rp)
            if rp != "scan":
                pa = {c: p.mode for c, p in one.last_plan.items()}
                pb = {c: p.mode for c, p in many.last_plan.items()}
                check(pa == pb, f"{what} {fname}/{rp}: mesh plan {pb} != "
                      f"one card's {pa}")
            check(bool(np.array_equal(ga, gb))
                  and bool(np.array_equal(da, db)),
                  f"{what} {fname}/{rp}: the mesh's answers differ from one "
                  "card's")
            n += 1
    return n


def mesh_ops(one, many, q, seed: int) -> None:
    """The same ingest / delete / seal / expire ops on both managers:
    ``MESH_OPS_N`` new points near the queries, later in event time, then
    1% of the live points deleted, a maintenance tick and a seal."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n, d = MESH_OPS_N, q.shape[1]
    x = (q[rng.integers(0, len(q), n)]
         + 0.05 * rng.normal(size=(n, d))).astype(np.float32)
    s = rng.uniform(size=(n, one.m))
    s[:, one.time_dim] = one.now + (1.0 + np.arange(n)) / N_SHARDED
    live = np.nonzero(one.alive)[0]
    dead = rng.choice(live, size=len(live) // 100, replace=False)
    for mgr in (one, many):
        mgr.ingest(x, s)
        mgr.delete(dead)
        mgr.maintenance()
        mgr.seal()
    # a mesh bucket may hold more free rows (its row count divides the
    # mesh), never other segments
    occupied = [{cap: (b["live_rows"], b["segments"])
                 for cap, b in mgr.stats()["pack_buckets"].items()}
                for mgr in (one, many)]
    check(occupied[0] == occupied[1], f"5e ops: the mesh packs "
          f"{occupied[1]}, one card {occupied[0]}")


def hop_ms(torch, mgr, q, f) -> float:
    """A forced-graph read's host-clock ms per hop."""
    hist = mgr.obs.registry.histogram("graph_hops")
    before = hist.snapshot()["sum"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.query(q, f, k=10, read_path="graph")
    dt = (time.perf_counter() - t0) * 1e3
    hops = hist.snapshot()["sum"] - before
    check(hops > 0, "5e: the forced-graph read made no hop")
    return dt / hops


def mesh_scan(torch, dev, mesh, keep: dict) -> dict:
    """Phase 3's 1M x 768 data as ``MESH_SEGMENTS`` segments of
    ``MESH_SCAN_SHARDS`` shards in a bucketed pack, on the mesh and on one
    card: the 1000-query scan (no filter, and phase 3's box) bit for bit
    on both and in distances against phase 3's exact scan; each pack's
    read timed by CUDA events around back-to-back calls."""
    import numpy as np
    from repro_torch.distributed.segment_shards import (
        SegmentShardSource, build_bucketed_pack, pack_search_blocks)
    from repro_torch.kernels import ops
    xh = keep["x"].cpu().numpy()
    sh = keep["s"].cpu().numpy().astype(np.float64)
    qh = keep["q"].cpu().numpy()
    n = len(xh)
    cuts = np.linspace(0, n, MESH_SEGMENTS + 1).astype(np.int64)
    srcs = [SegmentShardSource(i, xh[lo:hi], sh[lo:hi],
                               np.arange(lo, hi, dtype=np.int64),
                               float(sh[lo:hi, 2].min()),
                               float(sh[lo:hi, 2].max()))
            for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:]))]
    out = {}
    t0 = time.perf_counter()
    one = build_bucketed_pack(srcs, MESH_SCAN_SHARDS, device=dev)
    many = build_bucketed_pack(srcs, MESH_SCAN_SHARDS, mesh=mesh)
    del xh, srcs
    check(one.bucket_stats() == many.bucket_stats(),
          "5e scan: the mesh's bucket geometry differs from one card's")
    vo, vm = one.view(), many.view()
    per_card = [sum(t[c].numel() * t[c].element_size()
                    for b in many.buckets.values() for t in b.blk.values())
                for c in range(mesh.size)]
    log(f"mesh scan: two packs of {n} x {keep['x'].shape[1]} built in "
        f"{time.perf_counter() - t0:.1f} s; buckets {many.bucket_stats()}, "
        f"{many.nbytes} bytes, per mesh entry {per_card}")
    for fname, f in (("none", None), ("box", keep["box"])):
        a = pack_search_blocks(vo, qh, f, 10)
        b = pack_search_blocks(vm, qh, f, 10)
        check(all(bool(np.array_equal(ga, gb)) and bool(np.array_equal(
            da, db)) for (ga, da), (gb, db) in zip(a, b)),
              f"5e scan {fname}: the mesh's answers differ from one card's")
        _, dd = ops.exact_filtered_search(keep["q"], keep["x"], keep["s"],
                                          f, 10)
        check(bool(np.array_equal(a[0][1], dd.cpu().numpy())),
              f"5e scan {fname}: the pack's distances differ from phase "
              "3's exact scan")
        ms_one = cuda_ms(torch, lambda: pack_search_blocks(vo, qh, f, 10),
                         iters=5)
        ms_many = cuda_ms(torch, lambda: pack_search_blocks(vm, qh, f, 10),
                          iters=5)
        out[fname] = {"one_ms": ms_one, "mesh_ms": ms_many}
        log(f"mesh scan {fname}: {len(qh)} queries x {n}, one card "
            f"{ms_one:.3f} ms, mesh {ms_many:.3f} ms ({ms_one / ms_many:.2f}"
            f"x; CUDA events around back-to-back reads), bit for bit")
    return out


def main_shard_mesh(torch, dev, keep: dict, root: str, seed: int) -> dict:
    """Phase 5e: 5c's snapshots of 5b's managers restored on the shard mesh
    and held bit for bit to 5b's managers (on one card) on every filter
    and read path; the fp32 pair answers one grouped flush, and the fp32
    snapshot is restored on the mesh under a budget that leaves a bucket
    cold (scans held); then the same ops go to both pairs and they are
    held again.  B1, B3 and B4 must launch on every card of the mesh.
    After the checked part, the 1M scan (:func:`mesh_scan`) and the
    forced-graph read's ms per hop on one card and on the mesh."""
    import dataclasses
    import numpy as np
    from repro_torch.streaming import SegmentManager
    from repro_torch.streaming.query import GroupQuery
    mesh, n_cards = smoke_mesh(torch, dev)
    log(f"mesh_cards: {n_cards}" + (" (cross-card copies not exercised)"
                                    if n_cards == 1 else "")
        + f"; mesh {[str(d) for d in mesh.devices]}, home {mesh.home}")
    mods = {name: importlib.import_module(f"repro_torch.kernels.{mod}")
            for name, mod in (("filtered_topk", "filtered_topk"),
                              ("quant_topk", "quant_topk"),
                              ("graph_step", "graph_topk"))}
    for mod in mods.values():
        mod.reset_launch_count()
    q, filters = keep["q_sharded"], keep["sharded_filters"]
    pairs, held = {}, 0
    for name, one in keep["managers"].items():
        snap = os.path.join(root, name)
        t0 = time.perf_counter()
        many = SegmentManager.restore(snap, shard_mesh=mesh, resume=False)
        check(many.device == dev and many.shard_mesh is mesh,
              f"5e[{name}]: the restored manager is not on the mesh")
        held += hold_mesh(one, many, q, filters, f"mesh[{name}]")
        log(f"mesh[{name}]: restored on the mesh and held bit for bit in "
            f"{time.perf_counter() - t0:.1f} s; pack {many._pack.nbytes} "
            f"bytes, buckets {many.stats()['pack_buckets']}")
        pairs[name] = (one, many)
    one, many = pairs["fp32"]
    groups = [GroupQuery(q[:300], filters["interval"], 10),
              GroupQuery(q[300:700], filters["box_and_interval"], 10),
              GroupQuery(q[700:], None, 7)]
    for ga, gb in zip(one.query_grouped(groups), many.query_grouped(groups)):
        check(bool(np.array_equal(ga[0], gb[0]))
              and bool(np.array_equal(ga[1], gb[1])),
              "5e grouped flush: the mesh's answers differ from one card's")
    full = many._pack.nbytes
    largest = max(b.full_nbytes for b in many._pack.buckets.values())
    budget = min(full // 3, largest - 1)
    tier = SegmentManager.restore(
        os.path.join(root, "fp32"), cfg=dataclasses.replace(
            many.cfg, device_budget_bytes=budget), shard_mesh=mesh,
        resume=False)
    held += hold_mesh(one, tier, q, filters, "mesh budget", rps=("scan",))
    if tier._prefetch_thread is not None:
        tier._prefetch_thread.join(timeout=120)
    st = tier.stats()
    misses = st["obs"]["metrics"]["counters"].get("tier_miss_total", 0)
    check(misses > 0 and tier._pack.nbytes <= budget,
          f"5e budget: misses {misses}, resident {tier._pack.nbytes} of "
          f"budget {budget}")
    log(f"mesh budget: {budget} of {full} bytes, scans bit for bit; tier "
        f"{st['tier']}, misses {misses}")
    del tier
    for i, (name, (one, many)) in enumerate(pairs.items()):
        mesh_ops(one, many, q, seed + 50 + i)
        held += hold_mesh(one, many, q, filters, f"mesh[{name}] after ops")
    per_card = {kn: mod.launch_counts_by_device()
                for kn, mod in mods.items()}
    launches = {kn: mod.launch_count() for kn, mod in mods.items()}
    log(f"mesh phase: {held} reads held bit for bit plus a grouped flush; "
        f"launches {launches}, per card {per_card}")
    for kn, per in per_card.items():
        for d in set(mesh.devices):
            check(per.get(d.index, 0) >= 1,
                  f"kernel {kn} was not launched on {d} in phase 5e")
    hops = {name: {"one_ms": hop_ms(torch, one, q, keep["sharded_filter"]),
                   "mesh_ms": hop_ms(torch, many, q, keep["sharded_filter"])}
            for name, (one, many) in pairs.items()}
    for name, h in hops.items():
        log(f"mesh[{name}] forced-graph read: {h['one_ms']:.3f} ms per hop "
            f"on one card, {h['mesh_ms']:.3f} on the mesh (host clock)")
    del pairs, one, many
    scan = mesh_scan(torch, dev, mesh, keep)
    return {"launches": launches, "per_card": per_card, "cards": n_cards,
            "hop": hops, "scan": scan}


# ---------------------------------------------------------------------------
# Resilience (5d) and the serving tier (8)
# ---------------------------------------------------------------------------
def _kernel_mods(generation: bool = False):
    """The retrieval kernels' modules by kernel name (the launch counters);
    with ``generation``, B2's and B5's too."""
    mods = (("filtered_topk", "filtered_topk"), ("quant_topk", "quant_topk"),
            ("graph_step", "graph_topk"))
    if generation:
        mods += (("pairwise_dist", "distance"),
                 ("flash_decode", "flash_decode"))
    return {name: importlib.import_module(f"repro_torch.kernels.{mod}")
            for name, mod in mods}


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
    idle = 1.0 - prof["device_ms"] / wall if prof["device_ms"] else None
    log(f"serving: a traced flush: {wall:.1f} ms host clock (profiler on), "
        f"{fmt_ms(prof['device_ms'], 3)} device time in {prof['kernels']} "
        f"kernels, idle share {fmt_share(idle)}; top {prof['top']}")
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
    for event in up.events:
        event.synchronize()
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


def compare_decode(torch, q, k, v, lengths, what: str,
                   window: int = -1) -> float:
    """B5 kernel vs twin on one input.  Both compute in fp32 and round the
    output once to q's dtype, so they differ by the summation order
    (fp32: within 2e-4, the reference's own kernel-test bound) and, in
    bf16, by at most one rounding of the output (1e-2 absolute and
    relative: two bf16 ulps at |o| ~ 1).  Returns the largest absolute
    difference."""
    from repro_torch.kernels.flash_decode import (flash_decode_call,
                                                  flash_decode_plain)
    got = flash_decode_call(q, k, v, lengths, window)
    torch.cuda.synchronize()
    want = flash_decode_plain(q, k, v, lengths, window)
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
    # windowed rows and head width 80: window 0, windows that start inside
    # a tile, gemma3's 512, windows longer than every prefix; zamba2's
    # hd 80 (40 column pairs: the PV pass leaves 8 threads idle)
    shapes = [(6, 4, 1100, 256, 0), (6, 4, 1100, 256, 37),
              (8, 4, 4096, 256, 512), (6, 4, 1100, 256, 5000),
              (5, 1, 700, 80, -1), (6, 1, 700, 80, 37), (6, 2, 700, 80, 0),
              (4, 16, 300, 80, 512), (128, 1, 1024, 80, -1),
              (8, 1, 2048, 128, 512), (7, 8, 999, 64, 70)]
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for bkv, g, smax, hd, window in shapes:
            q, k, v = (torch.randn(shape, generator=gen, device=dev
                                   ).to(dtype)
                       for shape in ((bkv, g, hd), (bkv, smax, hd),
                                     (bkv, smax, hd)))
            lengths = torch.randint(0, smax, (bkv,), generator=gen,
                                    device=dev, dtype=torch.int32)
            lengths[0] = 0
            lengths[1] = smax - 1
            err = max(err, compare_decode(
                torch, q, k, v, lengths, f"B5 {dtype} [{bkv}, {g}, {smax}, "
                f"{hd}] window {window}", window))
    errs["flash_decode"] = max(errs["flash_decode"], err)
    log(f"B5 vs twin, windowed and hd 80: fp32 and bf16 x {len(shapes)} "
        f"shapes (windows 0, 37, 70, 512, 5000 and global; hd 64 / 80 / "
        f"128 / 256; lengths 0 and smax - 1) agree; max |err| {err:.3g}")


def profile_tick(torch, step, tries: int = 1) -> dict:
    """One call of ``step`` under ``torch.profiler``: the device time of
    the kernels it ran (their summed durations), their count, the five
    largest by name and the eight operators with the most device time of
    their own (``ops``).  A device time of 0 means the trace held no
    device event; a ``step`` that may run again is traced again then, up
    to ``tries`` sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            break
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    ops = [(e.key, getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
           for e in prof.key_averages()]
    ops = sorted(ops, key=lambda kv: -kv[1])[:8]
    return dict(device_ms=sum(by_name.values()), kernels=n,
                top=[(name[:60], round(ms, 4)) for name, ms in top],
                ops=[(name, round(ms, 3)) for name, ms in ops])


def logits_close(torch, dec, fwd, what: str):
    """Decode logits ``dec`` against a forward's ``fwd`` (``[steps,
    vocab]`` each, fp32): |diff| <= LOGIT_TOL x the forward row's rms, and
    the decode's argmax equals the forward's wherever the forward's top-2
    gap exceeds that.  Returns (worst |diff| / rms, steps whose argmax was
    checked, near-tie steps whose argmax differs)."""
    rms = fwd.pow(2).mean(-1, keepdim=True).sqrt()
    rel = ((dec - fwd).abs() / rms).max(-1).values
    worst = float(rel.max())
    check(bool((rel <= LOGIT_TOL).all()),
          f"{what}: decode logits differ from the forward's by "
          f"{worst:.4f} x rms > {LOGIT_TOL}")
    top2 = torch.topk(fwd, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) / rms[:, 0] > LOGIT_TOL
    agree = dec.argmax(-1) == fwd.argmax(-1)
    check(bool(agree[sure].all()),
          f"{what}: a greedy token differs from the forward's argmax where "
          f"the top-2 gap exceeds the tolerance")
    return worst, int(sure.sum()), int((~agree).sum())


class RouteTape:
    """The experts each MoE layer picked in a prefill-then-decode run,
    forced on the forwards it is held to.  bf16 rounds the decode step
    and the forward at different points, and with random weights about
    a few percent of a token's top-4 choices out of 60 are near-ties that
    then flip; a flipped expert moves the token's output by a whole
    expert's share, which no logit tolerance absorbs.  Under the tape the
    forward routes every position to the experts its prefill or decode
    step chose (gates from the forward's own probabilities at those
    experts), so the comparison holds the rest of the arithmetic.  The
    flips are counted (``flips``: assignments the forward would have
    chosen differently)."""

    def __init__(self, torch, moe_mod, n_layers: int, n_req: int):
        self.torch, self.mod, self.real = torch, moe_mod, moe_mod.route
        self.n_layers, self.n_req = n_layers, n_req
        self.calls, self.mode, self.flips, self.total = [], None, 0, 0

    def __enter__(self):
        self.mod.route = self.route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.real
        return False

    def on_forward(self, i: int) -> None:
        self.mode, self.layer = i, 0

    def route(self, xt, router, cfg):
        if self.mode is None:                        # recording
            out = self.real(xt, router, cfg)
            self.calls.append(out[0])
            return out
        torch, i, l = self.torch, self.mode, self.layer
        self.layer += 1
        L, n = self.n_layers, self.n_req
        steps = self.calls[n * L + l::L]             # decode steps, layer l
        ids = torch.cat([self.calls[i * L + l]]
                        + [st[i:i + 1] for st in steps])
        probs = torch.softmax(torch.matmul(xt.float(), router), dim=-1)
        own = torch.topk(probs, cfg.top_k, dim=-1).indices
        self.flips += int((own.sort(-1).values != ids.sort(-1).values)
                          .sum())
        self.total += ids.numel()
        gates = probs.gather(1, ids)
        gates = gates / gates.sum(-1, keepdim=True)
        return (ids, gates, probs) + self.mod.dispatch(ids, cfg)


def hold_to_forward(torch, model, params, prompts, n_new: int,
                    max_len: int, what: str, frames=None, on_forward=None):
    """Each prompt prefilled into its own slot (ragged positions), then
    ``n_new - 1`` greedy decode steps together; every step's logits held
    to a full forward over the prompt and the tokens before it
    (``frames``: whisper's, one row per prompt; ``on_forward(i)`` is
    called before request i's forward).  Returns what
    :func:`logits_close` returns, over all prompts."""
    dev = params["final_norm"].device
    n = len(prompts)
    extra = [() if frames is None else (frames[i:i + 1],) for i in range(n)]
    cache = model.init_cache(n, max_len, device=dev)
    steps = [[] for _ in range(n)]
    cur = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    for i in range(n):
        view = {name: c[:, i:i + 1] for name, c in cache.items()}
        lg, _ = model.prefill(params, torch.as_tensor(
            prompts[i][None], device=dev), view, *extra[i])
        steps[i].append(lg[0, -1].float())
        cur[i, 0] = torch.argmax(lg[0, -1].float())
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.long,
                       device=dev)
    toks = [cur.clone()]
    for _ in range(n_new - 1):
        lg, cache = model.decode_step(params, cur, cache, pos)
        for i in range(n):
            steps[i].append(lg[i, 0].float())
        cur = torch.argmax(lg[:, 0].float(), dim=-1)[:, None].to(torch.int32)
        toks.append(cur.clone())
        pos += 1
    toks = torch.cat(toks, dim=1)
    del cache
    out = [0.0, 0, 0]
    for i in range(n):
        full = torch.cat([torch.as_tensor(prompts[i], device=dev).long(),
                          toks[i, :-1].long()])[None]
        if on_forward is not None:
            on_forward(i)
        fwd, _ = model.logits(params, full, *extra[i])
        s = len(prompts[i])
        r = logits_close(torch, torch.stack(steps[i]),
                         fwd[0, s - 1:s - 1 + n_new].float(),
                         f"{what} request {i}")
        out = [max(out[0], r[0]), out[1] + r[1], out[2] + r[2]]
    return tuple(out)


def hold_layers(torch, model, params, tokens, what: str) -> dict:
    """Decode steps from position 0 over ``tokens [b, n]``, held to the
    forward layer by layer (the SSM and hybrid families).  Each layer's
    decode steps (``mamba*_decode``; the hybrid's shared block through
    ``attention_decode``, B5) take the forward's own input to that layer
    and are held to the layer's forward output (``mamba*_scan``,
    ``attention``): each row's |diff| <= LOGIT_TOL x the row's norm.  (The
    element-wise rule of the logits does not fit here: the decode step
    keeps in fp32 what the forward rounds to bf16 (the conv output, the
    projections to dt, B and C), and over a block's 2 x 256 x 4096
    outputs a few reach 0.151 x the row's rms, in falcon-mamba's block 16
    on the card; the largest is logged.)  Beside that the decode stack
    runs free on its own hidden states, and its divergence from the
    forward's is logged: the two paths' bf16 rounding points differ, and
    their hidden states drift apart by about 0.01 of their norm a block
    (0.64 after falcon-mamba's 64 on the card), so at full depth their
    logits differ by several times their rms and an end-to-end check
    would hold nothing.  Returns the worst held ratio, the largest
    element ratio and the free divergence after each block."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import (attention, attention_decode,
                                           embed, mlp, rms_norm)
    from repro_torch.models.transformer import _layers
    cfg, dev = model.cfg, params["final_norm"].device
    b, n = tokens.shape
    eps, chunk = cfg.norm_eps, model._chunk(n)
    if cfg.family == "ssm":
        blocks = [("ssm", p) for p in _layers(params["layers"])]
        scan, step = ssm.mamba1_scan, ssm.mamba1_decode
    else:
        blocks = []
        for pg in _layers(params["ssm_layers"]):
            blocks += [("ssm", p) for p in _layers(pg)]
            blocks.append(("attn", params["shared"]))
        scan, step = ssm.mamba2_scan, ssm.mamba2_decode
    positions = torch.arange(n, device=dev)[None, :]

    def decode_block(kind, p, h):
        """The block's decode steps over ``h [b, n, d]`` from a zero
        state."""
        if kind == "ssm":
            zero = model.init_cache(b, 1, device=dev)
            conv, st = zero["conv"][0], zero["ssm"][0]
            ys = []
            for t in range(n):
                y, conv, st = step(h[:, t:t + 1], p["ssm"], cfg, conv, st)
                ys.append(y)
            return torch.cat(ys, dim=1)
        ck = torch.zeros((b, cfg.n_kv, n, cfg.hd), dtype=h.dtype,
                         device=dev)
        cv = torch.zeros_like(ck)
        ys = []
        for t in range(n):
            pos = torch.full((b,), t, dtype=torch.long, device=dev)
            ys.append(attention_decode(
                h[:, t:t + 1], p["attn"], cfg, ck, cv, pos,
                pos.to(torch.int32).repeat_interleave(cfg.n_kv),
                model.window))
        return torch.cat(ys, dim=1)

    x = embed(tokens, params["embed"])
    x_free, worst, elem, drift = x.clone(), 0.0, 0.0, []
    for li, (kind, p) in enumerate(blocks):
        ln = p["ln"] if kind == "ssm" else p["ln1"]
        h = rms_norm(x, ln, eps)
        if kind == "ssm":
            y = scan(h, p["ssm"], cfg, chunk)[0]
        else:
            y = attention(h, p["attn"], cfg, positions, model.window)
        dec = decode_block(kind, p, h)
        diff = dec.float() - y.float()
        rel = float((diff.norm(dim=-1) / y.float().norm(dim=-1)).max())
        worst = max(worst, rel)
        elem = max(elem, float((diff.abs() / y.float().pow(2).mean(
            -1, keepdim=True).sqrt()).max()))
        check(rel <= LOGIT_TOL, f"{what} block {li} ({kind}): a decode "
              f"row differs from the forward's by {rel:.4f} of its norm > "
              f"{LOGIT_TOL}")
        x_free = x_free + decode_block(kind, p, rms_norm(x_free, ln, eps))
        x = x + y
        if kind == "attn":
            x = x + mlp(rms_norm(x, p["ln2"], eps), p["mlp"])
            x_free = x_free + mlp(rms_norm(x_free, p["ln2"], eps), p["mlp"])
        drift.append(float((x_free.float() - x.float()).norm()
                           / x.float().norm()))
    return dict(worst=worst, elem=elem, drift=drift)


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
    mods = _kernel_mods(generation=True)
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

    # -- the batcher ------------------------------------------------------------
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

    def recorder(q, k, v, lengths, window=-1):
        if calls[0] == RECORD_TICK * cfg.n_layers + RECORD_LAYER:
            recorded.update(q=q.clone(), k=k.clone(), v=v.clone(),
                            lengths=lengths.clone(), window=int(window))
        calls[0] += 1
        return real_fd(q, k, v, lengths, window)
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

    # -- decode == forward ---------------------------------------------------
    worst, checked, ties = hold_to_forward(
        torch, model, params, prompts[:N_FORWARD], MAX_NEW, MAX_LEN,
        f"{ARCH}")
    log(f"decode vs forward ({N_FORWARD} requests x {MAX_NEW} steps, "
        f"ragged positions): max |diff| / rms(row) {worst:.4f} (tolerance "
        f"{LOGIT_TOL}); greedy tokens equal the forward's argmax at all "
        f"{checked} steps whose top-2 gap exceeds it ({ties} near-tie steps "
        f"differ)")
    keep["generation"]["decode_vs_forward_rel"] = worst

    # -- RAG ----------------------------------------------------------------------
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
    """B5 on the inputs layer RECORD_LAYER of batcher tick RECORD_TICK
    handed it (:func:`measure_b5`), with the slots' lengths logged."""
    rec = keep["decode"]
    mm = measure_b5(torch, rec, f"layer {RECORD_LAYER} of batcher tick "
                    f"{RECORD_TICK}", errs)
    log(f"B5 on layer {RECORD_LAYER} of tick {RECORD_TICK}: lengths per "
        f"slot {rec['lengths'].view(SLOTS, -1)[:, 0].tolist()}")
    return mm


def measure_b5(torch, rec: dict, where: str, errs: dict) -> dict:
    """B5 on one recorded call (``q, k, v, lengths``, its ``window`` and
    batch ``b``): held against its twin, then timed beside the twin, its
    bound (the K / V bytes of the keys each row reads, plus q and o, over
    HBM bandwidth) and ``scaled_dot_product_attention`` with the same
    boolean mask (the row's window, or its filled prefix)."""
    from repro_torch.kernels.flash_decode import (flash_decode_call,
                                                  flash_decode_plain)
    q, k, v, lengths = rec["q"], rec["k"], rec["v"], rec["lengths"]
    window, b = rec.get("window", -1), rec.get("b", SLOTS)
    bkv, g, hd = q.shape
    smax = k.shape[1]
    e = compare_decode(torch, q, k, v, lengths, f"B5 at {where}", window)
    errs["flash_decode"] = max(errs["flash_decode"], e)
    hi = lengths.long()
    lo = (hi - window).clamp(min=0) if window >= 0 else torch.zeros_like(hi)
    keys = int((hi - lo + 1).sum())
    log(f"B5 vs twin at {where}: [{bkv}, {g}, {smax}, {hd}] {q.dtype}, "
        f"window {window}, {keys} keys read of {bkv * smax}: agree, max "
        f"|err| {e:.3g}")
    # CUDA events around back-to-back calls, the timer of every kernel
    # here; and device time alone (the kernel is about as short as its
    # wrapper's host time, which events around back-to-back calls include)
    kern = lambda: flash_decode_call(q, k, v, lengths, window)  # noqa: E731
    ms = cuda_ms(torch, kern, iters=50, warmup=5)
    ms_device = device_ms(torch, kern, iters=50, warmup=5)
    plain = cuda_ms(torch, lambda: flash_decode_plain(q, k, v, lengths,
                                                      window), iters=10)
    import torch.nn.functional as F
    n_kv = bkv // b
    ql = q.view(b, n_kv * g, 1, hd)
    kl, vl = k.view(b, n_kv, smax, hd), v.view(b, n_kv, smax, hd)
    col = torch.arange(smax, device=q.device)[None, :]
    mask = ((col <= hi.view(b, n_kv)[:, :1])
            & (col >= lo.view(b, n_kv)[:, :1]))[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                              enable_gqa=True)
    lib_err = float((library().reshape(bkv, g, hd).float()
                     - flash_decode_plain(q, k, v, lengths, window).float()
                     ).abs().max())
    lib = cuda_ms(torch, library, iters=50, warmup=5)
    lib_device = device_ms(torch, library, iters=50, warmup=5)
    es = q.element_size()
    nbytes = 2.0 * keys * hd * es + 2.0 * q.numel() * es + 4.0 * bkv
    flops = 4.0 * keys * g * hd
    bound = max(nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS) * 1e3
    log(f"B5 library yardstick at {where}: scaled_dot_product_attention "
        f"(GQA, bool mask) differs from the twin by {lib_err:.3g}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by="bytes" if nbytes / PEAK_BYTES
                >= flops / PEAK_FP32_FLOPS else "operations",
                filled=keys, keys=keys, window=window, device_ms=ms_device,
                library_device_ms=lib_device, max_abs_err=e,
                shape=f"{where}: q[{bkv},{g},{hd}] k/v[{bkv},{smax},{hd}] "
                      f"{str(q.dtype).replace('torch.', '')}, window "
                      f"{window}, {keys} keys read")


def main_family(torch, dev, arch: str, spec: dict, seed: int,
                keep: dict) -> dict:
    """One generation family at its published width in bf16 (phase 7b):
    the run of ``spec`` (a ContinuousBatcher or serve_step.generate),
    timed per prefill and per decode step (one step traced), with the B5
    launches counted (windowed apart), MoE routes counted and the B5
    inputs of FAMILY_RECORDS kept in ``keep``; then decode held to a
    forward.  Returns the phase's launches of every kernel and its
    numbers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, count_params, init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import ContinuousBatcher, Request, generate
    mods = _kernel_mods(generation=True)
    fdm = mods["flash_decode"]
    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model.param_specs(), seed=seed, device=dev)
    torch.cuda.synchronize()
    n_par = count_params(model.param_specs())
    log(f"{arch} ({cfg.family}): {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}; {n_par} parameters "
        f"({n_par * 2 / 1e9:.2f} GB bf16) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    # B5 launches a decode step makes, windowed among them
    per_step = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
                "audio": 2 * cfg.n_layers, "encdec": 2 * cfg.n_layers
                }.get(cfg.family, cfg.n_layers)
    windowed = (int((np.asarray(model.windows) >= 0).sum())
                if hasattr(model, "windows") else 0)
    rng = np.random.default_rng(seed + 80)
    frames = None
    if cfg.n_enc_layers:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 81)
        frames = torch.randn((spec["batch"], cfg.n_frames, cfg.d_model),
                             generator=gen, device=dev)

    routes = [0, 0]                     # MoE assignments, kept
    recorded = {}
    want = {j: name for a, j, name in FAMILY_RECORDS if a == arch}
    calls = [0]
    prefill_ms, step_ms, busy = [], [], {}
    real = dict(route=moe_mod.route, fd=fdm.flash_decode_call,
                prefill=model.prefill, decode=model.decode_step)

    def route_spy(xt, router, c):
        out = real["route"](xt, router, c)
        routes[0] += out[0].numel()
        routes[1] += out[3].numel()
        return out

    def fd_spy(q, k, v, lengths, window=-1):
        step, j = divmod(calls[0], per_step)
        if step == FAMILY_RECORD_STEP and j in want:
            recorded[want[j]] = dict(q=q.clone(), k=k.clone(), v=v.clone(),
                                     lengths=lengths.clone(),
                                     window=int(window),
                                     b=q.shape[0] // cfg.n_kv)
        calls[0] += 1
        return real["fd"](q, k, v, lengths, window)

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real["prefill"](*a, **kw)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_decode(*a, **kw):
        torch.cuda.synchronize()
        if len(step_ms) == FAMILY_PROFILE_STEP and not busy:
            res = {}
            busy.update(profile_tick(torch, lambda: res.setdefault(
                "out", real["decode"](*a, **kw))))
            return res["out"]
        t = time.perf_counter()
        out = real["decode"](*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    for mod in mods.values():
        mod.reset_launch_count()
    moe_mod.route, fdm.flash_decode_call = route_spy, fd_spy
    model.prefill, model.decode_step = timed_prefill, timed_decode
    try:
        t_run = time.perf_counter()
        if spec["run"] == "batcher":
            lens = rng.integers(spec["lo"], spec["hi"] + 1, spec["requests"])
            prompts = [rng.integers(2, cfg.vocab, size=int(n)).astype(
                np.int32) for n in lens]
            batcher = ContinuousBatcher(model, params,
                                        n_slots=spec["slots"],
                                        max_len=spec["max_len"], eos_id=-1)
            for i, p in enumerate(prompts):
                batcher.submit(Request(req_id=i, prompt=p,
                                       max_new=spec["new"]))
            done = batcher.run_until_drained()
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t_run
            check(len(done) == spec["requests"],
                  f"{arch}: the batcher finished {len(done)} requests")
            outs = [np.asarray(r.output) for r in done]
            n_req, n_steps = spec["requests"], batcher.steps
            del batcher
        else:
            lens = np.full(spec["batch"], spec["prompt"])
            prompts = rng.integers(2, cfg.vocab, size=(
                spec["batch"], spec["prompt"])).astype(np.int32)
            out = generate(model, params, prompts, max_new=spec["new"],
                           extra=frames)
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t_run
            outs = list(out.cpu().numpy())
            n_req, n_steps = spec["batch"], spec["new"] - 1
    finally:
        moe_mod.route, fdm.flash_decode_call = real["route"], real["fd"]
        model.prefill, model.decode_step = real["prefill"], real["decode"]
    launches = {name: mod.launch_count() for name, mod in mods.items()}
    n_windowed = fdm.windowed_launch_count()
    for r, o in enumerate(outs):
        check(len(o) == spec["new"] and bool(((o >= 0) & (o < cfg.vocab))
                                              .all()),
              f"{arch} request {r}: {len(o)} tokens")
    check(launches["flash_decode"] == per_step * n_steps
          and n_windowed == windowed * n_steps,
          f"{arch}: B5 launched {launches['flash_decode']} times "
          f"({n_windowed} windowed) in {n_steps} decode steps of "
          f"{per_step} ({windowed} windowed)")
    check(per_step == 0 or launches["flash_decode"] >= 1,
          f"{arch}: B5 was not launched")
    check(all(name in recorded for name in want.values()),
          f"{arch}: B5 calls {sorted(want.values())} were not recorded")
    keep.update(recorded)
    step = np.asarray(step_ms)
    n_tok = n_req * spec["new"]
    res = dict(prefill_ms_per_request=float(sum(prefill_ms) / n_req),
               prompt_tokens=int(lens.sum()), decode_steps=n_steps,
               step_ms_mean=float(step.mean()),
               step_ms_p50=float(np.median(step)),
               tokens_per_s=n_tok / t_run, b5_launches=launches[
                   "flash_decode"], b5_windowed=n_windowed)
    if busy.get("device_ms", 0) > 0:
        res["device_ms_step"] = busy["device_ms"]
        res["idle_share"] = 1.0 - busy["device_ms"] / float(np.median(step))
    if cfg.family == "moe":
        res["moe_dropped_share"] = 1.0 - routes[1] / max(routes[0], 1)
    log(f"{arch}: {n_req} requests, prompts {int(lens.min())}.."
        f"{int(lens.max())} tokens, {spec['new']} new each, {n_steps} "
        f"decode steps in {t_run:.2f} s = {res['tokens_per_s']:.1f} tokens/s"
        f" end to end; prefill {res['prefill_ms_per_request']:.2f} ms per "
        f"request ({len(prefill_ms)} prefill calls); decode step mean "
        f"{res['step_ms_mean']:.3f} ms, p50 {res['step_ms_p50']:.3f} ms; "
        f"B5 launches {launches['flash_decode']} ({n_windowed} windowed) = "
        f"{per_step} x {n_steps} steps"
        + (f" ({cfg.n_layers} self + {cfg.n_layers} cross a step)"
           if cfg.n_enc_layers else ""))
    if "idle_share" in res:
        log(f"{arch}: decode step {FAMILY_PROFILE_STEP} under torch."
            f"profiler: device busy {busy['device_ms']:.3f} ms in "
            f"{busy['kernels']} kernels, {res['idle_share']:.3f} of the "
            f"median step idle; top kernels (ms): {busy['top']}")
    else:
        log(f"{arch}: no device time recorded; idle share not measured")
    if "moe_dropped_share" in res:
        log(f"{arch}: capacity dropped {res['moe_dropped_share']:.4f} of "
            f"{routes[0]} token-expert assignments")

    # decode held to a forward.  A MoE decode step (<= 8 tokens) drops no
    # assignment, while a forward over a whole prompt may (its capacity
    # is 1.25x the mean load): the check runs the model with a capacity
    # that keeps every assignment, in its prefill, decode and forward, and
    # forces the prefill's and decode's experts on the forward (RouteTape)
    tape = None
    if cfg.family == "moe":
        model = build_model(dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k))
        tape = RouteTape(torch, moe_mod, cfg.n_layers, N_FORWARD)
    if cfg.family in ("ssm", "hybrid"):
        toks = torch.as_tensor(prompts[:2, :REPLAY], device=dev).long()
        held = hold_layers(torch, model, params, toks, arch)
        worst, d = held["worst"], held["drift"]
        res["free_drift_last_block"] = d[-1]
        log(f"{arch}: decode stack run free vs the forward, relative "
            f"divergence of the hidden states after blocks 1, 2, 4, 8, "
            f"...: {[round(d[i - 1], 5) for i in (1, 2, 4, 8, 16, 32, 64) if i <= len(d)]}"
            f", after the last ({len(d)}) {d[-1]:.4f}")
        log(f"{arch}: decode vs forward, {len(d)} blocks each fed the "
            f"forward's input (2 rows x {REPLAY} steps from position 0): "
            f"max |diff| / |row| {worst:.4f} (tolerance {LOGIT_TOL}); "
            f"largest element |diff| / rms(row) {held['elem']:.4f}")
    else:
        pr = list(prompts[:N_FORWARD])
        with tape or contextlib.nullcontext():
            worst, checked, ties = hold_to_forward(
                torch, model, params, pr, spec["new"],
                max(len(p) for p in pr) + spec["new"], arch,
                None if frames is None else frames[:N_FORWARD],
                tape and tape.on_forward)
        how = (f"{N_FORWARD} requests x {spec['new']} steps after their "
               f"prefill")
        if tape:
            how += (f", the forwards routed as the prefill and decode were "
                    f"({tape.flips} of {tape.total} assignments are "
                    f"near-ties the forward picks otherwise)")
            res["moe_route_flips"] = tape.flips / max(tape.total, 1)
        log(f"{arch}: decode vs forward ({how}): max |diff| / rms(row) "
            f"{worst:.4f} (tolerance {LOGIT_TOL}); argmax equal at all "
            f"{checked} steps whose top-2 gap exceeds it ({ties} near-tie "
            f"steps differ)")
    res["decode_vs_forward_rel"] = worst
    return dict(launches=launches, numbers=res)


def main_families(torch, dev, seed: int, keep: dict) -> dict:
    """Phase 7b: every family of FAMILIES in turn, each model freed before
    the next.  Returns the phase's launches of every kernel and each
    family's numbers."""
    launches, numbers = {}, {}
    for arch, spec in FAMILIES:
        r = main_family(torch, dev, arch, spec, seed, keep)
        for name, c in r["launches"].items():
            launches[name] = launches.get(name, 0) + c
        numbers[arch] = r["numbers"]
        gc.collect()
        torch.cuda.empty_cache()
    log(f"generation families launches: {launches}")
    return dict(launches=launches, numbers=numbers)


def train_flops(model, n_params: int, batch: int, seq: int) -> dict:
    """Model FLOPs of one train step of a decoder LM (an estimate): 6 x
    parameters x tokens (forward and backward; the tied unembedding is
    the one product of the vocab table), the attention products over the
    (query, key) pairs each layer's causal window lets through (forward
    4 x heads x hd a pair, backward twice that), and remat's second
    forward of every layer body."""
    cfg = model.cfg
    tokens = batch * seq
    q = seq
    pairs = 0
    for w in model.windows:
        if w < 0:
            pairs += q * (q + 1) // 2
        else:
            full = min(q, w + 1)
            pairs += full * (full + 1) // 2 + (q - full) * (w + 1)
    attn_fwd = 4 * cfg.n_heads * cfg.hd * pairs * batch
    body = n_params - cfg.vocab * cfg.d_model - cfg.d_model
    remat = (2 * body * tokens + attn_fwd) if (
        cfg.remat and cfg.remat_policy != "none") else 0
    total = 6 * n_params * tokens + 3 * attn_fwd + remat
    return dict(total=total, dense=6 * n_params * tokens,
                attention=3 * attn_fwd, remat=remat)


def _family_batch(cfg, seed: int) -> dict:
    import numpy as np
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, size=(4, 32)),
         "labels": rng.integers(-1, cfg.vocab, size=(4, 32))}
    if cfg.n_enc_layers:
        b["frames"] = rng.normal(size=(4, cfg.n_frames, cfg.d_model)
                                 ).astype(np.float32)
    if cfg.n_patches:
        b["patches"] = rng.normal(size=(4, cfg.n_patches, cfg.d_model)
                                  ).astype(np.float32)
    return b


def train_families(torch, dev, seed: int) -> dict:
    """Phase 9b: each family's smoke config in fp32 (remat on), its loss
    and gradients on the card held to the same on the CPU, then one train
    step on the card.  Returns the worst relative differences."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 loss_and_grads,
                                                 make_train_step)
    from repro_torch.training.tree import leaves, tree_map
    worst = {}
    for arch in TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32", remat=True)
        model = build_model(cfg)
        cpu_p = init_params(model.param_specs(), seed=seed, device="cpu")
        batch = _family_batch(cfg, seed + 90)
        out = {}
        for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
            p = tree_map(lambda t: t.to(d, copy=True), cpu_p)
            b = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
            loss, grads = loss_and_grads(model, p, b)
            out[name] = (float(loss), [g.cpu() for g in leaves(grads)])
            if name == "card":
                state, m = make_train_step(model, OptConfig())(
                    init_train_state(p), b)
                check(all(bool(torch.isfinite(t).all())
                          for t in leaves(state["params"]))
                      and math.isfinite(float(m["loss"])),
                      f"9b {arch}: the train step on the card is not "
                      f"finite")
        (l0, g0), (l1, g1) = out["cpu"], out["card"]
        loss_rel = abs(l1 - l0) / abs(l0)
        grad_rel = max(float((a - b).abs().max())
                       / max(float(a.abs().max()), 1e-30)
                       for a, b in zip(g0, g1))
        log(f"9b {arch} ({cfg.family}, fp32 smoke): loss card {l1:.6f} cpu "
            f"{l0:.6f} (rel {loss_rel:.2e}); worst gradient leaf "
            f"{grad_rel:.2e} of its max")
        check(loss_rel <= TRAIN_LOSS_RTOL, f"9b {arch}: loss differs from "
              f"the CPU's by {loss_rel:.2e} > {TRAIN_LOSS_RTOL}")
        check(grad_rel <= TRAIN_GRAD_RTOL, f"9b {arch}: a gradient differs "
              f"from the CPU's by {grad_rel:.2e} x its max > "
              f"{TRAIN_GRAD_RTOL}")
        worst[arch] = dict(loss_rel=loss_rel, grad_rel=grad_rel)
    return worst


def train_resume(torch, dev) -> dict:
    """Phase 9c: ``launch.train --smoke`` on the card for RESUME_STEPS
    steps with a checkpoint every RESUME_EVERY, the last checkpoint
    restored onto the card and held to its manifest's sha256, then a
    second run from it: the same batches bit for bit, losses within
    RESUME_LOSS_RTOL."""
    import hashlib
    import shutil
    import tempfile
    from repro_torch.launch import train as launch_train
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.tree import leaves_with_paths
    tmp = tempfile.mkdtemp(prefix="train-resume-")
    try:
        argv = ["--smoke", "--device", str(dev), "--steps",
                str(RESUME_STEPS), "--ckpt-every", str(RESUME_EVERY),
                "--ckpt-dir", tmp, "--log-every", str(RESUME_EVERY)]
        first = launch_train.main(argv)
        cm = CheckpointManager(tmp)
        last = cm.available_steps()[-1]
        check(first["resumed_from"] is None and last == RESUME_STEPS - RESUME_EVERY,
              f"9c: checkpoints {cm.available_steps()}")
        restored, manifest = cm.restore(first["state"])
        n_leaves = 0
        for path, t in leaves_with_paths(restored):
            key = "/".join(str(p) for p in path)
            check(t.device == dev, f"9c: {key} restored on {t.device}")
            h = t.detach().cpu().contiguous()
            if h.dtype == torch.bfloat16:
                h = h.view(torch.int16)
            check(hashlib.sha256(h.numpy().tobytes()).hexdigest()
                  == manifest["leaves"][key]["sha256"],
                  f"9c: {key} restored on the card differs from the saved "
                  f"bytes")
            n_leaves += 1
        second = launch_train.main(argv)
        check(second["resumed_from"] == last,
              f"9c: resumed from {second['resumed_from']}, not {last}")
        after = sorted(second["losses"])
        check(after == list(range(last + 1, RESUME_STEPS)),
              f"9c: the resumed run trained steps {after}")
        worst = 0.0
        for s in after:
            check(second["batches"][s] == first["batches"][s],
                  f"9c: the resumed run's batch {s} differs")
            worst = max(worst, abs(second["losses"][s] - first["losses"][s])
                        / abs(first["losses"][s]))
        log(f"9c resume: {n_leaves} leaves restored on the card equal their "
            f"sha256; resumed at step {last} (data cursor "
            f"{manifest['extra']['data_step']}), batches {after} equal bit "
            f"for bit, losses within {worst:.2e} relative "
            f"({[round(second['losses'][s], 5) for s in after]} vs "
            f"{[round(first['losses'][s], 5) for s in after]})")
        check(worst <= RESUME_LOSS_RTOL, f"9c: resumed losses differ by "
              f"{worst:.2e} > {RESUME_LOSS_RTOL}")
        return dict(loss_rel=worst, leaves=n_leaves, resumed_from=last)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_breakdown(torch, model, state, batch, oc) -> dict:
    """Phase 9a's step in parts, CUDA events over 3 calls each: the
    forward with its loss (no autograd: no remat), the forward and
    backward (remat's second forward in it), AdamW with the clip over the
    gradients that gives, and the cross entropy alone (forward and
    backward over logits of the step's shape)."""
    from repro_torch.models.losses import cross_entropy
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_step import loss_and_grads
    params = state["params"]
    with torch.no_grad():
        fwd = cuda_ms(torch, lambda: model.loss(params, batch), 3, 1)
        fwd_ops = profile_tick(torch, lambda: model.loss(params, batch),
                               tries=PROFILE_TRIES)
    fwd_bwd = cuda_ms(torch, lambda: loss_and_grads(model, params, batch),
                      3, 1)
    _, grads = loss_and_grads(model, params, batch)
    # (repeated updates move the state on; the checks after this read
    # only state equality between two copies of it)
    opt = cuda_ms(torch, lambda: adamw_update(params, grads, state["opt"],
                                              oc), 3, 1)
    del grads
    b, s = batch["tokens"].shape
    logits = torch.randn((b, s, model.cfg.vocab), device=params[
        "final_norm"].device).to(torch.bfloat16).requires_grad_()
    ce = cuda_ms(torch, lambda: torch.autograd.grad(
        cross_entropy(logits, batch["labels"]), logits), 3, 1)
    return dict(forward_ms=fwd, forward_backward_ms=fwd_bwd,
                adamw_ms=opt, cross_entropy_ms=ce,
                forward_device_ms=fwd_ops["device_ms"],
                forward_kernels=fwd_ops["kernels"],
                forward_ops=fwd_ops["ops"])


def main_training(torch, dev, seed: int) -> dict:
    """Phase 9: the training path.  (a) TRAIN_ARCH at its published width
    in bf16 on the synthetic stream: TRAIN_WARMUP steps, TRAIN_STEPS
    timed by CUDA events, one traced, then one accum-2 step against the
    accum-1 step on one batch from the same state; (b) each family's
    smoke step on the card against the CPU; (c) the launcher's resume."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model, count_params, init_params
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    from repro_torch.training.tree import tree_map
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    n_par = count_params(model.param_specs())
    t0 = time.perf_counter()
    state = init_train_state(init_params(model.param_specs(), seed=seed,
                                         device=dev))
    torch.cuda.synchronize()
    oc = OptConfig(lr=TRAIN_LR)
    log(f"9a {TRAIN_ARCH}: {n_par} parameters in {cfg.dtype}, remat "
        f"{cfg.remat_policy if cfg.remat else 'none'}, drawn on the card "
        f"in {time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}; AdamW with OptConfig defaults but lr {oc.lr} "
        f"({oc.schedule}, warmup {oc.warmup_steps}, wd {oc.weight_decay}, "
        f"clip {oc.grad_clip})")
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=seed))
    batches = [to_device(pipe.batch(i), dev)
               for i in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
    step = make_train_step(model, oc)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP):
        state, m = step(state, batches[i])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(TRAIN_STEPS):
        state, m = step(state, batches[TRAIN_WARMUP + i])
        losses.append(m["loss"])
        ev[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TRAIN_STEPS)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    mean_ms = sum(step_ms) / TRAIN_STEPS
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (mean_ms / 1e3)
    fl = train_flops(model, n_par, TRAIN_BATCH, TRAIN_SEQ)
    rate = fl["total"] / (mean_ms / 1e3)
    log(f"9a losses: {[round(v, 4) for v in losses]}")
    check(all(math.isfinite(v) for v in losses), "9a: a loss is not finite")
    check(losses[-1] < losses[0], f"9a: the loss did not fall "
          f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    # one more step traced: the device's share of it
    traced = TRAIN_WARMUP + TRAIN_STEPS
    busy = profile_tick(torch, lambda: step(state, batches[traced]),
                        tries=PROFILE_TRIES)
    idle = 1.0 - busy["device_ms"] / mean_ms if busy["device_ms"] else None
    log(f"9a {TRAIN_ARCH} train step: {mean_ms:.2f} ms mean by CUDA events "
        f"(min {min(step_ms):.2f}, max {max(step_ms):.2f}; host clock "
        f"{host_ms:.2f} ms a step; the {TRAIN_WARMUP} warm-up steps "
        f"{warm_s:.1f} s), {tok_s:,.0f} tokens/s, peak device memory "
        f"{peak:.2f} GiB; traced step: {fmt_ms(busy['device_ms'], 2)} of "
        f"device time in {busy['kernels']} kernels, idle share "
        f"{fmt_share(idle)}; top kernels (ms): {busy['top']}; top "
        f"operators by their own device time (ms): {busy['ops']}")
    log(f"9a model FLOPs a step (estimate): {fl['total'] / 1e12:.2f} "
        f"TFLOP (6 N D {fl['dense'] / 1e12:.2f}, attention "
        f"{fl['attention'] / 1e12:.2f}, remat forward "
        f"{fl['remat'] / 1e12:.2f}); {rate / 1e12:.1f} TFLOP/s = "
        f"{rate / PEAK_BF16_FLOPS:.3f} of the {PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s bf16 dense peak (bound {fl['total'] / PEAK_BF16_FLOPS * 1e3:.1f} "
        f"ms) on {smi_line()}")
    parts = train_breakdown(torch, model, state, batches[traced], oc)
    log(f"9a the step in parts (CUDA events): forward + loss without "
        f"autograd {parts['forward_ms']:.2f} ms, forward + backward "
        f"{parts['forward_backward_ms']:.2f} ms, AdamW with the clip "
        f"{parts['adamw_ms']:.2f} ms; the cross entropy alone (forward + "
        f"backward over [{TRAIN_BATCH}, {TRAIN_SEQ}, {cfg.vocab}] bf16 "
        f"logits) {parts['cross_entropy_ms']:.2f} ms; the traced forward: "
        f"{fmt_ms(parts['forward_device_ms'], 2)} of device time in "
        f"{parts['forward_kernels']} kernels, top operators (ms) "
        f"{parts['forward_ops']}")
    # accum 2 against accum 1: one batch, the same state (a copy)
    twin = {"params": tree_map(torch.clone, state["params"]),
            "opt": tree_map(torch.clone, state["opt"])}
    b = to_device(pipe.batch(traced + 1), dev)
    _, m1 = step(state, b)
    t0 = time.perf_counter()
    _, m2 = make_train_step(model, oc, 2)(twin, b)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    accum_s = time.perf_counter() - t0
    del twin, m2
    rel = abs(l2 - l1) / abs(l1)
    log(f"9a accum 2 vs 1 on one batch: {l2:.5f} vs {l1:.5f} (rel "
        f"{rel:.2e}; the accum-2 step {accum_s * 1e3:.0f} ms host clock)")
    check(rel <= TRAIN_ACCUM_RTOL, f"9a: accum 2 loss {l2} vs accum 1 {l1}")
    res = dict(step_ms=mean_ms, step_ms_min=min(step_ms),
               step_ms_max=max(step_ms), host_ms=host_ms, tokens_per_s=tok_s,
               peak_gib=peak, device_ms=busy["device_ms"],
               kernels=busy["kernels"], idle_share=idle,
               tflops=rate / 1e12, peak_share=rate / PEAK_BF16_FLOPS,
               losses=losses, accum_rel=rel, **parts)
    del state, batches, b
    gc.collect()
    torch.cuda.empty_cache()
    res["families"] = train_families(torch, dev, seed)
    res["resume"] = train_resume(torch, dev)
    return res


def start_dryrun() -> tuple:
    """Start the production dry run of DRYRUN_CELL in a subprocess (fake
    tensors on the host, no card: ``CUDA_VISIBLE_DEVICES`` is empty), its
    log in a temporary file; returns ``(process, log path, record path)``."""
    import tempfile
    from repro_torch.launch.dryrun import cell_path
    arch, shape, mesh = DRYRUN_CELL
    path = cell_path(arch, shape, mesh)
    if os.path.exists(path):
        os.remove(path)
    fd, log_path = tempfile.mkstemp(prefix="dryrun-", suffix=".log")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(HERE, "src"))
    with os.fdopen(fd, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh], cwd=HERE, env=env,
            stdout=out, stderr=subprocess.STDOUT)
    return proc, log_path, path


def mesh_compression(torch, dev, seed: int) -> dict:
    """10a: one TRAIN_ARCH step's gradients at phase 9's shape, compressed
    and all-reduced (``compressed_psum``) over the one-rank NCCL group,
    twice (the second with the first's residuals as errors); q, scale and
    residual of every leaf, the mean and the new errors held bit for bit
    to the same function on the CPU over a gloo group; then timed."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model, init_params
    from repro_torch.training.compression import (compress_residual,
                                                  compressed_psum,
                                                  init_error_state)
    from repro_torch.training.train_step import loss_and_grads
    from repro_torch.training.tree import leaves, tree_map
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    params = init_params(model.param_specs(), seed=seed, device=dev)
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=seed))
    _, grads = loss_and_grads(model, params, to_device(pipe.batch(0), dev))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    n_par = sum(g.numel() for g in leaves(grads))
    g_dt = {str(g.dtype) for g in leaves(grads)}

    def bits(t):
        t = t.cpu()
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def same(a, b) -> bool:
        return all(torch.equal(bits(x), bits(y))
                   for x, y in zip(leaves(a), leaves(b)))

    cpu_g = tree_map(lambda t: t.cpu(), grads)
    n_q = 0
    for g, c in zip(leaves(grads), leaves(cpu_g)):
        got = compress_residual(g.float())
        want = compress_residual(c.float())
        check(all(torch.equal(bits(x), bits(y)) for x, y in zip(got, want)),
              "10a: q, scale or residual differ from the CPU's")
        n_q += 1
    gloo = dist.new_group(backend="gloo")
    avg1, err1 = compressed_psum(grads, init_error_state(grads))
    avg2, err2 = compressed_psum(grads, err1)
    c_avg1, c_err1 = compressed_psum(cpu_g, init_error_state(cpu_g),
                                     group=gloo)
    c_avg2, c_err2 = compressed_psum(cpu_g, c_err1, group=gloo)
    check(same(avg1, c_avg1) and same(err1, c_err1) and same(avg2, c_avg2)
          and same(err2, c_err2),
          "10a: compressed_psum on the card differs from the CPU's")
    fb = max(float((a.cpu() + e.cpu() - g.float()).abs().max())
             for a, e, g in zip(leaves(avg1), leaves(err1), leaves(cpu_g)))
    del avg1, avg2, err2, c_avg1, c_err1, c_avg2, c_err2, cpu_g
    gc.collect()
    ms = cuda_ms(torch, lambda: compressed_psum(grads, err1), COMPRESS_ITERS)
    # read the gradient and the error, write q, the residual and the mean
    nbytes = sum(g.numel() * (g.element_size() + 4 + 1 + 4 + 4)
                 for g in leaves(grads))
    bound = nbytes / PEAK_BYTES * 1e3
    log(f"10a compressed_psum over {TRAIN_ARCH}'s gradients ({n_par:,} "
        f"parameters in {len(leaves(grads))} leaves, {sorted(g_dt)}; one "
        f"NCCL rank): q, scale and residual of {n_q} leaves and two steps' "
        f"means and errors equal the CPU's bit for bit; mean + error - "
        f"gradient at most {fb:.3e}; {ms:.3f} ms a call by CUDA events "
        f"({COMPRESS_ITERS} calls) against a byte bound of {bound:.3f} ms "
        f"({nbytes / 1e9:.2f} GB at {PEAK_BYTES / 1e12:.2f} TB/s: "
        f"{bound / ms:.3f} of it) on {smi_line()}")
    dist.destroy_process_group(gloo)
    return dict(ms=ms, bound_ms=bound, bytes=nbytes, params=n_par,
                leaves=len(leaves(grads)))


def mesh_dtensor_step(torch, dev, seed: int) -> dict:
    """10b: MESH_ARCHS' smoke configs in fp32, under each of MESH_VARIANTS,
    one train step as DTensors placed by the sharding rules (ZeRO-1
    moments) on a 1 x 1 ("data", "model") mesh of ``dev`` with the mesh
    hints registered and ``dtensor_fallbacks`` (the attention regroups
    sharded heads), against the plain step from the same state and
    batch: loss, parameters and moments equal bit for bit (one rank holds
    every shard whole)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.distributed.hints import use_mesh_hints
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  distribute_tree,
                                                  opt_state_shardings,
                                                  params_shardings)
    from repro_torch.launch.dryrun import dtensor_fallbacks
    from repro_torch.launch.perf import VARIANTS
    from repro_torch.models import build_model, init_params
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import leaves, tree_map
    mesh = DeviceMesh(dev.type, [[0]], mesh_dim_names=("data", "model"))

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    out = {}
    for arch in MESH_ARCHS:
        for variant in MESH_VARIANTS:
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype="float32", **VARIANTS[variant])
            model = build_model(cfg)
            specs = model.param_specs()
            params = init_params(specs, seed=seed, device=dev)
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in _family_batch(cfg, seed + 91).items()}
            step = make_train_step(model, OptConfig())
            clone = lambda t: tree_map(torch.clone, t)  # noqa: E731
            plain, pm = step({"params": clone(params),
                              "opt": init_opt_state(params)}, batch)
            pspec = params_shardings(specs, mesh, cfg)
            state = {"params": distribute_tree(clone(params), pspec, mesh),
                     "opt": distribute_tree(init_opt_state(params),
                                            opt_state_shardings(
                                                pspec, mesh, specs), mesh)}
            dbatch = distribute_tree(batch, batch_shardings(mesh, batch),
                                     mesh)
            with use_mesh_hints(mesh), implicit_replication(), \
                    dtensor_fallbacks():
                dist_state, dm = step(state, dbatch)
            pairs = list(zip(leaves(plain), leaves(dist_state)))
            equal = all(torch.equal(a.view(torch.int32),
                                    local(b).view(torch.int32))
                        if a.dtype == torch.float32 else torch.equal(
                            a, local(b)) for a, b in pairs)
            lp, ld = float(pm["loss"]), float(local(dm["loss"]))
            log(f"10b {arch} ({variant}): DTensor step loss {ld:.7f}, plain "
                f"{lp:.7f}; {len(pairs)} state leaves equal bit for bit: "
                f"{equal}")
            check(equal and lp == ld, f"10b {arch} ({variant}): the DTensor "
                  f"step differs from the plain step")
            out[f"{arch}/{variant}"] = lp
    return out


def mesh_dryrun(torch, train: dict, dry: tuple) -> dict:
    """10c: phase 9's cell (TRAIN_ARCH, train, TRAIN_BATCH x TRAIN_SEQ)
    dry-run on one fake rank, its peak estimate beside phase 9's measured
    peak (``fits_hbm`` must agree with the step having run); then the
    production record DRYRUN_CELL from the subprocess ``dry``."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import compile_cell, fake_world
    from repro_torch.launch.mesh import HW
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"10c the card's memory: {total:,} bytes "
        f"(torch.cuda.get_device_properties(0).total_memory; HW.HBM_BYTES "
        f"{HW.HBM_BYTES:,.0f}) on {smi_line()}")
    t0 = time.perf_counter()
    with fake_world(1):
        mesh = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
        rec = compile_cell(get_config(TRAIN_ARCH), ShapeSpec(
            "phase9", "train", TRAIN_SEQ, TRAIN_BATCH), mesh)
    m = rec["memory"]
    est = m["peak_per_device_bytes"] / 2**30
    log(f"10c dry run of phase 9's cell ({TRAIN_ARCH}, train, {TRAIN_BATCH}"
        f" x {TRAIN_SEQ}, one rank; {time.perf_counter() - t0:.1f} s on the "
        f"host): peak {est:.2f} GiB (arguments "
        f"{m['argument_bytes'] / 2**30:.2f}, temporaries "
        f"{m['temp_bytes'] / 2**30:.2f}, aliased "
        f"{m['alias_bytes'] / 2**30:.2f}) against phase 9's measured "
        f"{train['peak_gib']:.2f} GiB (max_memory_allocated): ratio "
        f"{est / train['peak_gib']:.4f}; fits_hbm {m['fits_hbm']}; "
        f"{rec['cost']['flops'] / 1e12:.2f} TFLOP counted")
    check(m["fits_hbm"], "10c: the dry run says phase 9's step does not "
          "fit, but it ran")
    proc, log_path, path = dry
    try:
        proc.wait(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"10c: the {DRYRUN_CELL} dry run did not end in "
             f"{DRYRUN_WAIT_S:.0f} s")
    with open(log_path) as f:
        tail = f.read()[-2000:]
    os.remove(log_path)
    check(proc.returncode == 0 and os.path.exists(path),
          f"10c: the {DRYRUN_CELL} dry run failed: {tail}")
    with open(path) as f:
        prod = json.load(f)
    check(prod["status"] == "ok", f"10c: {DRYRUN_CELL}: {prod.get('error')}")
    pm, ro = prod["full"]["memory"], prod["roofline"]
    log(f"10c production record {'/'.join(DRYRUN_CELL)} on "
        f"{prod['chips']} fake ranks (H100 constants of HW): accum tried "
        f"{prod['accum']}; peak per device {pm['peak_per_device_bytes'] / 1e9:.2f} GB"
        f" (arguments {pm['argument_bytes'] / 1e9:.2f}, temporaries "
        f"{pm['temp_bytes'] / 1e9:.2f}), fits_hbm {pm['fits_hbm']}; "
        f"collectives {prod['full']['collectives']['total'] / 1e9:.2f} GB in "
        f"{prod['full']['collectives']['count']} ops; roofline compute "
        f"{ro['compute_s']:.4f} s, memory {ro['memory_s']:.4f} s, "
        f"collective {ro['collective_s']:.4f} s: {ro['bottleneck']}-bound, "
        f"useful ratio {ro['useful_ratio']:.3f}")
    return dict(peak_est_gib=est, peak_measured_gib=train["peak_gib"],
                ratio=est / train["peak_gib"], total_memory=total,
                production=dict(peak_gb=pm["peak_per_device_bytes"] / 1e9,
                                fits_hbm=pm["fits_hbm"], **ro))


def main_mesh(torch, dev, seed: int, train: dict, dry: tuple) -> dict:
    """Phase 10: 10a and 10b over a one-rank NCCL process group (a
    ``FileStore`` in a temporary directory: no network), then 10c."""
    import shutil
    import tempfile
    import torch.distributed as dist
    root = tempfile.mkdtemp(prefix="cubegraph-10-")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(root, "store"), 1), rank=0, world_size=1,
        device_id=dev)
    try:
        res = {"compression": mesh_compression(torch, dev, seed)}
        gc.collect()
        torch.cuda.empty_cache()
        res["dtensor"] = mesh_dtensor_step(torch, dev, seed)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    res["dryrun"] = mesh_dryrun(torch, train, dry)
    return res


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
    load_peaks()
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
    dry = start_dryrun()
    try:
        return main_path(torch, dev, dry, errs, t_start)
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].wait()


def main_path(torch, dev, dry: tuple, errs: dict, t_start: float) -> int:
    """Phases 3-10 and the result lines."""
    b1 = importlib.import_module("repro_torch.kernels.filtered_topk")
    b2 = importlib.import_module("repro_torch.kernels.distance")

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
    snap_root = tempfile.mkdtemp(prefix="cubegraph-5c-")
    try:
        with Phase("5c durability and tiering", torch):
            # the phase resets every count just before it and reads it after
            for name, c in main_durability(torch, dev, keep, QUERIES,
                                           snap_root).items():
                launches[name] += c
        with Phase("5e shard mesh", torch):
            # the phase resets every count just before it and reads it after
            mesh_run = main_shard_mesh(torch, dev, keep, snap_root, SEED)
    finally:
        shutil.rmtree(snap_root, ignore_errors=True)
    for name, c in mesh_run["launches"].items():
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
            f"{fmt_ms(mm['device_ms'])}, library "
            f"{fmt_ms(mm['library_device_ms'])}; bound {mm['bound_ms']:.4f} "
            f"ms ({mm['bound_by']})")
    g = keep["generation"]
    log(f"generation: prefill {g['prefill_ms_mean']:.2f} ms per request, "
        f"decode {g['decode_tick_ms_mean']:.3f} ms per tick (p50 "
        f"{g['decode_tick_ms_p50']:.3f}), {g['tokens_per_s']:.1f} tokens/s "
        f"end to end, decode vs forward {g['decode_vs_forward_rel']:.4f} x "
        f"rms")

    # ---- the generation families, each model freed before the next -----
    keep.clear()
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("7b generation families", torch):
        # each family resets every count just before it and reads it after
        fams = main_families(torch, dev, SEED, keep)
    for name, c in fams["launches"].items():
        launches[name] += c
    with Phase("7b measure (B5 windowed, global and hd 80)", torch):
        b5_fam = {name: measure_b5(torch, keep[name], f"{arch} decode step "
                                   f"{FAMILY_RECORD_STEP}, B5 call {j + 1}",
                                   errs)
                  for arch, j, name in FAMILY_RECORDS}
        for name, mm in b5_fam.items():
            log(f"flash_decode {name} at {mm['shape']}: kernel "
                f"{mm['ms']:.4f} ms, library {mm['library_ms']:.4f} ms, twin "
                f"{mm['plain_ms']:.4f} ms; device time kernel "
                f"{fmt_ms(mm['device_ms'])}, library "
                f"{fmt_ms(mm['library_device_ms'])}; bound "
                f"{mm['bound_ms']:.4f} ms ({mm['bound_by']})")

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

    # ---- the training path, after the serving tier's tensors go --------
    keep.clear()
    gc.collect()
    torch.cuda.empty_cache()
    mods = _kernel_mods(generation=True)
    for mod in mods.values():
        mod.reset_launch_count()
    with Phase("9 training", torch):
        train = main_training(torch, dev, SEED)
    log(f"phase 9 launches of B1-B5 (the training path reaches no hand "
        f"kernel): { {n: m.launch_count() for n, m in mods.items()} }; "
        f"gemma3-1b {train['step_ms']:.2f} ms a step, "
        f"{train['tokens_per_s']:,.0f} tokens/s, peak "
        f"{train['peak_gib']:.2f} GiB, idle "
        f"{fmt_share(train['idle_share'])}, "
        f"{train['peak_share']:.3f} of the bf16 peak (estimate)")

    # ---- mesh utilities, compression and the dry run -------------------
    gc.collect()
    torch.cuda.empty_cache()
    for mod in mods.values():
        mod.reset_launch_count()
    with Phase("10 mesh and compression", torch):
        mesh = main_mesh(torch, dev, SEED, train, dry)
    log(f"phase 10 launches of B1-B5 (no hand kernel on this path): "
        f"{ {n: m.launch_count() for n, m in mods.items()} }; "
        f"compressed_psum {mesh['compression']['ms']:.3f} ms (bound "
        f"{mesh['compression']['bound_ms']:.3f}); dry-run peak / measured "
        f"{mesh['dryrun']['ratio']:.4f}")
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
            # phase 7b: gemma3's windowed and global layers, zamba2's hd 80
            fam_keys = ("ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "device_ms", "library_device_ms",
                        "max_abs_err", "keys", "shape")
            for key in ("windowed", "hd80"):
                entry[key] = {k: b5_fam[key][k] for k in fam_keys}
            entry["windowed"]["global"] = {k: b5_fam["global"][k]
                                           for k in fam_keys}
            nums = fams["numbers"]
            entry["windowed"]["launches"] = nums["gemma3-1b"]["b5_windowed"]
            entry["hd80"]["launches"] = nums["zamba2-2.7b"]["b5_launches"]
            entry["families"] = nums
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
        if name in mesh_run["per_card"]:
            # phase 5e: launches by CUDA device index on the shard mesh
            entry["mesh"] = {"cards": mesh_run["cards"],
                             "launches_per_card": mesh_run["per_card"][name]}
            if name == "filtered_topk":
                entry["mesh"]["scan_1m"] = mesh_run["scan"]
            if name == "graph_step":
                entry["mesh"]["hop_ms"] = mesh_run["hop"]
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
