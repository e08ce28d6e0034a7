#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, started together), holds each kernel against its plain
PyTorch twin, then drives the port's main path at deployment widths
(d = 768) — the exact filtered scan over 1M vectors, a CubeGraph index
built and queried on the card, and the default streaming
``SegmentManager`` — and checks the answers against exact ground truth.
Finally it times each kernel beside its twin, its roofline bound and one
PyTorch library call computing the same function.

The last three lines of standard output are the card's name and power
limit (from ``nvidia-smi``), a JSON object describing every kernel, and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
those lines; so does a machine without a CUDA card, or a directory that
does not hold the port's sources.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import os
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
SEED = 0


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


def main_index(torch, dev, n: int, d: int, nq: int, seed: int) -> None:
    """CubeGraph index built on the card and queried with both planners;
    ground truth from the exact scan."""
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


def main_stream(torch, dev, n: int, d: int, nq: int, seed: int) -> None:
    """Default streaming SegmentManager: time-ordered ingest with seals,
    sync and async compaction, delete, TTL expiry, filtered queries."""
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
    for name, f in filters.items():
        before = b1.launch_count()
        t0 = time.perf_counter()
        gids, dd, stats = mgr.query(q, f, k=k, ef=128, return_stats=True)
        dt = time.perf_counter() - t0
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
            f"launches {scans}")
        check(r >= 0.8, f"stream {name}: recall {r:.4f} < 0.8")


def measure(torch, keep: dict, nq: int, d: int) -> dict:
    """Kernel, twin and library times at the main path's shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.distance import (pairwise_dist_call,
                                              pairwise_dist_plain)
    from repro_torch.kernels.filtered_topk import (filtered_topk_call,
                                                   filtered_topk_plain)
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
    flops = 2.0 * nq * n * d
    nbytes = 4.0 * (n * d + n * m + nq * d + 4 * m) + 8.0 * nq * kpad
    b1_bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
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
            shape=f"q[{nq},{d}] x[{n},{d}] s[{n},{m}] {kind} k={k}"),
        "pairwise_dist": dict(
            ms=b2_ms, plain_ms=b2_plain, library_ms=b2_lib,
            bound_ms=b2_bound, bound_by="operations"
            if flops2 / PEAK_FP32_FLOPS >= bytes2 / PEAK_BYTES else "bytes",
            shape=f"q[{nq},{d}] x[{npd},{d}] fp32 l2"),
    }


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
            lines = [ln for ln in logs.get(name, "").splitlines()
                     if "ptxas" in ln]
            log(f"[{name}] " + ("\n[{name}] ".format(name=name).join(lines)
                                if lines else "already built"))
    errs = {"filtered_topk": 0.0, "pairwise_dist": 0.0}
    with Phase("2 kernels vs twins", torch):
        phase_kernels(torch, dev, SEED, errs)
    if args.kernels_only:
        return 0

    # ---- the main path: counts are read only around these phases -------
    b1.reset_launch_count()
    b2.reset_launch_count()
    keep: dict = {}
    with Phase("3 exact filtered scan", torch):
        main_scan(torch, dev, N_SCAN, D, QUERIES, SEED, errs, keep)
    with Phase("4 index", torch):
        main_index(torch, dev, N_INDEX, D, QUERIES, SEED)
    with Phase("5 streaming", torch):
        main_stream(torch, dev, N_STREAM, D, QUERIES, SEED)
    launches = {"filtered_topk": b1.launch_count(),
                "pairwise_dist": b2.launch_count()}
    log(f"main-path launches: {launches}")
    for name, c in launches.items():
        check(c >= 1, f"kernel {name} was not launched on the main path")

    with Phase("6 measure", torch):
        meas = measure(torch, keep, QUERIES, D)
        for name, mm in meas.items():
            log(f"{name} at {mm['shape']}: kernel {mm['ms']:.3f} ms, twin "
                f"{mm['plain_ms']:.3f} ms, library {mm['library_ms']:.3f} "
                f"ms, bound {mm['bound_ms']:.3f} ms ({mm['bound_by']})")
    sources = {"filtered_topk": ("src/repro_torch/csrc/filtered_topk.cu",
                                 "src/repro/kernels/filtered_topk.py:131"),
               "pairwise_dist": ("src/repro_torch/csrc/distance.cu",
                                 "src/repro/kernels/distance.py:36")}
    kernels = []
    for name in ("filtered_topk", "pairwise_dist"):
        mm = meas[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": mm["ms"],
            "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
            "bound_by": mm["bound_by"], "library_ms": mm["library_ms"],
            "shape": mm["shape"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
