#!/usr/bin/env python3
"""Time kernels B1, B4 and B5 of one source tree of the PyTorch/CUDA port
on one CUDA card, for A/B comparisons of two trees in one machine.

    python3 tools/kernel_ab.py --tree .            # this checkout
    python3 tools/kernel_ab.py --tree build/parent # e.g. an unpacked
                                                   # `git archive` of a parent

It imports ``repro_torch`` from ``<tree>/src`` (so run one process per
tree, alternating: parent, change, change, parent), builds that tree's
kernels into its own ``build/`` and prints one JSON line with times in
ms, measured with the timers of ``chip_smoke.py`` (CUDA events around
back-to-back calls after a warm-up, or device time under torch.profiler),
of:

- ``b1_scan``: B1 at the smoke's scan shape, [1000, 768] queries against
  [1M, 768] fp32 vectors, box filter (ratio 0.1), k = 10;
- ``b1_bucket``: B1 over a delta-kept fp32 bucket [16, 8192, 768] whose
  rows 6..15 are free (``PAD_META``) and whose live rows are time-ordered,
  filtered box-and-interval (t >= 0.6), k = 10; beside it its bound over
  the passing candidates (``b1_bucket_bound_ms``: their products at the
  fp32 peak, or their vectors, all metadata, the queries and the lists at
  the HBM rate, whichever is longer) and a gather-first library call
  computing the same per-row lists (``b1_bucket_gather_library_ms``:
  each row's passing vectors gathered, one batched matmul, one top-k),
  held against B1 first;
- ``b4_hop``: B4 on a synthetic traversal hop at phase 5b's bucket shape:
  the block [16, 8192, 768] (fp32, and int8 codes with [16, 768] scales)
  whose rows 6..15 are free (``PAD_META``), b = 1000 queries drawn near
  live points, c = 512 lanes.  The lanes are drawn with replacement from a
  pool of 36,188 distinct live positions (the distinct rows of the
  middle hop the smoke records), so each row is gathered about 14 times
  across the queries: ``raw`` is every lane (the hop's ``cand``), ``fresh``
  keeps each lane with probability 0.23 (the fresh share of a
  forced-graph read) and sets the rest to -1, as the traversal hands them
  to B4.  ``b4_hop_<fp32|int8>_<raw|fresh>`` are CUDA-event ms,
  ``b4_hop_max_abs_err`` the largest kernel-vs-twin distance difference
  over the four, ``b4_hop_distinct`` the distinct rows of each lane set;
- ``b5_tick``: B5 on a decode tick of internvl2-2b's shape, q [64, 2,
  128], K / V [64, 4096, 128] bf16, lengths drawn like the smoke's
  prompts (1024..3584 tokens) plus 16 decoded; ``b5_tick_device`` is its
  device time alone (the kernels' durations under torch.profiler, so the
  wrapper's host time between launches is not counted) and
  ``sdpa_tick_device`` that of ``scaled_dot_product_attention`` on the
  same inputs.

The card's name and power limit come first, from nvidia-smi.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (PEAK_BYTES, PEAK_FP32_FLOPS,  # noqa: E402
                        compare_topk, cuda_ms, device_ms, smi_line)


def time_b1(torch, np, args, dev, gen, b1, ops, out) -> None:
    """B1 at the scan shape and over a delta-kept bucket, into ``out``."""
    from repro_torch.core import BoxFilter, ComposeFilter, IntervalFilter
    from repro_torch.core.workloads import (make_box_filter,
                                            make_dataset_device)
    # B1 at the scan shape
    n, d, m, nq = 1_000_000, 768, 3, 1000
    x, s = make_dataset_device(n, d, m, seed=args.seed, device=dev)
    idx = torch.randint(0, n, (nq,), generator=gen, device=dev)
    q = x[idx] + 0.05 * torch.randn((nq, d), generator=gen, device=dev)
    kind, params = ops.encode_filter(make_box_filter(m, 0.1, seed=args.seed),
                                     m, mpad=m)
    p = torch.as_tensor(params, device=dev)[None]
    call = (q[None], x[None], s[None], p, kind, 16, "l2")
    out["b1_scan"] = cuda_ms(torch, lambda: b1.filtered_topk_call(*call), 10)

    # B1 over a delta-kept bucket: 6 live rows of 16
    rows, cap, live_rows = 16, 8192, 6
    xb = x[:rows * cap].reshape(rows, cap, d)
    sb = s[:rows * cap].reshape(rows, cap, m).clone()
    sb[:, :, 2] = torch.arange(cap, device=dev) / cap
    sb[live_rows:] = ops.PAD_META
    f = ComposeFilter(BoxFilter(lo=np.asarray([0.2, 0.2, 0.0], np.float32),
                                hi=np.asarray([0.8, 0.8, 1.0], np.float32)),
                      IntervalFilter(dim=2, lo=0.6, hi=1.0), "and")
    kind, params = ops.encode_filter(f, m, mpad=m)
    p = torch.as_tensor(params, device=dev)[None]
    call = (q[None], xb, sb, p, kind, 16, "l2")
    out["b1_bucket"] = cuda_ms(torch, lambda: b1.filtered_topk_call(*call),
                               20)

    # the bucket's bound over its passing candidates, and a gather-first
    # library call computing the same per-row lists: each row's passing
    # vectors gathered (padded to the fullest row), one batched product,
    # one top-k
    from repro_torch.kernels.ref import filter_mask_ref
    k = 10

    def b1_bucket_library():
        ok = filter_mask_ref(sb, kind, p[0])
        cnt = ok.sum(1)
        width = int(cnt.max())              # syncs the host, as nonzero
        col = torch.argsort((~ok).to(torch.uint8), dim=1,
                            stable=True)[:, :width]
        xg = torch.gather(xb, 1, col[..., None].expand(-1, -1, d))
        dm = ((q * q).sum(1)[None, :, None]
              - 2.0 * torch.matmul(q[None], xg.transpose(1, 2))
              + (xg * xg).sum(-1)[:, None, :])
        pad = torch.arange(width, device=dev)[None, :] >= cnt[:, None]
        dd, jj = torch.topk(dm.masked_fill_(pad[:, None, :], float("inf")),
                            k, dim=-1, largest=False)
        return dd, torch.gather(col[:, None, :].expand(-1, nq, -1), 2, jj)
    kd, ki = b1.filtered_topk_call(*call)
    ld, li = b1_bucket_library()
    scale = (q * q).sum(1)[None, :, None] + (xb * xb).sum(-1).max()
    out["b1_bucket_max_abs_err"] = compare_topk(
        torch, kd[..., :k], ki[..., :k], ld, li.int(), scale,
        "B1 on the bucket vs the gather-first library call")
    out["b1_bucket_gather_library_ms"] = cuda_ms(torch, b1_bucket_library,
                                                 5, 1)
    passing = int(filter_mask_ref(sb, kind, p[0]).sum())
    flops = 2.0 * nq * passing * d
    nbytes = 4.0 * (passing * d + rows * cap * m + nq * d) \
        + 8.0 * rows * nq * 16
    out["b1_bucket_pass_share"] = passing / (rows * cap)
    out["b1_bucket_bound_ms"] = max(flops / PEAK_FP32_FLOPS,
                                    nbytes / PEAK_BYTES) * 1e3


def time_b4(torch, np, args, dev, gen, b4, ops, out) -> None:
    """B4 on a synthetic hop at phase 5b's bucket shape, into ``out``."""
    from repro_torch.core import BoxFilter, ComposeFilter, IntervalFilter
    rows, cap, d, m, live_rows, b, c = 16, 8192, 768, 3, 6, 1000, 512
    x = torch.randn((rows, cap, d), generator=gen, device=dev)
    codes = torch.randint(-127, 128, (rows, cap, d), generator=gen,
                          device=dev, dtype=torch.int8)
    scales = 0.01 + 0.02 * torch.rand((rows, d), generator=gen, device=dev)
    s = torch.rand((rows, cap, m), generator=gen, device=dev)
    s[:, :, 2] = torch.arange(cap, device=dev) / cap
    s[live_rows:] = ops.PAD_META
    rng = np.random.default_rng(args.seed + 40)
    pool = torch.as_tensor(rng.choice(live_rows * cap, 36_188,
                                      replace=False), device=dev)
    raw = pool[torch.as_tensor(rng.integers(0, len(pool), (b, c)),
                               device=dev)].to(torch.int32)
    fresh = torch.where(torch.as_tensor(rng.uniform(size=(b, c)) < 0.23,
                                        device=dev), raw, -1)
    q = x.reshape(-1, d)[raw[:, 0].long()] + 0.05 * torch.randn(
        (b, d), generator=gen, device=dev)
    f = ComposeFilter(BoxFilter(lo=np.asarray([0.2, 0.2, 0.0], np.float32),
                                hi=np.asarray([0.8, 0.8, 1.0], np.float32)),
                      IntervalFilter(dim=2, lo=0.6, hi=1.0), "and")
    kind, params = ops.encode_filter(f, m, mpad=m)
    p = torch.as_tensor(params, device=dev)
    err = 0.0
    for name, block, sc in (("fp32", x, None), ("int8", codes, scales)):
        for lanes, pos in (("raw", raw), ("fresh", fresh)):
            call = (q, pos, block, s, p, kind, "l2")
            kd, _ = b4.beam_step_scores(*call, scales=sc)
            td, _ = b4.beam_step_plain(*call, scales=sc)
            live = pos >= 0
            err = max(err, float((kd - td)[live].abs().max()))
            out[f"b4_hop_{name}_{lanes}"] = cuda_ms(
                torch, lambda: b4.beam_step_scores(*call, scales=sc), 20)
    out["b4_hop_max_abs_err"] = err
    out["b4_hop_distinct"] = {
        lanes: int(torch.unique(pos[pos >= 0]).numel())
        for lanes, pos in (("raw", raw), ("fresh", fresh))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", default="b1,b4,b5",
                    help="comma-separated subset of b1, b4, b5")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import ops
    b1 = importlib.import_module("repro_torch.kernels.filtered_topk")
    b4 = importlib.import_module("repro_torch.kernels.graph_topk")
    b5 = importlib.import_module("repro_torch.kernels.flash_decode")
    print(smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    out = {"tree": args.tree}

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    cases = set(args.cases.split(","))
    if "b1" in cases:
        time_b1(torch, np, args, dev, gen, b1, ops, out)
    if "b4" in cases:
        time_b4(torch, np, args, dev, gen, b4, ops, out)
    if "b5" in cases:
        time_b5(torch, np, args, dev, gen, b5, out)
    print(json.dumps(out))
    return 0


def time_b5(torch, np, args, dev, gen, b5, out) -> None:
    """B5 on a decode tick of internvl2-2b's shape, into ``out``."""
    # B5 on a decode tick of internvl2-2b's shape
    slots, n_kv, g, hd, smax = 8, 8, 2, 128, 4096
    rng = np.random.default_rng(args.seed + 70)
    lens = rng.integers(1024, 3585, slots) + 16
    bkv = slots * n_kv
    qd, kd, vd = (torch.randn(shape, generator=gen, device=dev)
                  .to(torch.bfloat16)
                  for shape in ((bkv, g, hd), (bkv, smax, hd),
                                (bkv, smax, hd)))
    lengths = torch.as_tensor(np.repeat(lens, n_kv), dtype=torch.int32,
                              device=dev)
    want = b5.flash_decode_plain(qd, kd, vd, lengths).float()
    got = b5.flash_decode_call(qd, kd, vd, lengths).float()
    out["b5_max_abs_err"] = float((got - want).abs().max())
    out["b5_filled"] = int((lengths.long() + 1).sum())
    out["b5_tick"] = cuda_ms(
        torch, lambda: b5.flash_decode_call(qd, kd, vd, lengths), 50, 5)
    out["b5_tick_device"] = device_ms(
        torch, lambda: b5.flash_decode_call(qd, kd, vd, lengths), 50)
    import torch.nn.functional as F
    ql = qd.view(slots, n_kv * g, 1, hd)
    kl, vl = kd.view(slots, n_kv, smax, hd), vd.view(slots, n_kv, smax, hd)
    mask = (torch.arange(smax, device=dev)[None, :]
            <= lengths.view(slots, n_kv)[:, :1].long())[:, None, None, :]
    out["sdpa_tick_device"] = device_ms(
        torch, lambda: F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask, enable_gqa=True), 50)


if __name__ == "__main__":
    sys.exit(main())
