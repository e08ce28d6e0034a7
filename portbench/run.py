"""Run one cell of the port's benchmark once, and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``src/repro_torch``.  The run
makes the cell's corpus and traffic from ``--seed`` on the card, ingests
the corpus through ``repro_torch.streaming.SegmentManager`` as a stream
(set-up), answers the mix's batches in a closed loop for ``--seconds``
(the window), then frees the program and holds every answer against the
plain reference (``reference.py``).  With ``--trace 1`` a second window
of ``TRACED_CYCLES`` passes over the mix's batches runs under
``torch.profiler`` with the program's spans on, and the line carries the
cell's per-layer metrics instead of its end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``breakdown``) and, last, ``checks``: each number compared with its
limit, which are also the last lines of standard error.  Without a card
(or with fewer than the cell asks for), outside such a checkout, or with
the JAX package loaded, the run exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from . import spec  # noqa: E402
from .guard import forbidden_modules  # noqa: E402

PROFILE_TRIES = 3       # a profiler session can come back without a device
TRACED_CYCLES = 2       # pool cycles in the traced window


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def use_checkout_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels under ``build/repro_torch_kernels``)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")


def _closed_loop(mgr, pool, filters, k: int, seconds: float,
                 traced: bool = False, cycles: int = 1) -> dict:
    """One client: the next batch goes out when the last answer is in.
    Batches cycle the pool; the window closes at the end of the first
    whole cycle that ends after ``seconds`` (and after ``cycles`` cycles),
    so every pool batch counts alike in the rate, the tail and the
    recall."""
    lat: List[float] = []
    answers = []
    spans = []
    i = 0
    t_open = time.perf_counter()
    stop = t_open + seconds
    while True:
        t0 = time.perf_counter()
        j = i % len(pool)
        if t0 >= stop and j == 0 and i >= cycles * len(pool):
            break
        out = mgr.query(pool[j].queries, filters[j], k=k,
                        return_trace=traced)
        lat.append(time.perf_counter() - t0)
        answers.append((j, out[0], out[1]))
        if traced:
            spans.append(out[-1].to_dict())
        i += 1
    return {"seconds": time.perf_counter() - t_open, "latency_s": lat,
            "answers": answers, "spans": spans}


def _counters(mgr) -> Dict[str, float]:
    return dict(mgr.obs.registry.snapshot()["counters"])


def _profiled(torch, on_card: bool, fn):
    """``fn()`` under ``torch.profiler`` inside a ``portbench.window``
    range; made again (up to ``PROFILE_TRIES`` times) while the trace holds
    no device operation.  Returns ``(results of every try, DeviceTrace or
    None)``: the last try's trace, None off the card or when none held a
    device operation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .devtrace import WINDOW, DeviceTrace
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    done = []
    for attempt in range(PROFILE_TRIES):
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                done.append(fn())
            if on_card:
                torch.cuda.synchronize()
        dt = DeviceTrace.from_profile(prof)
        del prof
        if not on_card:
            return done, None
        if dt.busy_s > 0:
            return done, dt
        log(f"profiler session {attempt + 1}: no device operation in the "
            "trace; tracing again")
    return done, None


def stream_config(cfg: dict):
    """The configuration's ``StreamConfig`` (``index_cfg`` given as the
    fields of a ``CubeGraphConfig``)."""
    from repro_torch.core import CubeGraphConfig
    from repro_torch.streaming import StreamConfig
    stream = dict(cfg["stream"])
    if "index_cfg" in stream:
        stream["index_cfg"] = CubeGraphConfig(**stream["index_cfg"])
    return StreamConfig(**stream)


def _work(torch, corpus, alive, pool, cfg) -> List[dict]:
    """Per pool batch, from the benchmark's own data: the live rows inside
    its box, and those that are surely sealed (all but the newest
    ``seal_max_points`` rows, which the delta buffer may hold)."""
    from . import reference
    sealed = torch.zeros_like(alive)
    sealed[: max(corpus.n - int(cfg["stream"]["seal_max_points"]), 0)] = True
    out = []
    for bt in pool:
        inside = alive & reference.in_box(corpus.meta, bt.lo, bt.hi)
        out.append({"rows": int(inside.sum()),
                    "sealed_rows": int((inside & sealed).sum()),
                    "batch": bt.queries.shape[0]})
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda:0", t_start: Optional[float] = None,
             program_query=None) -> dict:
    """One run of ``cell``; returns the result object.  ``program_query``
    (tests only) replaces ``SegmentManager.query`` to plant a fault in the
    timed path."""
    import torch

    from repro_torch.core import BoxFilter
    from repro_torch.streaming import SegmentManager

    from . import data, generator, judge, peaks, stats
    from .readings import Readings

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg, k = cell.config, int(cell.config["k"])
    d, m = int(cfg["d"]), int(cfg["m"])
    if on_card:
        torch.cuda.set_device(dev)

    corpus = data.make_corpus(cfg, seed, dev)
    deleted = data.pick_deletes(corpus, cfg, seed)
    alive = data.live_mask(corpus, deleted)
    live_rows = int(alive.sum())
    pool = generator.make_pool(cell.traffic, cfg, corpus, seed)
    filters = [BoxFilter(lo=bt.lo, hi=bt.hi) for bt in pool]
    mem0 = torch.cuda.memory_allocated(dev) if on_card else 0

    mgr = SegmentManager(d, m, stream_config(cfg), device=dev)
    if program_query is not None:
        mgr.query = program_query.__get__(mgr)
    batch = int(cfg["ingest_batch"])
    t0 = time.perf_counter()
    for lo in range(0, corpus.n, batch):
        mgr.ingest(corpus.x_host[lo:lo + batch], corpus.s_host[lo:lo + batch])
        mgr.maintenance()
    if on_card:
        torch.cuda.synchronize(dev)
    ingest_s = time.perf_counter() - t0
    mgr.delete(deleted)
    log(f"set-up: ingested {corpus.n} rows in {ingest_s:.3f} s, deleted "
        f"{len(deleted)}; the benchmark's live rows {live_rows}, the "
        f"program's {mgr.n_live}")
    for j, bt in enumerate(pool):                  # warm every batch shape
        mgr.query(bt.queries, filters[j], k=k)
    if on_card:
        torch.cuda.synchronize(dev)
    mem1 = torch.cuda.memory_allocated(dev) if on_card else 0
    bytes_per_row = (mem1 - mem0) / live_rows
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; device bytes held by the program "
        f"{mem1 - mem0} ({bytes_per_row:.1f} per live row)")

    gc.collect()
    gc.freeze()
    main = _closed_loop(mgr, pool, filters, k, seconds)
    windows = [main]
    readings = None
    if trace:
        def traced_window():
            before = _counters(mgr)
            w = _closed_loop(mgr, pool, filters, k, 0.0, traced=True,
                             cycles=TRACED_CYCLES)
            after = _counters(mgr)
            w["counters"] = {n: after[n] - before.get(n, 0.0) for n in after}
            return w
        traced, dtrace = _profiled(torch, on_card, traced_window)
        tw = traced[-1]
        for w in traced:
            w["label"] = "traced window"
        windows += traced
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    work = _work(torch, corpus, alive, pool, cfg)
    elem = peaks.ELEM_BYTES[cfg["stream"].get("quantize")]
    n_main = len(main["latency_s"])
    qps = stats.rate(sum(work[j]["batch"] for j, _, _ in main["answers"]),
                     main["seconds"])
    p95_ms = 1e3 * stats.percentile(main["latency_s"], 95)
    log(f"window: {n_main} batches in {main['seconds']:.3f} s; "
        f"query_p95_ms over {n_main} batch latency samples")
    if trace:
        bound_s = sum(peaks.scan_bound_s(
            work[j]["batch"] * work[j]["sealed_rows"], work[j]["sealed_rows"],
            d, elem) for j, _, _ in tw["answers"])
        ops = sum(peaks.scan_ops(work[j]["batch"] * work[j]["rows"], d)
                  for j, _, _ in main["answers"])
        readings = Readings(
            spans=tw["spans"], counters=tw["counters"], trace=dtrace,
            window={"qps": qps, "p95_ms": p95_ms,
                    "seconds": main["seconds"], "ops": ops},
            bound_s=bound_s, ingest_rows_per_s=corpus.n / ingest_s)

    # the program's state goes before the reference runs
    del mgr
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    truths = {}
    tallies = []
    for w in windows:
        tally = judge.Tally()
        for j, g, dd, count in judge.unique_answers(w["answers"]):
            if j not in truths:
                bt = pool[j]
                truths[j] = judge.truth_for(corpus.x, corpus.meta, alive,
                                            bt.queries, bt.lo, bt.hi, k)
            judge.judge_answer(tally, corpus.x, truths[j], g, dd, count)
        tallies.append(tally)
        log(f"{w.get('label', 'window')}: recall@{k} {tally.recall!r} over "
            f"{tally.rows} queries, {tally.numbers()}")
    numbers = {n: max(t.numbers()[n] for t in tallies)
               for n in ("dist_err", "rank_gap", "miss_share")}
    numbers["bad_answers"] = float(sum(t.bad_rows for t in tallies))
    correct, checks = judge.verdict(numbers, cell.limits)
    for name in judge.NUMBERS:
        if name not in checks:
            log(f"not compared: {name} {numbers[name]!r}")

    e2e = {"qps": qps, "query_p95_ms": p95_ms,
           "recall_at_10": tallies[0].recall,
           "device_bytes_per_row": bytes_per_row, "setup_s": setup_s}
    metrics = {}
    if not trace:
        for e in cell.end_to_end:
            metrics[e["name"]] = {"value": e2e[e["name"]], "unit": e["unit"]}
    else:
        for p in cell.per_layer:
            value = spec.metric_reader(p["name"])(readings)
            if value is not None:
                metrics[p["name"]] = {"value": value, "unit": p["unit"]}

    result = {
        "correct": bool(correct),
        "attempted": int(sum(t.rows for t in tallies)),
        "failed": int(sum(t.bad_rows for t in tallies)),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else dev.type),
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"]["busy_s"] = dtrace.busy_s if dtrace else 0.0
        result["device"]["window_s"] = (dtrace.window_s if dtrace
                                        else tw["seconds"])
        if dtrace is not None:
            result["breakdown"] = {"device_ops": dtrace.top_ops(10),
                                   "idle_gaps": dtrace.idle_gaps(10)}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = spec.ROOT
    if not (root / "src" / "repro_torch" / "__init__.py").exists():
        log(f"no src/repro_torch under {root}: not a checkout of the port")
        return 4
    cell = spec.load_cell(args.workload, root)
    use_checkout_caches(root)
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark measures the card and prints no "
            "result without one")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards; "
            f"{torch.cuda.device_count()} visible")
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    found = forbidden_modules()
    if found:
        log(f"the process holds forbidden modules: {', '.join(found)}")
        return 5
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
