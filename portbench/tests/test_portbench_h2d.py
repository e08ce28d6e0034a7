"""On the card: the program's ``h2d_bytes_total`` counts every byte the
query path copies to the card.  One traced batch of each configuration
at a small size, profiled: the counters' change equals the ``bytes`` of
the HtoD copies in the profiler's Chrome trace to within 1%, and each
span's ``start_ns`` / ``end_ns`` lies within 1 ms of its
``record_function`` range (``python3 -m pytest -m cuda -s
portbench/tests``)."""
import gc
import json
import time

import numpy as np
import pytest

from portbench import data, generator, run, spec

ROWS = 12_000           # 5 segments of 2,048 sealed, 1,760 in the delta
BATCH = 1_000
TRIES = 3               # a profiler session can come back without a device


def _events(torch, fn, tmp_path):
    """``fn()`` under the profiler; its Chrome trace's events and base.
    A session can lose its first device records, so a few copies and a
    kernel run first, outside any span of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(TRIES):
        gc.disable()               # no collector's pause inside a span
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    torch.ones(256).cuda().add_(1)
                torch.cuda.synchronize()
                time.sleep(0.05)
                out = fn()
                torch.cuda.synchronize()
        finally:
            gc.enable()
        path = tmp_path / f"trace{attempt}.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        events = trace["traceEvents"]
        if any(e.get("cat") == "kernel" for e in events):
            return out, events, int(trace.get("baseTimeNanoseconds", 0))
    pytest.fail("no profiler session held a device event")


def _spans(node, out):
    out.setdefault(node["name"], []).append(node)
    for c in node.get("spans", ()):
        _spans(c, out)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["geo768-fp32", "geo768-int8"])
def test_h2d_counter_matches_the_profiler(card, config, tmp_path):
    import torch

    from repro_torch.core import BoxFilter
    from repro_torch.streaming import SegmentManager
    cfg = spec.load_json(spec.ROOT / "portbench" / "configs"
                         / f"{config}.json")
    seed = 2 ** 31 + 27
    corpus = data.make_corpus(cfg, seed, card, n=ROWS)
    traffic = dict(spec.load_json(spec.HERE / "traffic" / "wide.json"),
                   batch=BATCH, pool=2)
    pool = generator.make_pool(traffic, cfg, corpus, seed)
    mgr = SegmentManager(int(cfg["d"]), int(cfg["m"]),
                         run.stream_config(cfg), device=card)
    step = int(cfg["ingest_batch"])
    for lo in range(0, ROWS, step):
        mgr.ingest(corpus.x_host[lo:lo + step], corpus.s_host[lo:lo + step])
        mgr.maintenance()
    assert mgr.delta.n_live > 0
    # the mix's box, and one over the whole map and span (the delta too)
    filters = [BoxFilter(lo=pool[0].lo, hi=pool[0].hi),
               BoxFilter(lo=np.zeros(3, np.float32),
                         hi=np.full(3, 2.0, np.float32))]
    k = int(cfg["k"])
    for f in filters:                                 # warm every shape
        mgr.query(pool[0].queries, f, k=k)
    torch.cuda.synchronize()
    before = dict(mgr.obs.registry.snapshot()["counters"])
    trees, events, base = _events(torch, lambda: [
        mgr.query(pool[0].queries, f, k=k, return_trace=True)[-1].to_dict()
        for f in filters], tmp_path)
    after = dict(mgr.obs.registry.snapshot()["counters"])
    counted = {n: after[n] - before.get(n, 0.0) for n in after
               if n.startswith("h2d_bytes_total")}
    # the copies inside the queries' own ranges (each copy from pageable
    # memory blocks the host, so it runs inside the range that made it)
    queries = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "query"]
    assert len(queries) == len(filters)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")
              and any(a <= float(e["ts"]) <= b for a, b in queries)]
    traced = sum(int(e["args"]["bytes"]) for e in copies)
    total = sum(counted.values())
    print(f"{config}: h2d_bytes_total {total:.0f} {counted}; the "
          f"profiler's HtoD bytes {traced} in {len(copies)} copies")
    assert counted['h2d_bytes_total{site="delta"}'] > 0
    assert total == pytest.approx(traced, rel=0.01)

    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a = base + float(e["ts"]) * 1e3
            ranges.setdefault(e["name"], []).append(
                (a, a + float(e["dur"]) * 1e3))
    spans = {}
    for t in trees:
        _spans(t, spans)
    worst = 0.0
    for name, nodes in spans.items():
        got = sorted(ranges.get(name, ()))
        assert len(got) == len(nodes), name
        for sp, (a, b) in zip(sorted(nodes, key=lambda s: s["start_ns"]),
                              got):
            worst = max(worst, abs(sp["start_ns"] - a),
                        abs(sp["end_ns"] - b))
    print(f"{config}: spans {sum(map(len, spans.values()))}, the widest "
          f"gap from their profiler ranges {worst / 1e6:.4f} ms "
          f"(torch {torch.__version__})")
    assert worst < 1e6
