"""The readers of the spans inside the int8 rerank and the merge, and of
the program's copy and rerank counters, on inputs counted by hand; each
reads nothing where the program has no such span or counter (as a
program without them would hand it)."""
import numpy as np
import pytest

from portbench.devtrace import WINDOW, DeviceTrace
from portbench.readings import Readings
from portbench.spec import load_benchmark, metric_reader

NEW = ("rerank_lookup_ms.hostpaced", "rerank_upload_ms.hostpaced",
       "rerank_unique_share.hostpaced", "merge_topk_ms", "h2d_mb_per_batch",
       "h2d_mb_per_batch.hostpaced")


def _batch(lookup, upload, merge_topk):
    return {"name": "query", "ms": 400.0, "spans": [
        {"name": "sealed_scan", "ms": 360.0, "spans": [
            {"name": "queries_upload", "ms": 5.0},
            {"name": "bucket_dispatch", "ms": 30.0, "spans": [
                {"name": "bucket_fetch", "ms": 2.0}]},
            {"name": "rerank_fp32", "ms": 300.0, "spans": [
                {"name": "rerank_lookup", "ms": lookup},
                {"name": "rerank_upload", "ms": upload},
                {"name": "rerank_score", "ms": 20.0},
                {"name": "rerank_topk", "ms": 5.0}]}]},
        {"name": "merge", "ms": 10.0, "spans": [
            {"name": "merge_topk", "ms": merge_topk},
            {"name": "alive_filter", "ms": 1.0}]}]}


def _readings(spans, counters):
    return Readings(spans=spans, counters=counters, trace=None,
                    window={"qps": 25000.0, "p95_ms": 500.0, "seconds": 20.0,
                            "ops": 1e12}, bound_s=0.01,
                    ingest_rows_per_s=2000.0)


# two batches of 10,000 queries at d 768: the scan's and the rerank's
# queries 30,720,000 B each a batch, 60,000 rows looked up (184,320,000 B)
COUNTERS = {
    'h2d_bytes_total{site="scan_queries"}': 2 * 30_720_000.0,
    'h2d_bytes_total{site="rerank_queries"}': 2 * 30_720_000.0,
    'h2d_bytes_total{site="rerank_rows"}': 2 * 60_000 * 3_072.0,
    'h2d_bytes_total{site="delta"}': 0.0,
    'h2d_bytes_total{site="other"}': 2 * 1_600_000.0,
    "query_batches_total": 2.0, "query_rows_total": 20_000.0,
    "rerank_candidates_total": 2 * 400_000.0,
    "rerank_rows_total": 2 * 60_000.0,
}


def test_new_readers_on_counted_inputs():
    r = _readings([_batch(180.0, 60.0, 8.0), _batch(200.0, 70.0, 9.0)],
                  dict(COUNTERS))
    assert metric_reader("rerank_lookup_ms.hostpaced")(r) == \
        pytest.approx(190.0)
    assert metric_reader("rerank_upload_ms.hostpaced")(r) == \
        pytest.approx(65.0)
    assert metric_reader("merge_topk_ms")(r) == pytest.approx(8.5)
    # 60,000 rows of 400,000 candidates
    assert metric_reader("rerank_unique_share.hostpaced")(r) == \
        pytest.approx(15.0)
    # (30.72 + 30.72 + 184.32 + 1.6) MB a batch
    for name in ("h2d_mb_per_batch", "h2d_mb_per_batch.hostpaced"):
        assert metric_reader(name)(r) == pytest.approx(247.36)
    # the metrics read before keep their spans
    assert metric_reader("rerank_ms")(r) == pytest.approx(300.0)
    assert metric_reader("merge_ms")(r) == pytest.approx(10.0)


def test_new_readers_read_nothing_without_their_spans_or_counters():
    # what a program without the spans and counters hands the readers
    bare = {"name": "query", "ms": 400.0, "spans": [
        {"name": "sealed_scan", "ms": 360.0, "spans": [
            {"name": "rerank_fp32", "ms": 300.0}]},
        {"name": "merge", "ms": 10.0}]}
    r = _readings([bare, bare], {"query_batches_total": 2.0,
                                 "query_rows_total": 20_000.0})
    for name in NEW:
        assert metric_reader(name)(r) is None, name
    assert metric_reader("rerank_ms")(r) == pytest.approx(300.0)
    # counters present, but no batch or no candidate to divide by
    r = _readings([bare], {**COUNTERS, "query_batches_total": 0.0,
                           "rerank_candidates_total": 0.0})
    for name in ("h2d_mb_per_batch", "rerank_unique_share.hostpaced"):
        assert metric_reader(name)(r) is None, name


def test_new_entries_are_reported_in_their_cells():
    bench = load_benchmark()
    entries = {p["name"]: p for p in bench["per_layer"]}
    for name in NEW:
        cells = entries[name]["workloads"]
        assert cells == (["int8.wide"] if name.endswith(".hostpaced")
                         else ["fp32.wide"]), name


def test_idle_gaps_fall_under_the_innermost_new_span():
    ms = 1_000_000
    ranges = [(WINDOW, 0, 100 * ms), ("query", 0, 100 * ms),
              ("rerank_fp32", 10 * ms, 60 * ms),
              ("rerank_lookup", 10 * ms, 40 * ms),
              ("rerank_upload", 40 * ms, 50 * ms),
              ("rerank_score", 50 * ms, 58 * ms),
              ("rerank_topk", 58 * ms, 60 * ms),
              ("merge", 70 * ms, 90 * ms),
              ("merge_topk", 70 * ms, 88 * ms),
              ("alive_filter", 88 * ms, 90 * ms)]
    # a copy inside the upload, a kernel inside the score
    ops = [("Memcpy HtoD", 42 * ms, 48 * ms), ("graph_step", 52 * ms, 56 * ms)]
    gaps = dict(DeviceTrace(ops, ranges).idle_gaps())
    assert gaps["rerank_lookup"] == pytest.approx(0.030)
    assert gaps["rerank_upload"] == pytest.approx(0.004)
    assert gaps["rerank_score"] == pytest.approx(0.004)
    assert gaps["merge_topk"] == pytest.approx(0.018)
    assert "rerank_fp32" not in gaps and "merge" not in gaps


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_readers_find_what_the_program_records(quantize):
    """A traced query of the port on the CPU, read as the benchmark reads
    a traced window: every new reader of the cell's kind finds a number."""
    import torch

    from repro_torch.core import BoxFilter, CubeGraphConfig
    from repro_torch.streaming import SegmentManager, StreamConfig
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    n, d, m = 1500, 16, 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    s = rng.random((n, m))
    s[:, 2] = np.arange(n) / n
    mgr = SegmentManager(d, m, StreamConfig(
        time_dim=2, seal_max_points=400, n_shards=2, quantize=quantize,
        index_cfg=CubeGraphConfig(n_layers=2, m_intra=8, m_cross=3)),
        device="cpu")
    mgr.ingest(x, s)
    box = BoxFilter(lo=np.array([0.0, 0.0, 0.1], np.float32),
                    hi=np.array([1.0, 1.0, 1.0], np.float32))
    q = x[:100] + 0.01
    before = dict(mgr.obs.registry.snapshot()["counters"])
    spans = [mgr.query(q, box, k=10, return_trace=True)[-1].to_dict()
             for _ in range(2)]
    after = dict(mgr.obs.registry.snapshot()["counters"])
    r = _readings(spans, {k: v - before.get(k, 0.0)
                          for k, v in after.items()})
    names = [n for n in NEW if n.endswith(".hostpaced") == bool(quantize)]
    for name in names:
        value = metric_reader(name)(r)
        assert value is not None and value > 0, name
    # at least the queries of the scan (and of the rerank) every batch
    ups = 2 if quantize else 1
    assert metric_reader(names[-1])(r) >= ups * q.nbytes / 1e6
