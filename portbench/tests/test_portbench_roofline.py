"""The roofline's counts on shapes counted by hand, and the trace reading
behind the device metrics."""
import pytest

from portbench import peaks
from portbench.devtrace import WINDOW, DeviceTrace
from portbench.readings import Readings, ms_per_batch
from portbench.spec import metric_reader


def test_scan_counts_by_hand():
    # 10,000 queries x 45,000 passing rows x d 768: 2 * 3.456e11 operations
    assert peaks.scan_ops(10_000 * 45_000, 768) == 6.912e11
    assert peaks.scan_bytes(45_000, 768, 4) == 138_240_000
    assert peaks.scan_bytes(45_000, 768, 1) == 34_560_000
    bound = peaks.scan_bound_s(10_000 * 45_000, 45_000, 768, 4)
    assert bound == pytest.approx(6.912e11 / 67e12)          # compute-bound
    # one query: the bytes bound it
    assert peaks.scan_bound_s(45_000, 45_000, 768, 4) == pytest.approx(
        138_240_000 / 3.35e12)


def _trace():
    ns = 1_000_000                      # 1 ms
    ops = [("b1", 10 * ns, 30 * ns), ("merge", 30 * ns, 32 * ns),
           ("b1", 60 * ns, 80 * ns), ("early", 0, 6 * ns)]
    ranges = [(WINDOW, 5 * ns, 105 * ns),
              ("query", 5 * ns, 50 * ns), ("bucket_dispatch", 8 * ns, 33 * ns),
              ("merge", 40 * ns, 48 * ns),
              ("query", 55 * ns, 100 * ns),
              ("bucket_dispatch", 58 * ns, 70 * ns)]
    return DeviceTrace(ops, ranges)


def test_device_trace_busy_spans_and_gaps():
    dt = _trace()
    assert dt.window_s == pytest.approx(0.100)
    # 1 ms of "early" inside the window, 20 + 2 + 20 ms of the rest
    assert dt.busy_s == pytest.approx(0.043)
    # b1 10-30 and merge 30-32 inside 8-33; the second b1 only 60-70
    assert dt.device_s_within("bucket_dispatch") == pytest.approx(0.032)
    assert dt.top_ops(2) == [["b1", pytest.approx(0.040)],
                             ["merge", pytest.approx(0.002)]]
    gaps = dict((k, v) for k, v in dt.idle_gaps())
    # idle 6-10 (query 6-8, bucket_dispatch 8-10), 32-60 (bucket_dispatch
    # 32-33, query 33-40, merge 40-48, query 48-50, host 50-55, query
    # 55-58, bucket_dispatch 58-60), 80-105 (query 80-100, host 100-105)
    assert gaps["query"] == pytest.approx(0.002 + 0.007 + 0.002 + 0.003
                                          + 0.020)
    assert gaps["bucket_dispatch"] == pytest.approx(0.002 + 0.001 + 0.002)
    assert gaps["merge"] == pytest.approx(0.008)
    assert gaps["host"] == pytest.approx(0.005 + 0.005)
    assert sum(gaps.values()) == pytest.approx(dt.window_s - dt.busy_s)


def _readings(trace, bound_s=0.016):
    spans = [{"name": "query", "ms": 50.0, "spans": [
        {"name": "sealed_scan", "ms": 30.0, "spans": [
            {"name": "bucket_dispatch", "ms": 25.0},
            {"name": "rerank_fp32", "ms": 4.0}]},
        {"name": "merge", "ms": 8.0}]},
        {"name": "query", "ms": 45.0, "spans": [
            {"name": "sealed_scan", "ms": 12.0}, {"name": "merge", "ms": 2.0}]}]
    counters = {'planner_decision_total{mode="scan"}': 6.0,
                "query_batches_total": 2.0}
    return Readings(spans=spans, counters=counters, trace=trace,
                    window={"qps": 1000.0, "p95_ms": 50.0, "seconds": 2.0,
                            "ops": 6.7e12}, bound_s=bound_s,
                    ingest_rows_per_s=5000.0)


def test_readers_on_counted_inputs():
    r = _readings(_trace())
    assert ms_per_batch(r, "sealed_scan") == pytest.approx(21.0)
    assert ms_per_batch(r, "rerank_fp32") == pytest.approx(2.0)
    assert ms_per_batch(r, "graph_rerank") is None
    assert metric_reader("rerank_ms")(r) == pytest.approx(2.0)
    assert metric_reader("merge_ms")(r) == pytest.approx(5.0)
    assert metric_reader("scan_roofline")(r) == pytest.approx(50.0)
    assert metric_reader("device_idle_pct")(r) == pytest.approx(57.0)
    assert metric_reader("query_mfu")(r) == pytest.approx(5.0)
    assert metric_reader("ingest_rows_per_s")(r) == 5000.0
    assert metric_reader("qps.hostpaced")(r) == 1000.0
    assert metric_reader("query_p95_ms.hostpaced")(r) == 50.0
    # a host-paced twin reads as its base metric
    assert metric_reader("merge_ms.hostpaced")(r) == pytest.approx(5.0)


def test_roofline_reads_nothing_where_the_planner_chose_the_graph():
    r = _readings(_trace())
    r.counters['planner_decision_total{mode="graph"}'] = 2.0
    assert metric_reader("scan_roofline")(r) is None
    assert metric_reader("sealed_scan_ms")(r) == pytest.approx(21.0)


def test_device_readers_read_nothing_without_a_device_trace():
    r = _readings(None)
    for name in ("scan_roofline", "device_idle_pct"):
        assert metric_reader(name)(r) is None
    r = _readings(_trace(), bound_s=0.0)
    assert metric_reader("scan_roofline")(r) is None
