"""The p95 and rate arithmetic over every raw sample, a stall included."""
import statistics

import pytest

from portbench import stats


def test_p95_is_nearest_rank_over_all_samples_with_a_stall():
    lat = [10.0] * 190 + [11.0] * 9 + [500.0]      # one stall in 200
    assert stats.percentile(lat, 95) == 10.0
    lat = [10.0] * 180 + [20.0] * 10 + [500.0] * 10
    # ten samples beyond the 95th: the stall is the tail
    assert stats.percentile(lat, 95) == 20.0
    assert stats.percentile(lat, 96) == 500.0
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_counts_all_work_over_all_time():
    assert stats.rate(40000, 2.0) == 20000.0
    # a stalled batch still counts its queries and its seconds
    assert stats.rate(4 * 10000, 0.25 * 3 + 5.0) == pytest.approx(6956.5217)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_uses_python_quartiles():
    vals = [100.0, 101.0, 99.0, 100.5, 98.0, 102.0]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)
