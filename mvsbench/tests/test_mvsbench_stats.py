"""The end-to-end arithmetic on synthetic timings."""
import math

import numpy as np
import pytest

from mvsbench import stats


def test_percentile_matches_numpy_on_finite_values():
    rng = np.random.default_rng(0)
    for n in (1, 2, 9, 10, 11, 120):
        xs = list(rng.random(n))
        for q in (50, 90, 99):
            assert stats.percentile(xs, q) == pytest.approx(
                float(np.percentile(xs, q)), rel=1e-12)


def test_rate_and_p90_over_all_requests():
    lat = [0.1] * 90 + [0.2] * 10           # 100 requests in 12 s
    m = stats.serve_metrics(lat, 12.0)
    assert m["maps_per_s"] == pytest.approx(100 / 12.0)
    assert m["request_p90_ms"] == pytest.approx(
        float(np.percentile(lat, 90)) * 1e3)


def test_failed_requests_complete_nothing_and_miss_every_limit():
    lat = [0.1] * 88 + [math.inf] * 12
    m = stats.serve_metrics(lat, 10.0)
    assert m["maps_per_s"] == pytest.approx(8.8)
    assert m["request_p90_ms"] == math.inf
    few = [0.1] * 95 + [math.inf] * 5
    assert stats.serve_metrics(few, 10.0)["request_p90_ms"] == \
        pytest.approx(100.0)


def test_train_rate():
    assert stats.train_metrics(300, 1, 12.5)["train_samples_per_s"] == 24.0
