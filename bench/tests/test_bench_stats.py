"""Percentiles over all requests."""
import statistics

import numpy as np
import pytest

import tiny  # noqa: F401  (sys.path)
from harness.stats import percentile


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_is_numpys_over_all_values(q):
    rng = np.random.default_rng(3)
    x = rng.lognormal(size=157)
    assert percentile(list(x), q) == pytest.approx(np.percentile(x, q))


def test_tail_is_over_all_requests_not_chunks():
    # ten chunks of ten: one slow chunk holds every slow request
    x = [1.0] * 90 + [10.0] * 10
    chunks = [x[i:i + 10] for i in range(0, 100, 10)]
    of_chunks = statistics.median(percentile(c, 90) for c in chunks)
    assert of_chunks == 1.0
    assert percentile(x, 90) == pytest.approx(1.9)
    assert percentile(x, 95) == 10.0
