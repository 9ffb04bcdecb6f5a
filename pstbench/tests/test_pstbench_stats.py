"""The benchmark's fixed arithmetic: percentile, rate, the idle union."""

import numpy as np
import pytest

from pstbench import stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_percentile_is_numpys_linear(q, n):
    v = list(np.random.default_rng(n).exponential(size=n))
    assert stats.percentile(v, q) == pytest.approx(float(np.percentile(v, q)), rel=1e-12)


def test_percentile_takes_every_value():
    # one slow request in 100 moves the p95 of all requests, not a median of chunks
    v = [1.0] * 94 + [50.0] * 6
    assert stats.percentile(v, 95) == pytest.approx(50.0)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate():
    assert stats.rate(2**24 * 100, 0.5) == 2**24 * 200
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_union_and_gaps():
    busy = stats.union([(5, 7), (1, 3), (2, 4), (6, 9), (12, 20)], 0, 15)
    assert busy == [(1, 4), (5, 9), (12, 15)]
    assert stats.gaps(busy, 0, 15) == [(0, 1), (4, 5), (9, 12)]
    assert stats.gaps([], 0, 2) == [(0, 2)]
