"""The metric arithmetic on synthetic timings and intervals."""

import pytest

from harness import stats
from harness.trace import Trace


def test_rate_is_over_the_whole_window():
    assert stats.rate(60, 10.0, 40.0) == pytest.approx(2.0)
    with pytest.raises(ValueError):
        stats.rate(1, 5.0, 5.0)


def test_p95_over_all_samples():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0


def test_union_and_idle():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.idle_share(iv, 0.0, 5.0) == pytest.approx(40.0)
    # intervals reaching past the window count only inside it
    assert stats.idle_share([(-1.0, 1.0), (4.0, 9.0)], 0.0, 5.0) == pytest.approx(60.0)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def test_trace_breakdown():
    dev = [("k4", 0.0, 1.0), ("ring", 1.0, 1.5), ("k4", 3.0, 4.0)]
    host = [("outer", 0.0, 5.0), ("sync", 1.6, 2.9)]
    tr = Trace(dev, host, (0.0, 5.0))
    assert tr.busy_s == pytest.approx(2.5) and tr.window_s == 5.0
    assert tr.top_device_ops() == [["k4", 2.0], ["ring", 0.5]]
    gaps = dict(tr.top_idle_gaps())
    assert gaps == {"sync": pytest.approx(1.5), "outer": pytest.approx(1.0)}
    import re
    assert tr.kernel_seconds(re.compile("k4")) == (2.0, 2)
