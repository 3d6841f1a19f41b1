"""The knee sweep's one test of a sustained rate, and the knee it reads
from a sweep whose verdicts need not be monotone."""
import pytest

from perfbench import sweep


def window(first_ms, last_ms, failed=0, n=300):
    third = n // 3
    lat = ([first_ms / 1e3] * third + [first_ms / 1e3] * (n - 2 * third)
           + [last_ms / 1e3] * third)
    return {"failed": failed, "latencies_s": lat}


@pytest.mark.parametrize("out, ok", [
    (window(28.2, 28.5), True),
    (window(34.8, 54.6), False),        # the backlog grew
    (window(30.0, 44.9), True),
    (window(30.0, 45.0), False),        # 1.5x is not under 1.5x
    (window(28.0, 28.0, failed=2), False),
])
def test_verdict(out, ok):
    assert sweep.verdict(out)[0] is ok


def test_knee_stops_at_the_first_rate_not_sustained():
    assert sweep.knee([(160.0, True), (120.0, True), (140.0, False),
                       (100.0, True)]) == 120.0
    assert sweep.knee([(100.0, False), (120.0, True)]) is None
    assert sweep.knee([(100.0, True), (120.0, True)]) == 120.0
