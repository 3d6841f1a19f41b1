"""The traffic generator: the Poisson schedule and the size mix drawn
from a seed, the same work for every seed."""
import statistics

import pytest

from perfbench import generator, spec

POISSON = spec.cell(spec.load(), "resnet18-poisson").traffic


def test_schedule_is_a_function_of_the_seed():
    a = generator.open_schedule(POISSON, 20.0, 2**31 + 5)
    b = generator.open_schedule(POISSON, 20.0, 2**31 + 5)
    c = generator.open_schedule(POISSON, 20.0, 6)
    assert a == b and a != c


def test_every_seed_gets_the_same_sizes_and_gaps_in_another_order():
    seconds = 20.0
    a = generator.open_schedule(POISSON, seconds, 1)
    b = generator.open_schedule(POISSON, seconds, 2)
    assert sorted(r.images for r in a) == sorted(r.images for r in b)

    def gaps(s):
        t = [0.0] + [r.due_s for r in s]
        return sorted(round(y - x, 9) for x, y in zip(t, t[1:]))
    assert gaps(a) == gaps(b)


def test_rate_sizes_and_tenants():
    seconds = 20.0
    s = generator.open_schedule(POISSON, seconds, 3)
    assert len(s) == round(POISSON["rate_rps"] * seconds)
    assert all(0 < x.due_s < seconds for x in s)
    assert [x.due_s for x in s] == sorted(x.due_s for x in s)
    sizes = [x.images for x in s]
    # one image with probability 1/2, else 2..8 alike: a mean of 3
    assert sizes.count(1) == len(s) // 2
    assert statistics.mean(sizes) == pytest.approx(3.0, abs=0.05)
    assert {x.tenant for x in s} == {0, 1, 2}
    assert [x.tenant for x in s[:4]] == [0, 1, 2, 0]
    # exponential gaps: their spread equals their mean
    t = [0.0] + [x.due_s for x in s]
    g = [y - x for x, y in zip(t, t[1:])]
    assert statistics.stdev(g) == pytest.approx(statistics.mean(g), rel=0.1)


@pytest.mark.parametrize("rate", [1.0, 96.0, 160.0])
def test_one_request_at_each_arrival(rate):
    s = generator.open_schedule(dict(POISSON, rate_rps=rate), 10.0, 9)
    assert len(s) == max(1, round(rate * 10.0))
    due = [x.due_s for x in s]
    assert all(a < b for a, b in zip(due, due[1:]))


def test_quotas_and_pool_offsets():
    assert generator.quotas([7, 1, 1, 1, 1, 1, 1, 1], 14) == [7] + [1] * 7
    assert sum(generator.quotas([1, 2, 3], 10)) == 10
    assert generator.pool_offsets([3, 5, 8], 8) == [0, 3, 0]
