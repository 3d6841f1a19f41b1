"""A run with the timed path broken underneath comes out not correct,
and the control (the reference with TF32 operands in the program's
place) fails the cell's limit. Each drives the rest of a run on the CPU,
past the harness's look for a chip, on a small net with the cells' own
traffic mixes and limits."""
import math

import pytest
import torch

from perfbench import bench
from perfbench.tests.conftest import tiny_cell

CELLS = ["resnet18-batch8", "resnet18-poisson", "resnet18-single"]


def run(cell, seed=2**31 + 11, control=False):
    return bench.run_cell(cell, seed, 1.0, trace=False,
                          device=torch.device("cpu"), t_start=bench.now(),
                          max_requests=4, control=control)


def stale(step):
    """A step that returns its state unchanged: the last round's outputs
    again."""
    last = {}

    def call(self, params, xs):
        y = step(self, params, xs)
        out = last.get("y", y)
        last["y"] = y
        return out
    return call


def half(step):
    """Half of the round's images left out: their lanes come back zero."""
    def call(self, params, xs):
        y = step(self, params, xs).clone()
        y[xs.shape[0] // 2:xs.shape[0]] = 0
        return y
    return call


def altered(step):
    """One answer altered where it is produced: an element of the first
    lane moved by a hundredth of the round's largest output."""
    def call(self, params, xs):
        y = step(self, params, xs).clone()
        y[0].view(-1)[0] += 0.01 * float(y.abs().max())
        return y
    return call


@pytest.mark.parametrize("fault", [stale, half, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, fault, monkeypatch, one_thread):
    from repro_torch.occam import deploy

    monkeypatch.setattr(deploy._RoundStep, "__call__",
                        fault(deploy._RoundStep.__call__))
    r = run(tiny_cell(name))
    assert not r.correct, r.checks


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_the_control_is_not(name, one_thread):
    cell = tiny_cell(name)
    r = run(cell, control=True)
    limit = cell.limits["worst_rel_gap"]
    assert r.correct, r.checks
    assert r.checks["worst_rel_gap"]["value"] < limit / 3
    assert r.control_gap > limit, (r.control_gap, limit)
    assert r.failed == 0 and r.attempted == 4


@pytest.mark.parametrize("name", ["resnet18-batch8", "resnet18-poisson"])
def test_an_answer_never_received_is_not_correct(name, monkeypatch,
                                                 one_thread):
    send, wait_for = bench.ToHost.send, bench.ToHost.wait_for

    def lose(self, key, y, keep):
        if key != 1:
            send(self, key, y, keep)
    monkeypatch.setattr(bench.ToHost, "send", lose)
    monkeypatch.setattr(bench.ToHost, "wait_for", lambda self, key: (
        wait_for(self, key) if key in self._pending else None))
    r = run(tiny_cell(name))
    assert r.checks["missing_answers"]["value"] == 1 and not r.correct
    assert r.failed == 1


def test_a_refused_request_counts_as_failed(monkeypatch, one_thread):
    """A request the engine refuses is attempted, not answered, and left out
    of the answered latencies: the tail counts it as a failure."""
    from repro_torch.occam.serve import engine, queue

    submit, calls = engine.AsyncEngine.submit, []

    async def refuse_third(self, images, *, tenant="default"):
        calls.append(tenant)
        if len(calls) == 3:     # the warm-up's one, then the window's second
            raise queue.AdmissionError(tenant, 0, images.shape[0], 0)
        return await submit(self, images, tenant=tenant)
    monkeypatch.setattr(engine.AsyncEngine, "submit", refuse_third)
    r = run(tiny_cell("resnet18-poisson"))
    assert r.attempted == 4 and r.failed == 1
    assert len(r.latencies_s) == 3
    assert r.correct, r.checks


def test_a_non_finite_answer_is_not_correct(monkeypatch, one_thread):
    from repro_torch.occam import deploy

    step = deploy._RoundStep.__call__

    def nan(self, params, xs):
        y = step(self, params, xs).clone()
        y[0].view(-1)[0] = math.nan
        return y
    monkeypatch.setattr(deploy._RoundStep, "__call__", nan)
    r = run(tiny_cell("resnet18-single"))
    assert r.checks["worst_rel_gap"]["value"] == math.inf
    assert not r.correct


class FakeEvent:
    """A CUDA event that ends only when waited for, at ``ms`` on the
    device's clock."""

    def __init__(self, ms):
        self.ms, self.ended = ms, False

    def query(self):
        return self.ended

    def synchronize(self):
        self.ended = True


class FakeRef:
    def elapsed_time(self, ev):
        return ev.ms


def test_finish_notes_answers_sent_out_of_order():
    """An open loop's answers reach the client in delivery order, not in
    request order; waiting for the last one sent waits for all of them."""
    to_host = bench.ToHost(torch.device("cpu"))
    to_host._ref, to_host._t_ref = FakeRef(), 100.0
    for key, ms in [(3, 1.0), (1, 2.0), (2, 3.0)]:
        to_host._pending[key] = (FakeEvent(ms), torch.zeros(1), key == 1)
    to_host.finish()
    assert not to_host._pending
    assert to_host.done == {3: 100.001, 1: 100.002, 2: 100.003}
    assert set(to_host.kept) == {1}
