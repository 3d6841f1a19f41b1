"""The port's planning frontier (``occam.autoplan`` -> ``Frontier``)
against the reference's: frontier documents equal to the last float over
nets, fleets, dtype policies, tile heights and harmonization; equal
``best`` / ``for_rate`` picks; the checked-in frontier loads unchanged;
re-scored frontiers equal under one cost model, and reference-rescored
documents load; and serve-time autoscaling (``Session.scale``,
``Deployment.reconcile``) never re-runs the DP. Planning is pure Python,
so every comparison here is exact."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import occam as j_occam
from repro.core.graph import chain as j_chain
from repro.models import zoo as j_zoo
from repro_torch import occam
from repro_torch.core.graph import chain
from repro_torch.models import zoo

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
C, P = "conv", "pool"
VGG_MINI = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0),
            (C, 3, 1, 1, 16), (C, 3, 1, 1, 16), (P, 2, 2, 0, 0),
            (C, 3, 1, 1, 16)]
POLICIES = ("fp32", "int8", "bf16")
RATES = {"link_elems_per_s": 2e9, "hbm_elems_per_s": 5e9}


def _nets(name):
    """(port net, reference net) by name; ``vgg_mini`` is the reference
    test suite's 16x16 net."""
    if name == "vgg_mini":
        return (chain("vgg_mini", VGG_MINI, in_h=16, in_w=16, in_ch=3),
                j_chain("vgg_mini", VGG_MINI, in_h=16, in_w=16, in_ch=3))
    return zoo.get_network(name), j_zoo.get_network(name)


def _frontiers(name, fleet_kw, **kw):
    net, j_net = _nets(name)
    return (occam.autoplan(net, occam.Fleet(**fleet_kw), **kw),
            j_occam.autoplan(j_net, j_occam.Fleet(**fleet_kw), **kw))


# (net, fleet, autoplan keywords): a handful of points of the product of
# nets x chips {1, 4, 6} x rates x policies x out_rows x harmonize
GRID = [
    ("alexnet", dict(chips=1, vmem_elems=3_145_728), {}),
    ("alexnet", dict(chips=4, vmem_elems=786_432, **RATES,
                     dtype_policy=POLICIES), dict(out_rows="auto")),
    ("vggnet", dict(chips=6, vmem_elems=3_145_728, **RATES),
     dict(harmonize=False)),
    ("vggnet", dict(chips=1, vmem_elems=3_145_728, dtype_policy=POLICIES),
     dict(out_rows="auto", objective="latency")),
    ("resnet18", dict(chips=1, vmem_elems=3_145_728, macs_per_s=33.5e12,
                      hbm_elems_per_s=3.35e12 / 4, dtype_policy=POLICIES),
     {}),
    ("resnet18", dict(chips=6, vmem_elems=3_145_728, link_elems_per_s=2e9,
                      dtype_policy=POLICIES), dict(harmonize=False)),
    ("resnet18", dict(chips=4, vmem_elems=12_582_912),
     dict(out_rows="auto", objective="traffic", arrival_rate=1e4)),
    ("vgg_mini", dict(chips=6, vmem_elems=6000), {}),
    ("vgg_mini", dict(chips=4, vmem_elems=6000, **RATES,
                      dtype_policy=POLICIES),
     dict(out_rows="auto", harmonize=False, batch=2)),
    ("vgg_mini", dict(chips=1, vmem_elems=6000, hbm_elems_per_s=1e6,
                      dtype_policy=POLICIES), dict(out_rows=2)),
]
GRID_IDS = [f"{n}-{f['chips']}chips-{i}" for i, (n, f, _k) in enumerate(GRID)]


@pytest.mark.parametrize("name,fleet_kw,kw", GRID, ids=GRID_IDS)
def test_frontier_document_equals_reference(name, fleet_kw, kw):
    """Every candidate, plan, score and stat, floats to the last bit."""
    frontier, j_frontier = _frontiers(name, fleet_kw, **kw)
    assert len(frontier) >= 1
    assert frontier.to_dict() == j_frontier.to_dict()
    # and the document round-trips through each package's loader
    doc = json.loads(frontier.to_json())
    assert occam.frontier_from_dict(doc).to_dict() == doc
    assert j_occam.frontier_from_dict(doc).to_dict() == doc


@pytest.mark.parametrize("name,fleet_kw,kw", GRID, ids=GRID_IDS)
def test_frontier_picks_equal_reference(name, fleet_kw, kw):
    """``best`` per objective and ``for_rate`` over a sweep of rates pick
    the same candidate index in both packages."""
    frontier, j_frontier = _frontiers(name, fleet_kw, **kw)
    cands, j_cands = list(frontier), list(j_frontier)
    for objective in occam.OBJECTIVES:
        assert cands.index(frontier.best(objective)) == \
            j_cands.index(j_frontier.best(objective))
    thr = sorted(c.throughput for c in frontier)
    rates = [1e-3 * thr[0], 1.0] + thr + [0.5 * (a + b)
                                          for a, b in zip(thr, thr[1:])] \
        + [10.0 * thr[-1]]
    for rate in rates:
        assert cands.index(frontier.for_rate(rate)) == \
            j_cands.index(j_frontier.for_rate(rate))


def test_checked_in_frontier_reserializes_unchanged():
    path = EXAMPLES / "vgg_mini.frontier.json"
    frontier = occam.load_frontier(str(path))
    assert frontier.to_dict() == json.loads(path.read_text())
    assert len(frontier) == 11
    assert {c.kind for c in frontier} == {occam.SINGLE, occam.PIPELINE}


@pytest.mark.parametrize("name,fleet_kw,kw", [GRID[4], GRID[5], GRID[7]],
                         ids=[GRID_IDS[4], GRID_IDS[5], GRID_IDS[7]])
@pytest.mark.parametrize("cost", [
    dict(macs_per_s=2.5e11),
    dict(macs_per_s=1e9, stage_overhead_s=3e-4, link_s_per_elem=2e-9,
         hbm_elems_per_s=1e8, analytic_macs_per_s=1.5e13, samples=6,
         residual=0.25)])
def test_rescored_frontier_equals_reference(name, fleet_kw, kw, cost):
    """One cost model re-ranks both packages' frontiers to equal
    documents (every plan carrying the calibration block), and the
    reference's re-scored document loads in the port unchanged."""
    frontier, j_frontier = _frontiers(name, fleet_kw, **kw)
    cm = occam.CostModel(**cost)
    rescored = frontier.rescore(cm)
    j_rescored = j_frontier.rescore(j_occam.CostModel(**cost))
    doc = j_rescored.to_dict()
    assert rescored.to_dict() == doc
    assert all(c.plan.calibration is cm for c in rescored)
    loaded = occam.frontier_from_dict(doc)
    assert loaded.to_dict() == doc
    assert all(c.plan.calibration == cm for c in loaded)
    assert list(loaded).index(loaded.best()) == \
        list(j_rescored).index(j_rescored.best())


def _params(net, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((ly.k, ly.k, ly.in_ch, ly.out_ch),
                                      np.float32) * np.float32(0.2),
             "b": rng.standard_normal((ly.out_ch,), np.float32)
             * np.float32(0.01)} if ly.kind == C else {}
            for ly in net.layers]


def test_scale_and_reconcile_never_rerun_the_dp(monkeypatch):
    """After ``autoplan``, autoscaling re-picks from the frontier's plans:
    with the DP patched to explode, ``reconcile`` and ``scale`` still
    hand over between candidates, and reuse each one's deployment."""
    net = chain("vgg_mini", VGG_MINI, in_h=16, in_w=16, in_ch=3)
    frontier = occam.autoplan(net, occam.Fleet(chips=1, vmem_elems=6000,
                                               dtype_policy=POLICIES))
    params = _params(net)
    fast = frontier.best("throughput")
    dep = fast.deploy(device="cpu")
    assert dep.candidate is fast and dep.frontier is frontier
    assert fast.deploy(device=torch.device("cpu")) is dep

    import repro_torch.core.partition as partition_mod

    def boom(*_a, **_k):  # pragma: no cover - must never run
        raise AssertionError("optimal_partition re-ran after planning")

    monkeypatch.setattr(partition_mod, "optimal_partition", boom)
    r_low = 1e-3 * min(c.throughput for c in frontier)
    r_high = 10.0 * max(c.throughput for c in frontier)
    low = frontier.for_rate(r_low)
    assert low is not fast
    low_dep = dep.reconcile(arrival_rate=r_low)
    assert low_dep.candidate is low and low_dep.device == dep.device
    assert low_dep.reconcile(arrival_rate=r_high) is dep
    assert dep.reconcile(arrival_rate=r_high) is dep
    xs = np.random.default_rng(1).standard_normal((3, 16, 16, 3),
                                                  np.float32)
    sess = dep.serve(params, round_batch=2)
    sess.submit(xs)
    scaled = sess.scale(arrival_rate=r_low)
    assert scaled.deployment is low_dep and scaled.round_batch == 2
    back = scaled.scale(arrival_rate=r_high)
    assert back.deployment is dep and back.compile_count == 1
    assert back.scale(arrival_rate=r_high) is back
    (_t, y), = sess.results()
    assert torch.equal(y, dep.run(params, xs))
