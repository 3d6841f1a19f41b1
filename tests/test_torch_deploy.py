"""The port's staged API against the reference's: identical plan documents,
JSON both ways, the checked-in plans loading and running, the device
default, the slices once pinned as raising, and params conversion."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import occam as j_occam
from repro.core.graph import chain as j_chain
from repro.models import cnn as j_cnn
from repro.models import zoo as j_zoo
from repro_torch import convert, occam
from repro_torch.core.graph import chain
from repro_torch.core.traffic import TrafficCounter
from repro_torch.models import zoo

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
C, P = "conv", "pool"
RES = ([(C, 3, 2, 1, 4), (P, 3, 2, 1, 0), (C, 3, 1, 1, 4), (C, 3, 1, 1, 4),
        (C, 3, 2, 1, 8), (C, 3, 1, 1, 8)], ((2, 4), (4, 6)))

PLAN_CASES = [
    ("resnet18", 3_145_728, {}),
    ("resnet18", 786_432, {"round_batch": 4}),
    ("vggnet", 786_432, {"out_rows": 2}),
    ("alexnet", 3_145_728, {"batch": 2}),
]


@pytest.mark.parametrize("name,capacity,kw", PLAN_CASES)
def test_plan_documents_equal_reference(name, capacity, kw):
    got = occam.plan(zoo.get_network(name), capacity, **kw)
    want = j_occam.plan(j_zoo.get_network(name), capacity, **kw)
    assert got.to_dict() == want.to_dict()
    assert got.predicted_transfers == want.predicted_transfers


def test_plan_json_round_trips_both_ways():
    net = chain("res", RES[0], in_h=16, in_w=16, in_ch=3,
                residual_edges=RES[1])
    j_net = j_chain("res", RES[0], in_h=16, in_w=16, in_ch=3,
                    residual_edges=RES[1])
    mine = occam.plan(net, 700, round_batch=2)
    theirs = j_occam.plan(j_net, 700, round_batch=2)
    assert j_occam.plan_from_json(mine.to_json()).to_dict() == \
        mine.to_dict()
    assert occam.plan_from_json(theirs.to_json()).to_dict() == \
        theirs.to_dict()
    # schema v1 documents migrate identically
    v1 = {k: v for k, v in theirs.to_dict().items()
          if k in ("net", "capacity_elems", "batch", "boundaries", "spans",
                   "transfers", "routes", "predicted")}
    v1["version"] = 1
    assert occam.plan_from_dict(v1).to_dict() == \
        j_occam.plan_from_dict(v1).to_dict()


def test_checked_in_alexnet_plan_loads_with_identical_routes():
    got = occam.load_plan(str(EXAMPLES / "alexnet.plan.json"))
    want = j_occam.load_plan(str(EXAMPLES / "alexnet.plan.json"))
    assert got.to_dict() == want.to_dict()
    assert [(r.start, r.end, r.route) for r in got.routes] == \
        [(0, 8, "pallas")]
    dep = got.place().compile(device="cpu")
    assert dep.routes == got.routes


def test_vgg_mini_plan_runs_like_reference():
    path = str(EXAMPLES / "vgg_mini.plan.json")
    j_plan = j_occam.load_plan(path)
    params = j_cnn.init_params(jax.random.PRNGKey(0), j_plan.net)
    xs = np.random.default_rng(1).standard_normal((3, 16, 16, 3),
                                                  np.float32)
    j_dep = j_plan.place().compile(backend="scan")
    want = np.asarray(j_dep.run(params, jnp.asarray(xs)))
    dep = occam.load_plan(path).place().compile(device="cpu")
    assert [r.route for r in dep.routes] == ["pallas"] * 3
    # numpy params and images, as a caller holding the reference's params
    got = dep.run([{k: np.asarray(v) for k, v in p.items()} for p in params],
                  xs)
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    counter = TrafficCounter()
    one = dep.run(convert.params_from_numpy(params), xs[0], counter=counter)
    assert counter.total == j_plan.predicted_transfers
    np.testing.assert_allclose(one.numpy(), want[0], rtol=1e-4, atol=1e-4)
    rep, j_rep = dep.report(), j_dep.report()
    assert rep.matches_prediction and j_rep.matches_prediction
    assert rep.images == 4
    assert rep.measured_per_image == j_rep.measured_per_image
    desc = dep.describe()
    assert desc["images_run"] == 4 and desc["device"] == "cpu"
    assert desc["measured_transfers"] == 4 * j_plan.predicted_transfers


def test_compile_defaults_to_the_gpu(monkeypatch):
    plan = occam.load_plan(str(EXAMPLES / "vgg_mini.plan.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        plan.place().compile()
    assert plan.place().compile(device="cpu").device == torch.device("cpu")


def test_unported_slices_raise():
    """The slices this test once pinned as raising are ported: multi-chip
    arguments give the reference's pipeline placements (and the
    reference's error for a budget below one chip a stage)."""
    net = zoo.resnet18()
    plan = occam.plan(net, 3_145_728)
    j_plan = j_occam.plan(j_zoo.resnet18(), 3_145_728)
    for p in (plan, j_plan):
        with pytest.raises(ValueError, match="5 stages"):
            p.place(chips=4)
    pl = plan.place(pipeline=True)
    assert (pl.kind, pl.replicas, pl.ring_depth) == \
        (occam.PIPELINE, (1,) * 5, 5)
    pl = plan.place(replicas=(4, 1, 1, 1, 1), microbatch=2)
    j_pl = j_plan.place(replicas=(4, 1, 1, 1, 1), microbatch=2)
    assert (pl.chips, pl.devices_needed, pl.serve_geometry()) == \
        (j_pl.chips, j_pl.devices_needed, j_pl.serve_geometry()) == \
        (8, 20, (8, 2))
    assert pl.stap.throughput == j_pl.stap.throughput
    # the planning frontier is ported: a deployment that no frontier made
    # has nothing to reconcile against
    with pytest.raises(ValueError, match="no frontier"):
        plan.place().compile(device="cpu").reconcile(arrival_rate=1.0)
    # dtype policies are ported: a reference v5 document with a quant
    # block loads into an equal plan
    doc = j_occam.plan(j_zoo.resnet18(), 3_145_728,
                       dtype_policy="int8").to_dict()
    assert occam.plan_from_dict(doc).to_dict() == doc
    # so are calibrated plans: a calibration block loads into a CostModel
    doc = plan.to_dict()
    doc["calibration"] = {"version": 1, "macs_per_s": 3.2e11}
    loaded = occam.plan_from_dict(doc)
    assert loaded.calibration == occam.CostModel(macs_per_s=3.2e11)
    assert loaded.to_dict()["calibration"] == \
        occam.CostModel(macs_per_s=3.2e11).to_dict()
    doc = plan.to_dict()
    doc["extra"] = 1
    with pytest.raises(ValueError, match="unknown top-level"):
        occam.plan_from_dict(doc)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_numpy_round_trips_reference_params(dtype):
    j_net = j_chain("res", RES[0], in_h=16, in_w=16, in_ch=3,
                    residual_edges=RES[1])
    params = j_cnn.init_params(jax.random.PRNGKey(3), j_net, dtype=dtype)
    got = convert.params_from_numpy(params)
    assert len(got) == len(params)
    for g, p in zip(got, params):
        assert g.keys() == p.keys()
        for k in p:
            assert g[k].dtype == {jnp.float32: torch.float32,
                                  jnp.bfloat16: torch.bfloat16}[dtype]
            np.testing.assert_array_equal(
                g[k].float().numpy(), np.asarray(p[k], np.float32))
    back = convert.params_from_numpy(got)
    assert all(torch.equal(b[k], g[k]) for b, g in zip(back, got) for k in g)
