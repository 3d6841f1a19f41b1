"""The port's static audit (``repro_torch.occam.audit``) against the
reference's, on the CPU.

The corpus is the reference's (``tests/test_audit.py``): plan and
frontier documents, each with one hand-made lie, built once from the
reference's planner; the port's ``audit(doc).to_dict()`` must equal the
reference's on the same document, loci aside. Then everything the port's
planner emits audits clean, the ``audit=`` knobs warn, raise and skip as
the reference's do, the serve lint flags torch's device sync in an
``async def``, and ``python -m repro_torch.occam.audit`` gives the
reference CLI's verdict and exit code on the checked-in artifacts.
Each test names its reference counterpart where it has one.
"""
import copy
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro import occam as j_occam
from repro.core import closure as j_closure
from repro.core.graph import chain as j_chain
from repro.core.partition import (CNNPartitionProblem, PartitionResult, Span,
                                  partition_cost)
from repro.occam.audit import api as j_api
from repro.occam.audit import concurrency as j_concurrency
from repro.occam.audit.__main__ import main as j_main
from repro.occam.registry import register_engine as j_register
from repro.occam.registry import unregister_engine as j_unregister
from repro.runtime import span_engine as j_span_engine
from repro.runtime import stap_pipeline as j_sp
from repro_torch import occam
from repro_torch.core import closure
from repro_torch.core.graph import chain
from repro_torch.models import zoo
from repro_torch.occam.audit import (AUDIT_RULES, AuditError, AuditWarning,
                                     lint_source)
from repro_torch.occam.audit.__main__ import main
from repro_torch.occam.audit.api import audit, gate
from repro_torch.occam.audit.schedule import conveyor_findings
from repro_torch.occam.registry import register_engine, unregister_engine
from repro_torch.runtime import stap_pipeline as sp

ROOT = Path(__file__).resolve().parents[1]
C, P = "conv", "pool"
CAPACITY = 6000
VGG = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16),
       (C, 3, 1, 1, 16), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16)]
ZOO_CAPACITY = 3 * 1024 * 1024
# the reference places pipelines on its 8 emulated devices; the port's
# default device list is the visible GPUs, so its CPU runs name 8 CPU
# positions
CPU8 = ["cpu"] * 8


def _nets():
    kw = dict(in_h=16, in_w=16, in_ch=3)
    return chain("vgg_mini", VGG, **kw), j_chain("vgg_mini", VGG, **kw)


@pytest.fixture(scope="module")
def j_plan():
    return j_occam.plan(_nets()[1], CAPACITY)


@pytest.fixture(scope="module")
def doc(j_plan):
    return j_plan.to_dict()


@pytest.fixture(scope="module")
def fdoc():
    fr = j_occam.autoplan(_nets()[1], j_occam.Fleet(chips=6,
                                                    vmem_elems=CAPACITY))
    return json.loads(fr.to_json())


def _unlocated(report: dict) -> dict:
    d = copy.deepcopy(report)
    for f in d["findings"]:
        f.pop("locus")
    return d


def assert_same_audit(obj, **kw):
    """The port's and the reference's audit of ``obj`` as dicts, equal
    but for the findings' loci; returns the port's report."""
    got = audit(copy.deepcopy(obj), **kw)
    want = j_api.audit(copy.deepcopy(obj), **kw)
    assert _unlocated(got.to_dict()) == _unlocated(want.to_dict())
    return got


def _replan_doc(plan, cuts, mode="dram"):
    """tests/test_audit.py::replan_doc: the plan's document with its cuts
    replaced by ``cuts`` and every derived field recomputed honestly."""
    net = plan.net
    prob = CNNPartitionProblem(net, plan.capacity_elems, plan.batch,
                               plan.quant)
    edges = [0] + list(cuts) + [net.n_layers]
    spans = [[a, b, bool(prob.span_fits(a, b))]
             for a, b in zip(edges[:-1], edges[1:])]
    transfers = partition_cost(prob, list(cuts), mode)
    part = PartitionResult(list(cuts), [Span(a, b, f) for a, b, f in spans],
                           transfers, {}, {})
    routes = j_span_engine.plan_routes(net, part)
    d = copy.deepcopy(plan.to_dict())
    d["boundaries"] = list(cuts)
    d["spans"] = spans
    d["transfers"] = transfers
    d["routes"] = [[r.start, r.end, r.route, r.reason] for r in routes]
    if d.get("serving", {}).get("ring_depth") is not None:
        d["serving"]["ring_depth"] = len(spans)
    return d


def _pipeline_cand(d, pred=lambda c: True):
    return next(c for c in d["candidates"] if c["kind"] == "pipeline"
                and pred(c))


# --------------------------------------------------------------------------
# The corrupted corpus: one lie, one rule ID, the reference's findings
# --------------------------------------------------------------------------

def _capacity(doc, fdoc, plan):
    return dict(doc, capacity_elems=100)


def _stray(doc, fdoc, plan):
    return dict(doc, autoscale={"target": 2})


def _stray_null(doc, fdoc, plan):
    return dict(doc, autoscale=None)


def _extra_cut(doc, fdoc, plan):
    cuts = sorted(plan.boundaries)
    free = next(p for p in range(1, plan.net.n_layers) if p not in cuts)
    return _replan_doc(plan, sorted(cuts + [free]))


def _stale_transfers(doc, fdoc, plan):
    return dict(doc, transfers=doc["transfers"] + 12345.0)


def _zeroed_replica(doc, fdoc, plan):
    d = copy.deepcopy(fdoc)
    cand = _pipeline_cand(d, lambda c: len(c["replicas"]) > 1)
    cand["replicas"] = [0] + cand["replicas"][1:]
    cand["scores"]["chips"] = sum(cand["replicas"])
    return d


def _chip_mismatch(doc, fdoc, plan):
    d = copy.deepcopy(fdoc)
    cand = _pipeline_cand(d)
    cand["scores"]["chips"] = sum(cand["replicas"]) + 1
    return d


def _unknown_engine(doc, fdoc, plan):
    d = copy.deepcopy(doc)
    d["routes"][0][2] = "warp9"
    return d


def _ring_depth(doc, fdoc, plan):
    d = copy.deepcopy(doc)
    d["serving"]["ring_depth"] += 2
    return d


def _indivisible_round_batch(doc, fdoc, plan):
    d = copy.deepcopy(fdoc)
    _pipeline_cand(d, lambda c: max(c["replicas"]) > 1)[
        "plan"]["serving"]["round_batch"] = 7
    return d


def _unloadable(doc, fdoc, plan):
    d = copy.deepcopy(doc)
    del d["spans"]
    return d


def _span_table(doc, fdoc, plan):
    d = copy.deepcopy(doc)
    d["spans"] = d["spans"][:-1]
    return d


# (name, build the corrupted document, audit keywords, rule signature,
# ok); reference: the test_corpus_* tests of tests/test_audit.py
CORPUS = [
    ("undersized_capacity", _capacity, {}, ("OCM011",), False),
    ("stray_key", _stray, {}, ("OCM001",), False),
    ("stray_null_key", _stray_null, {}, ("OCM001",), True),
    ("suboptimal_cut_brute_force", _extra_cut, {}, ("OCM021",), False),
    ("suboptimal_cut_neighborhood", _extra_cut,
     {"brute_force_max_layers": 0}, ("OCM020",), False),
    ("stale_transfers", _stale_transfers, {}, ("OCM022",), True),
    ("zeroed_replica", _zeroed_replica, {}, ("OCM030",), False),
    ("chip_mismatch", _chip_mismatch, {}, ("OCM032",), False),
    ("unknown_engine", _unknown_engine, {}, ("OCM040",), False),
    ("ring_depth", _ring_depth, {}, ("OCM031",), False),
    ("indivisible_round_batch", _indivisible_round_batch, {}, ("OCM031",),
     False),
    ("unloadable", _unloadable, {}, ("OCM002",), False),
    ("span_table", _span_table, {}, ("OCM002",), False),
]


@pytest.mark.parametrize("build,kw,rules,ok",
                         [c[1:] for c in CORPUS], ids=[c[0] for c in CORPUS])
def test_corpus_findings_equal_reference(doc, fdoc, j_plan, build, kw,
                                         rules, ok):
    rep = assert_same_audit(build(doc, fdoc, j_plan), **kw)
    assert rep.rules() == rules and rep.ok == ok


def test_corpus_infeasible_cut_equal_reference(j_plan):
    # reference: test_corpus_infeasible_cut_is_caught
    prob = CNNPartitionProblem(j_plan.net, j_plan.capacity_elems,
                               j_plan.batch, j_plan.quant)
    bad = next([p] for p in range(2, j_plan.net.n_layers - 1)
               if not prob.span_fits(0, p))
    d = _replan_doc(j_plan, bad)
    assert assert_same_audit(d).rules() == ("OCM021",)
    assert assert_same_audit(d, brute_force_max_layers=0).rules() == \
        ("OCM020",)


def _register_both(name, **kw):
    register_engine(name, **kw)
    j_register(name, **kw)


def _unregister_both(name):
    unregister_engine(name)
    j_unregister(name)


def test_corpus_int8_on_floatonly_engine_equal_reference():
    # reference: test_corpus_int8_on_floatonly_engine_is_ocm041
    d = j_occam.plan(_nets()[1], CAPACITY, dtype_policy="int8").to_dict()
    _register_both("narrow", priority=99,
                   accepts=lambda net, a, b, ctx: (True, "always"),
                   run=lambda *a, **k: (None, {}), dtypes=("bfloat16",))
    try:
        d["routes"][0][2] = "narrow"
        rep = assert_same_audit(d)
        assert rep.rules() == ("OCM041",) and not rep.ok
    finally:
        _unregister_both("narrow")


def test_corpus_no_spmd_body_equal_reference(fdoc):
    # reference: test_corpus_no_spmd_body_is_ocm043
    _register_both("hostonly", priority=99,
                   accepts=lambda net, a, b, ctx: (True, "always"),
                   run=lambda *a, **k: (None, {}))
    try:
        d = copy.deepcopy(fdoc)
        for route in _pipeline_cand(d)["plan"]["routes"]:
            route[2] = "hostonly"
        rep = assert_same_audit(d)
        assert "OCM043" in rep.rules() and not rep.ok
    finally:
        _unregister_both("hostonly")


def test_residency_reproof_failure_equal_reference(doc, monkeypatch):
    # reference: test_residency_reproof_failure_is_ocm010
    def broken(net, a, b, **kw):
        raise ValueError("ring cap exceeded")

    monkeypatch.setattr(closure, "span_schedule", broken)
    monkeypatch.setattr(j_closure, "span_schedule", broken)
    rep = assert_same_audit(doc)
    assert rep.rules() == ("OCM010",) and not rep.ok


def test_conveyor_findings_equal_reference(monkeypatch):
    # reference: test_conveyor_collision_is_ocm033 and
    # test_conveyor_checked_in_assignment_is_clean; OCM033 replays the
    # port's own output_bank_row
    from repro.occam.audit.schedule import conveyor_findings as j_conveyor

    for n_stages in (1, 2, 3, 5):
        assert conveyor_findings(n_stages, "test") == []
    monkeypatch.setattr(sp, "output_bank_row",
                        lambda rg, n_rounds, n_stages: 0)
    monkeypatch.setattr(j_sp, "output_bank_row",
                        lambda rg, n_rounds, n_stages: 0)
    got = conveyor_findings(3, "test")
    assert got and all(f.rule == "OCM033" for f in got)
    assert [f.to_dict() for f in got] == \
        [f.to_dict() for f in j_conveyor(3, "test")]


# --------------------------------------------------------------------------
# Zero false positives: the port's planner output audits clean
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["alexnet", "vggnet", "resnet18"])
@pytest.mark.parametrize("policy", [None, "int8"])
def test_zoo_plans_and_placements_audit_clean(name, policy):
    # reference: test_zoo_plans_audit_clean, test_clean_placements_...
    plan = occam.plan(zoo.get_network(name), ZOO_CAPACITY,
                      dtype_policy=policy)
    k = plan.n_spans + 1
    pipe = plan.place(chips=k, devices=["cpu"] * k, audit="error")
    objs = [plan, plan.place(audit="error"), pipe,
            plan.place(audit="error").compile(device="cpu", audit="error"),
            pipe.compile(device="cpu", audit="error"), plan.to_dict()]
    for obj in objs:
        rep = audit(obj)
        assert rep.ok and not rep.findings, rep.summary()
    assert audit(plan).to_dict() == j_api.audit(j_occam.plan(
        j_occam.plan_from_dict(plan.to_dict()).net, ZOO_CAPACITY,
        dtype_policy=policy)).to_dict()


@pytest.mark.parametrize("name", ["alexnet", "vggnet", "resnet18"])
def test_zoo_frontiers_audit_clean(name):
    # reference: test_zoo_frontiers_audit_clean (fp32 and int8 in one
    # fleet here); every candidate, single and pipeline, and the document
    fr = occam.autoplan(zoo.get_network(name), occam.Fleet(
        chips=8, vmem_elems=ZOO_CAPACITY, dtype_policy=("fp32", "int8")))
    for obj in (fr, json.loads(fr.to_json()), *fr.candidates):
        rep = audit(obj)
        assert rep.ok and not rep.findings, rep.summary()


def test_clean_vgg_mini_equal_reference(doc, fdoc):
    # reference: test_clean_plan_audits_clean and
    # test_clean_document_roundtrip_audits_clean
    for obj in (doc, fdoc):
        assert not assert_same_audit(obj).findings
    plan = occam.plan(_nets()[0], CAPACITY)
    assert plan.to_dict() == doc
    assert audit(plan).to_dict() == j_api.audit(
        j_occam.plan_from_dict(doc)).to_dict()


# --------------------------------------------------------------------------
# The audit= knob on place / compile / Frontier.serve
# --------------------------------------------------------------------------

def _corrupted_plan(doc):
    """tests/test_audit.py::corrupted_plan: a loadable plan with an error
    finding (a stale ring_depth)."""
    d = copy.deepcopy(doc)
    d["serving"]["ring_depth"] += 2
    return occam.plan_from_json(json.dumps(d))


def test_place_audit_knob(doc):
    # reference: test_place_audit_knob
    bad = _corrupted_plan(doc)
    with pytest.raises(AuditError, match="OCM031"):
        bad.place(audit="error")
    with pytest.warns(AuditWarning, match="Plan.place: .*OCM031"):
        bad.place()  # warn is the default
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bad.place(audit="off")
    with pytest.raises(ValueError, match="audit"):
        bad.place(audit="loud")
    with pytest.raises(AuditError, match="OCM031"):
        bad.place(chips=bad.n_spans + 1, devices=CPU8, audit="error")


def test_compile_audit_knob(doc):
    # reference: test_compile_audit_knob (the port compiles on device=)
    bad = _corrupted_plan(doc)
    placement = bad.place(audit="off")
    with pytest.raises(AuditError, match="OCM031"):
        placement.compile(device="cpu", audit="error")
    with pytest.warns(AuditWarning, match="Placement.compile: .*OCM031"):
        placement.compile(device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dep = placement.compile(device="cpu", audit="off")
    assert dep.placement is placement


def test_serve_validates_ring_depth_and_round_batch(doc):
    # reference: test_serve_validates_ring_depth_and_round_batch
    bad = _corrupted_plan(doc)
    k = bad.n_spans + 1
    dep = bad.place(chips=k, devices=CPU8, audit="off") \
             .compile(audit="off")
    with pytest.raises(ValueError, match="ring"):
        dep.serve(params=None)
    good = occam.plan_from_json(json.dumps(doc))
    dep = good.place(chips=k, devices=CPU8, audit="off") \
              .compile(audit="off")
    width = dep.placement.steady_schedule().round_width
    assert width == 2
    with pytest.raises(ValueError, match="multiple"):
        dep.serve(params=None, round_batch=width + 1)


def test_gate_off_runs_nothing(doc):
    # reference: test_gate_off_runs_nothing
    assert gate(dict(doc, autoscale=1), "off") is None


def test_frontier_serve_audit_knob(fdoc):
    # reference: test_frontier_serve_audit_knob; the gate runs before any
    # deployment, so no device is touched
    d = copy.deepcopy(fdoc)
    for c in d["candidates"]:
        c["scores"]["chips"] = sum(c["replicas"]) + 9
    bad = occam.frontier_from_json(json.dumps(d))
    with pytest.raises(AuditError, match="OCM032"):
        bad.serve(params=None, audit="error")
    net = _nets()[0]
    params = [{"w": np.zeros((ly.k, ly.k, ly.in_ch, ly.out_ch), np.float32),
               "b": np.zeros((ly.out_ch,), np.float32)}
              if ly.kind == C else {} for ly in net.layers]
    with pytest.warns(AuditWarning, match="Frontier.serve: .*OCM032"):
        eng = bad.serve(params, device="cpu", autoscale=False)
    assert eng.deployment.candidate is bad.best()
    assert not eng.describe()["autoscale_armed"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert bad.serve(params, device="cpu", audit="off").describe()[
            "autoscale_armed"]


def test_report_surface_equals_reference(doc):
    # reference: test_report_json_roundtrip, test_rule_table_is_stable,
    # test_finding_rejects_unknown_rule, test_audit_rejects_unknown_types
    from repro.occam.audit import AUDIT_RULES as J_RULES
    from repro_torch.occam.audit import AuditReport, Finding

    rep = assert_same_audit(dict(doc, autoscale=1, transfers=1.0))
    back = AuditReport.from_json(rep.to_json())
    assert back.findings == rep.findings and back.ok == rep.ok
    assert rep.verdict()["ok"] is False and "OCM001" in rep.verdict()["rules"]
    assert {k: (r.severity, r.invariant) for k, r in AUDIT_RULES.items()} \
        == {k: (r.severity, r.invariant) for k, r in J_RULES.items()}
    with pytest.raises(ValueError):
        Finding("OCM999", "error", "x", "y", {})
    with pytest.raises(TypeError, match="occam.audit takes"):
        audit(42)


# --------------------------------------------------------------------------
# OCM05x: the serve lint
# --------------------------------------------------------------------------

LINT_CORPUS = [
    ("import time\nimport asyncio\nasync def tick(self):\n"
     "    await asyncio.sleep(0.1)\n    time.sleep(0.5)\n"),
    ("import time as clock\nfrom time import sleep as nap\n"
     "async def a():\n    clock.sleep(1)\nasync def b():\n    nap(1)\n"
     "async def c(x):\n    x.block_until_ready()\n"
     "async def d(self):\n    self.session.pump()\n"),
    ("import time\ndef sync_path():\n    time.sleep(1)\n"
     "async def outer():\n    def helper():\n        time.sleep(1)\n"
     "    return helper\n"),
    ("import threading\nclass Engine:\n    def _worker(self):\n"
     "        self.done = True\n    def start(self):\n"
     "        threading.Thread(target=self._worker).start()\n"),
    ("import threading\nclass Engine:\n    def _worker(self):\n"
     "        with self._lock:\n            self.done = True\n"
     "    def start(self):\n"
     "        threading.Thread(target=self._worker).start()\n"),
]


@pytest.mark.parametrize("i", range(len(LINT_CORPUS)))
def test_lint_corpus_equals_reference(i):
    # reference: the test_lint_* tests of tests/test_audit.py
    src = LINT_CORPUS[i]
    assert [f.to_dict() for f in lint_source(src, "fake.py")] == \
        [f.to_dict() for f in j_concurrency.lint_source(src, "fake.py")]


def test_lint_flags_torch_device_sync_in_async_def():
    """OCM050 flags a blocking ``synchronize()`` inside an ``async def``
    (``torch.cuda.synchronize()``, an event's or a stream's), which the
    reference's lint, written for JAX, does not look for; outside an
    ``async def`` and in nested sync defs it stays silent."""
    src = ("import torch\n"
           "async def a():\n    torch.cuda.synchronize()\n"
           "async def b(ev):\n    ev.synchronize()\n"
           "async def c(self):\n    self.stream.synchronize()\n"
           "def d():\n    torch.cuda.synchronize()\n"
           "async def e():\n    def f():\n"
           "        torch.cuda.synchronize()\n    return f\n")
    findings = lint_source(src, "fake.py")
    assert [(f.rule, f.detail["line"], f.detail["call"])
            for f in findings] == [("OCM050", 3, "synchronize"),
                                   ("OCM050", 5, "synchronize"),
                                   ("OCM050", 7, "synchronize")]
    assert j_concurrency.lint_source(src, "fake.py") == []


def test_serve_tree_lints_clean():
    # reference: test_serve_tree_lints_clean, over the port's own
    # occam/serve, located under its source tree
    rep = occam.lint_serve()
    assert rep.ok and not rep.findings, rep.summary()
    assert rep.subject == "serve-lint:src/repro_torch/occam/serve"


# --------------------------------------------------------------------------
# The CLI: python -m repro_torch.occam.audit
# --------------------------------------------------------------------------

def _cli(fn, argv, capsys):
    code = fn(argv)
    return code, capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--json"]])
def test_cli_on_examples_equals_reference(extra, capsys):
    # the checked-in *.plan.json / *.frontier.json under examples/
    argv = [str(ROOT / "examples"), "--no-lint"] + extra
    code, out = _cli(main, argv, capsys)
    j_code, j_out = _cli(j_main, argv, capsys)
    assert (code, out) == (j_code, j_out) and code == 0
    assert out.count("audit clean") == (0 if extra else 3)


def test_cli_passes_clean_and_fails_corrupt(tmp_path, doc, capsys):
    # reference: test_cli_passes_clean_and_fails_corrupt and
    # test_cli_graceful_with_no_artifacts
    assert _cli(main, [str(tmp_path), "--no-lint"], capsys) == \
        _cli(j_main, [str(tmp_path), "--no-lint"], capsys)
    (tmp_path / "good.plan.json").write_text(json.dumps(doc))
    assert _cli(main, [str(tmp_path), "--no-lint"], capsys)[0] == 0
    (tmp_path / "bad.plan.json").write_text(
        json.dumps(dict(doc, capacity_elems=100)))
    code, out = _cli(main, [str(tmp_path), "--no-lint"], capsys)
    assert (code, out) == _cli(j_main, [str(tmp_path), "--no-lint"], capsys)
    assert code == 1 and "OCM011" in out


def test_cli_module_runs_with_the_serve_lint():
    """``python -m repro_torch.occam.audit examples`` in a process of its
    own: the artifacts and the port's serve lint, exit code 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.occam.audit", "examples"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == \
        "audit clean: serve-lint:src/repro_torch/occam/serve"
    assert out.stdout.count("audit clean") == 4
