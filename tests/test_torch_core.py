"""The port's copies of the pure-Python planning modules stay equal to the
reference's: the same source (imports aside), and the same partitions,
transfers, schedules and closures on the paper's networks."""
import ast
import dataclasses
from pathlib import Path

import pytest

from repro.core import closure as j_closure
from repro.core import partition as j_partition
from repro.core import traffic as j_traffic
from repro.models import zoo as j_zoo
from repro_torch.core import closure, partition, traffic
from repro_torch.models import zoo

SRC = Path(__file__).resolve().parents[1] / "src"

COPIES = [
    "core/graph.py", "core/closure.py", "core/partition.py",
    "core/traffic.py", "models/zoo.py", "occam/registry.py",
    "occam/fleet.py", "occam/quant/policy.py", "occam/quant/footprint.py",
    "core/stap.py", "occam/calibrate/cost_model.py",
    "occam/calibrate/placement.py", "occam/calibrate/rescore.py",
    "configs/__init__.py", "configs/base.py",
    "occam/audit/report.py", "occam/audit/invariants.py",
    "occam/audit/routing.py", "occam/audit/schedule.py",
    "occam/audit/api.py", "occam/audit/__init__.py",
    "occam/audit/concurrency.py", "occam/audit/__main__.py",
    "occam/serve/queue.py", "occam/serve/metrics.py",
    "occam/serve/router.py", "occam/serve/__init__.py",
    "data/pipeline.py", "runtime/elastic.py",
] + sorted(f"configs/{p.name}" for p in (SRC / "repro" / "configs").glob(
    "*.py") if p.name not in ("__init__.py", "base.py"))

# the lines of a copy that must name the port: its own package in a
# string, the port's source tree in a locus, and torch's device sync
# beside JAX's among the calls the serve lint (OCM050) flags in an
# ``async def``
RENAMED = {
    "configs/__init__.py": [('f"repro.configs.{mod}"',
                             'f"repro_torch.configs.{mod}"')],
    "occam/audit/__main__.py": [('prog="python -m repro.occam.audit"',
                                 'prog="python -m repro_torch.occam.audit"')],
    "occam/audit/concurrency.py": [
        ('idx = p.find("src/repro/")', 'idx = p.find("src/repro_torch/")'),
        ('_BLOCKING_ATTRS = ("block_until_ready", "pump")',
         '_BLOCKING_ATTRS = ("block_until_ready", "synchronize", "pump")')],
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference_source(rel):
    """Each copied module is the reference's text with only its absolute
    ``repro.`` imports renamed to ``repro_torch.`` (and the lines
    ``RENAMED`` states)."""
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    ref = ref.replace("from repro.", "from repro_torch.")
    for old, new in RENAMED.get(rel, ()):
        assert ref.count(old) == 1
        ref = ref.replace(old, new)
    assert port == ref


def _sources(path: Path) -> dict[str, str]:
    """Each top-level class, function and assignment of a module, and each
    method of its classes (as ``Class.method``), as source text
    (decorators included) with absolute ``repro.`` imports renamed to
    ``repro_torch.``, read without importing the module."""
    text = path.read_text().replace("from repro.", "from repro_torch.")
    lines = text.splitlines(keepends=True)

    def source(node):
        first = min([node.lineno] + [d.lineno for d in
                                     getattr(node, "decorator_list", [])])
        return "".join(lines[first - 1:node.end_lineno])

    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.ClassDef,) + defs):
            out[node.name] = source(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                out[target.id] = source(node)
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, defs):
                    out[f"{node.name}.{item.name}"] = source(item)
    return out


@pytest.mark.parametrize("name", ["TickTimers", "_TimerContext",
                                  "StageProfile"])
def test_timer_classes_match_reference_source(name):
    """The serving tick timer and the stage profile are copies of the
    reference's classes (the rest of that module imports JAX, so the
    whole-file check cannot apply); besides them the port's module holds
    only its own stage measurement."""
    rel = "occam/calibrate/timers.py"
    ref = _sources(SRC / "repro" / rel)
    port = _sources(SRC / "repro_torch" / rel)
    assert {k for k in port if "." not in k} == {
        "StageProfile", "TickTimers", "_TimerContext",
        "measure_stage_seconds", "measure_hop_seconds"}
    assert port[name] == ref[name]


# The planning frontier, the STAP stage plan, the LM stage plan, the
# sharding context's resolution and the async engine: every definition
# the port keeps as the reference's text. search.py differs
# only in Candidate.placement / Candidate.deploy / Frontier.serve (an
# explicit device); serve/engine.py only where it packs and joins tensors.
ENGINE_OWN = {"AsyncEngine", "AsyncEngine.submit", "AsyncEngine._stage",
              "AsyncEngine._deliver"}
TWINS = [("occam/search.py", name) for name in (
    "FRONTIER_FORMAT_VERSION", "FRONTIER_DOCUMENT_KEYS", "OBJECTIVES",
    "_det", "_OBJECTIVE_KEYS", "Candidate.throughput",
    "Candidate.round_width", "Candidate.scores", "Candidate.to_dict",
    "Candidate.from_dict", "_dominates", "Frontier.__post_init__",
    "Frontier.__len__", "Frontier.__iter__", "Frontier.best",
    "Frontier.for_rate", "Frontier.deploy", "Frontier.rescore",
    "Frontier.to_dict", "Frontier.to_json", "Frontier.save",
    "frontier_from_dict", "frontier_from_json", "load_frontier",
    "_make_plan", "_MAX_AUTO_TILE", "_pick_out_rows", "_replica_vectors",
    "_score", "autoplan")] + [
    ("runtime/stap_pipeline.py", name) for name in (
        "PayloadSpec", "payload_spec", "StageSpec", "plan_span_stages",
        "model_stage_times")] + [
    ("runtime/pipeline.py", "StagePlan"), ("runtime/pipeline.py",
                                           "plan_stages"),
    ("launch/mesh.py", "data_axes")] + [
    ("models/sharding.py", name) for name in (
        "_CTX", "use_shardings", "current_ctx", "resolve")] + [
    ("occam/serve/engine.py", name) for name in sorted(
        set(_sources(SRC / "repro" / "occam/serve/engine.py"))
        - ENGINE_OWN)]


@pytest.mark.parametrize("rel,name", TWINS,
                         ids=[f"{r}::{n}" for r, n in TWINS])
def test_twin_definitions_match_reference_source(rel, name):
    assert _sources(SRC / "repro_torch" / rel)[name] == \
        _sources(SRC / "repro" / rel)[name]


def test_search_twin_differs_only_where_stated():
    """The port's search.py defines what the reference's does, and
    nothing that the check above does not hold equal, but three methods."""
    rel = "occam/search.py"
    port = _sources(SRC / "repro_torch" / rel)
    ref = _sources(SRC / "repro" / rel)
    assert set(port) == set(ref)
    differ = {k for k in port if port[k] != ref[k]}
    assert differ == {"Candidate", "Candidate.placement", "Candidate.deploy",
                      "Frontier", "Frontier.serve"}


def test_engine_twin_differs_only_where_stated():
    """The port's async engine defines what the reference's does, with
    the same methods (so the serve lint sees the same shape), and differs
    only in how it takes, packs and joins images: ``submit`` (numpy or a
    tensor, the dtype checked at the front door), ``_stage`` (pinned
    host packing and a copy to the deployment's device) and
    ``_deliver`` (``torch.cat``)."""
    rel = "occam/serve/engine.py"
    port = _sources(SRC / "repro_torch" / rel)
    ref = _sources(SRC / "repro" / rel)
    assert set(port) == set(ref)
    assert {k for k in port if port[k] != ref[k]} == ENGINE_OWN


CAPACITIES = [786_432, 3_145_728, 12_582_912]


@pytest.mark.parametrize("name", ["alexnet", "vggnet", "resnet18"])
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_partition_and_schedules_match_reference(name, capacity):
    net, j_net = zoo.get_network(name), j_zoo.get_network(name)
    part = partition.partition_cnn(net, capacity)
    j_part = j_partition.partition_cnn(j_net, capacity)
    assert part.boundaries == j_part.boundaries
    assert part.transfers == j_part.transfers
    assert [(s.start, s.end, s.fits) for s in part.spans] == \
        [(s.start, s.end, s.fits) for s in j_part.spans]
    assert dataclasses.astuple(traffic.occam_traffic(net, capacity, 1,
                                                     part)) == \
        dataclasses.astuple(j_traffic.occam_traffic(j_net, capacity, 1,
                                                    j_part))
    cuts = [0] + part.boundaries + [net.n_layers]
    for a, b in zip(cuts, cuts[1:]):
        assert closure.span_row_counts(net, a, b) == \
            j_closure.span_row_counts(j_net, a, b)
        assert closure.span_closure_elems(net, a, b) == \
            j_closure.span_closure_elems(j_net, a, b)
        try:
            j_sched = j_closure.span_schedule(j_net, a, b)
        except AssertionError:
            with pytest.raises(AssertionError):
                closure.span_schedule(net, a, b)
            continue
        sched = closure.span_schedule(net, a, b)
        assert sched.slot_table() == j_sched.slot_table()
        assert sched.arrivals == j_sched.arrivals
        assert sched.in_rows == j_sched.in_rows
        assert sched.ring_caps == j_sched.ring_caps
        assert sched.scratch_elems() == j_sched.scratch_elems()
