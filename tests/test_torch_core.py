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
# ``async def``; and the lines the port's serving copies change: a
# request's times while torch.profiler records (``occam.trace``), and no
# per-window latency list, which nothing read
RENAMED = {
    "configs/__init__.py": [('f"repro.configs.{mod}"',
                             'f"repro_torch.configs.{mod}"')],
    "occam/audit/__main__.py": [('prog="python -m repro.occam.audit"',
                                 'prog="python -m repro_torch.occam.audit"')],
    "occam/audit/concurrency.py": [
        ('idx = p.find("src/repro/")', 'idx = p.find("src/repro_torch/")'),
        ('_BLOCKING_ATTRS = ("block_until_ready", "pump")',
         '_BLOCKING_ATTRS = ("block_until_ready", "synchronize", "pump")')],
    "occam/serve/queue.py": [
        ("    cancelled: bool = False\n",
         "    cancelled: bool = False\n"
         "    # time.time_ns() at admission and at the last pack of its images,\n"
         "    # noted while torch.profiler records (occam.trace)\n"
         "    admitted_ns: int | None = None\n"
         "    staged_ns: int | None = None\n")],
    "occam/serve/metrics.py": [
        ("    latencies: list = dataclasses.field(default_factory=list)\n",
         ""),
        ("        self._open.latencies.append(latency_s)\n", "")],
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


# what the port's tick timer adds to the reference's docstring: on the GPU
# a tick's time is the host's issue of the round
TIMER_DOC = (
    "    utilization stats scale per-stage shares by.\"\"\"\n",
    "    utilization stats scale per-stage shares by. A tick is timed on the\n"
    "    host: on the GPU its call returns once the round is issued (a CUDA\n"
    "    graph replay enqueued), so the time is the host's issue of the\n"
    "    round, not the device's time computing it.\"\"\"\n")


@pytest.mark.parametrize("name", ["TickTimers", "_TimerContext",
                                  "StageProfile"])
def test_timer_classes_match_reference_source(name):
    """The serving tick timer and the stage profile are copies of the
    reference's classes (the rest of that module imports JAX, so the
    whole-file check cannot apply), the timer's docstring extended by
    ``TIMER_DOC``; besides them the port's module holds only its own
    stage measurement."""
    rel = "occam/calibrate/timers.py"
    ref = _sources(SRC / "repro" / rel)
    port = _sources(SRC / "repro_torch" / rel)
    assert {k for k in port if "." not in k} == {
        "StageProfile", "TickTimers", "_TimerContext",
        "measure_stage_seconds", "measure_hop_seconds"}
    want = ref[name]
    if name == "TickTimers":
        assert want.count(TIMER_DOC[0]) == 1
        want = want.replace(*TIMER_DOC)
    assert port[name] == want


# The planning frontier, the STAP stage plan, the LM stage plan, the
# sharding context's resolution and the async engine: every definition
# the port keeps as the reference's text. search.py differs
# only in Candidate.placement / Candidate.deploy / Frontier.serve (an
# explicit device); serve/engine.py only where it packs and joins tensors,
# and, in the methods ENGINE_TRACED names, by the replacements it states.
ENGINE_OWN = {"AsyncEngine", "AsyncEngine.submit", "AsyncEngine._stage",
              "AsyncEngine._deliver"}
# The engine's ``occam.trace`` spans and records while torch.profiler
# records, each round's cause passed from ``_step`` to ``_dispatch``, and
# the docstrings that say the tick timer times the host's issue of a
# round on the GPU: each pair is the reference's text, found once, and
# the port's.
ENGINE_TRACED = {
    "AsyncEngine.__init__": [(
        "        self._staged: tuple | None = None   "
        "# (xs_on_device, segs, n_valid)\n",
        "        # (xs_on_device, segs, n_valid, cause)\n"
        "        self._staged: tuple | None = None\n"
        "        # rounds still on the device, counted while torch.profiler "
        "records\n"
        "        self._backlog = trace.DeviceBacklog()\n")],
    "AsyncEngine._cancel": [(
        "        req.future.cancel()\n",
        "        req.future.cancel()\n"
        "        if trace.enabled():\n"
        "            trace.record_request(req, trace.now_ns(), "
        "cancelled=True)\n")],
    "AsyncEngine._run": [(
        "            try:\n"
        "                await asyncio.wait_for(self._wake.wait(),\n"
        "                                       self._sleep_s(now))\n"
        "            except asyncio.TimeoutError:\n"
        "                pass\n",
        "            # asleep toward a queued partial's deadline, or with nothing\n"
        "            # queued: two names, so the device's idle gaps tell them "
        "apart\n"
        "            with trace.span(\"occam.engine.wait.held\" if "
        "self.queue.depth\n"
        "                            else \"occam.engine.wait.empty\") as sp:\n"
        "                if sp:\n"
        "                    sp.set(queued=self.queue.depth)\n"
        "                try:\n"
        "                    await asyncio.wait_for(self._wake.wait(),\n"
        "                                           self._sleep_s(now))\n"
        "                except asyncio.TimeoutError:\n"
        "                    pass\n")],
    "AsyncEngine._step": [
        ("rb:\n            self._staged = self._stage(rb)\n",
         "rb:\n            self._staged = self._stage(rb, \"full\")\n"),
        ("                self._staged = self._stage(rb)\n",
         "                self._staged = self._stage(rb, \"lookahead\")\n"),
        ("            self._dispatch(*self._stage(min(self.queue.depth, "
         "rb)))\n",
         "            self._dispatch(*self._stage(\n"
         "                min(self.queue.depth, rb),\n"
         "                \"drain\" if self._flushing else \"deadline\"))\n")],
    "AsyncEngine._dispatch": [
        ("n_valid: int) -> None:\n", "n_valid: int, cause: str) -> None:\n"),
        ("        partial is pumped through as a masked round.\"\"\"\n"
         "        ticket = self._session.submit(xs)\n"
         "        if n_valid < self._session.round_batch:\n"
         "            self._session.pump(allow_partial=True)\n"
         "        self._rounds[ticket.uid] = segs\n"
         "        self.metrics.observe_round(n_valid, "
         "self._session.round_batch)\n",
         "        partial is pumped through as a masked round. While\n"
         "        torch.profiler records, the span counts the rounds this "
         "engine\n"
         "        sent earlier that the device has not finished (never "
         "waiting).\"\"\"\n"
         "        with trace.span(\"occam.engine.dispatch\") as sp:\n"
         "            backlog = self._backlog.pending() if sp else 0\n"
         "            ticket = self._session.submit(xs)\n"
         "            if n_valid < self._session.round_batch:\n"
         "                self._session.pump(allow_partial=True)\n"
         "            self._rounds[ticket.uid] = segs\n"
         "            self.metrics.observe_round(n_valid, "
         "self._session.round_batch)\n"
         "            if sp:\n"
         "                self._backlog.mark(self._dep.device)\n"
         "                sp.set(round=ticket.uid, lanes=n_valid,\n"
         "                       round_batch=self._session.round_batch, "
         "cause=cause,\n"
         "                       device_backlog=backlog,\n"
         "                       requests=tuple(req.uid for req, _take in "
         "segs))\n")],
    "AsyncEngine.serving_stats": [(
        "        ``utilization[i]`` is the fraction of wall clock stage "
        "``i``'s\n"
        "        chips spent computing over the tick timer's rolling window: "
        "the\n"
        "        ring's tick duty cycle scaled by the stage's share of the\n"
        "        bottleneck (a stage whose per-replica time is half the\n"
        "        bottleneck's idles half of every tick — exactly what\n"
        "        sum-of-replicas planning trades against). Single-chip\n"
        "        deployments report the one chip's duty cycle.\"\"\"\n",
        "        ``utilization[i]`` is the tick timer's duty cycle over its\n"
        "        rolling window (the share of wall clock the host spent inside\n"
        "        tick calls) scaled by stage ``i``'s share of the bottleneck "
        "(a\n"
        "        stage whose per-replica time is half the bottleneck's idles "
        "half\n"
        "        of every tick — exactly what sum-of-replicas planning trades\n"
        "        against). Single-chip deployments report the one duty cycle. "
        "On\n"
        "        the GPU a tick call returns once its round is issued (a "
        "graph\n"
        "        replay is enqueued), so this is the host's issue of the "
        "rounds,\n"
        "        not device time: the device's busy time is in a\n"
        "        ``torch.profiler`` trace, beside the ``occam.trace`` "
        "spans.\"\"\"\n")],
    "AsyncEngine._utilization": [(
        "tuple[float, ...]:\n",
        "tuple[float, ...]:\n"
        "        \"\"\"Per-stage shares of the tick timer's duty cycle (host "
        "time in\n"
        "        tick calls; see :meth:`serving_stats`).\"\"\"\n")],
}
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
    want = _sources(SRC / "repro" / rel)[name]
    if rel == "occam/serve/engine.py":
        for old, new in ENGINE_TRACED.get(name, ()):
            assert want.count(old) == 1
            want = want.replace(old, new)
    assert _sources(SRC / "repro_torch" / rel)[name] == want


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
    ``_deliver`` (``torch.cat``); and in the methods whose changes
    ``ENGINE_TRACED`` states (the ``occam.trace`` spans and records, the
    round's cause, the tick timer's docstrings)."""
    rel = "occam/serve/engine.py"
    port = _sources(SRC / "repro_torch" / rel)
    ref = _sources(SRC / "repro" / rel)
    assert set(port) == set(ref)
    assert {k for k in port if port[k] != ref[k]} == \
        ENGINE_OWN | set(ENGINE_TRACED)


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
