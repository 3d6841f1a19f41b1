"""The example twins (``repro_torch.examples``) on the CPU at their
smallest arguments: each ``main(["--device", "cpu", ...])`` runs, its
own self-checks hold, and what it plans and computes is held against the
JAX package on the same inputs: plans and frontiers equal, outputs
within fp32 1e-4 (of the largest magnitude, for logits and losses)."""
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import occam as j_occam
from repro.configs import get_smoke as j_get_smoke
from repro.core import traffic as j_traffic
from repro.core.closure import max_tile_rows as j_max_tile_rows
from repro.core.graph import chain as j_chain
from repro.core.partition import partition_cnn as j_partition_cnn
from repro.core.stap import plan_replication as j_plan_replication
from repro.core.stap import simulate as j_simulate
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import cnn as j_cnn
from repro.models import zoo as j_zoo
from repro.models.api import build_model as j_build_model
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.models.api import build_model, make_batch

from repro_torch.examples import (async_serve, occam_cnn_pipeline,
                                  quickstart, serve_pipeline, train_tiny_lm)
from repro_torch.launch import train as trainer


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module: the CPU runs the kernels'
    plain versions as many tiny operations, which torch's default thread
    pool slows many times over on a host that parallel test workers load
    (as ``tests/test_torch_async_engine.py`` found)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_params(params):
    return [{k: v.detach().cpu().numpy() for k, v in p.items()}
            for p in params]


def _jax_params(params):
    return [{k: jnp.asarray(v) for k, v in p.items()}
            for p in _np_params(params)]


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _plain(obj):
    """Dataclasses as dicts, recursively, so that the two packages' twin
    classes compare by value."""
    if dataclasses.is_dataclass(obj):
        return _plain(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _close_scaled(got, want, tol=1e-4):
    """max|got - want| within tol x max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_quickstart(capsys):
    out = quickstart.main(["--device", "cpu"])
    net, cap = j_zoo.get_network("resnet18"), quickstart.CAP
    part = j_partition_cnn(net, cap)
    assert out["boundaries"] == part.boundaries
    assert out["tiles"] == [j_max_tile_rows(net, sp.start, sp.end, cap)
                            for sp in part.spans]
    assert _plain(out["schemes"]) == _plain(j_traffic.compare_schemes(net,
                                                                      cap))
    splan = j_plan_replication([15, 35, 40, 10], target_period=20)
    stats = j_simulate(splan, n_jobs=100,
                       arrival_period=splan.bottleneck_period)
    assert out["stap_replicas"] == list(splan.replicas)
    assert out["stap_stats"] == (stats.throughput, stats.mean_latency)
    # the tiny net: the same frontiers and plans, and the reference's
    # deployment on the same params and image gives the same output and
    # the same measured transfers
    tiny = j_chain("tiny", quickstart.TINY, in_h=16, in_w=16, in_ch=3)
    frontier = j_occam.autoplan(tiny, j_occam.Fleet(chips=1,
                                                    vmem_elems=3000))
    assert out["frontier"].to_dict() == frontier.to_dict()
    n_spans = frontier.best("traffic").plan.n_spans
    assert out["big_frontier"].to_dict() == j_occam.autoplan(
        tiny, j_occam.Fleet(chips=2 * n_spans + 2,
                            vmem_elems=3000)).to_dict()
    assert out["plan_t2"].to_dict() == j_occam.plan(
        tiny, 3000, out_rows=2).to_dict()
    assert out["plan_q"].to_dict() == j_occam.plan(
        tiny, 3000, dtype_policy="int8").to_dict()
    params, x = _jax_params(out["params"]), jnp.asarray(out["x"].numpy())
    dep = frontier.best("traffic").deploy()
    _close(out["y"], dep.run(params, x))
    assert out["measured_elems"] == int(dep.report().measured_elems)
    _close(out["y_t2"], j_cnn.reference_forward(params, x, tiny))
    assert "honest plan passes clean" in capsys.readouterr().out


def test_occam_cnn_pipeline(capsys):
    """Planning only: its numbers are the reference's."""
    out = occam_cnn_pipeline.main([])
    assert out["n_spans"] == 10  # the paper's Table II
    net = j_zoo.get_network("resnet34")
    cap = occam_cnn_pipeline.CAP
    plan = j_occam.autoplan(net, j_occam.Fleet(chips=16, vmem_elems=cap),
                            objective="throughput").best("traffic").plan
    part = plan.partition
    assert out["boundaries"] == list(plan.boundaries)
    assert out["traffic_cut"] == (
        j_traffic.base_traffic(net).offchip_elems
        / j_traffic.occam_traffic(net, cap, partition=part).offchip_elems)
    assert [c for c, _, _ in out["fleet_sweep"]] == [10, 20, 40]
    assert "for_rate(" in capsys.readouterr().out


def test_serve_pipeline(capsys):
    """Each arch's 16 greedy tokens equal the reference's on the same
    params (``serve``'s seed-0 draw, converted) and prompt, and its
    prefill's logits agree within 1e-4 x max|logits|."""
    out = serve_pipeline.main(["--device", "cpu"])
    assert set(out) == set(serve_pipeline.ARCHS)
    assert capsys.readouterr().out.rstrip().endswith("serving OK")
    for arch, r in out.items():
        assert tuple(r["tokens"].shape) == (4, 16)
        assert r["tokens"].device.type == "cpu"
        cfg = get_smoke(arch)
        api = build_model(cfg, dtype=torch.float32, device="cpu")
        params = api.init(torch.Generator("cpu").manual_seed(0))
        prompt = make_batch(cfg, 4, 32,
                            generator=torch.Generator().manual_seed(1),
                            device="cpu")
        logits, _ = api.prefill(params, {"tokens": prompt["tokens"]}, 48)
        j_api = j_build_model(j_get_smoke(arch), dtype=jnp.float32)
        j_params = jax.tree.map(jnp.asarray,
                                convert.lm_params_to_numpy(params, cfg))
        j_logits, caches = jax.jit(lambda p, b: j_api.prefill(p, b, 48))(
            j_params, {"tokens": jnp.asarray(prompt["tokens"].numpy())})
        _close_scaled(logits.detach(), j_logits)
        tok = jnp.argmax(j_logits[:, -1], -1)[:, None].astype(jnp.int32)
        want = [tok]
        decode = jax.jit(j_api.decode_step)
        for i in range(15):
            j_logits, caches = decode(j_params, tok, caches,
                                      jnp.asarray(32 + i, jnp.int32))
            tok = jnp.argmax(j_logits[:, -1], -1)[:, None].astype(jnp.int32)
            want.append(tok)
        np.testing.assert_array_equal(r["tokens"].numpy(),
                                      np.asarray(jnp.concatenate(want, 1)))


def test_async_serve(capsys):
    """The frontier and the serving candidate's predicted traffic equal
    the reference's; every request's images equal the reference's
    forward on the same params and images."""
    out = async_serve.main(["--device", "cpu"])
    assert out["matches_prediction"] and out["compile_count"] == 1
    assert capsys.readouterr().out.rstrip().endswith("async serving OK")
    net = out["net"]
    j_net = j_chain(net.name, async_serve.SPECS, in_h=16, in_w=16, in_ch=3)
    frontier = j_occam.autoplan(j_net, j_occam.Fleet(chips=6,
                                                     vmem_elems=6000),
                                batch=2)
    assert out["frontier"].to_dict() == frontier.to_dict()
    best = frontier.best("throughput")
    round_batch = best.round_width * best.plan.batch
    assert [n for _, n in out["served"]] == [1, 3, round_batch, 2,
                                             2 * round_batch + 1]
    assert out["predicted_per_image"] == \
        list(frontier)[out["candidate"]].traffic
    params = _jax_params(out["params"])
    for xs, ys in out["requests"]:
        _close(ys, [j_cnn.reference_forward(params, jnp.asarray(x), j_net)
                    for x in xs.numpy()])


def _reference_example(name):
    """A module of the reference's ``examples/`` (its ``main`` is not
    run on import)."""
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"j_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_tiny_lm_restores_the_registry():
    """The config is the reference example's, and the first step's loss
    is the reference's loss on the same initial params (the trainer's
    seed-0 draw, converted) and the same first batch."""
    smoke = trainer.get_smoke
    out = train_tiny_lm.main(["--device", "cpu", "--steps", "2",
                              "--batch", "2", "--seq", "8"])
    assert trainer.get_smoke is smoke
    assert len(out["losses_phase1"]) == 1 and len(out["losses_phase2"]) == 2
    assert all(math.isfinite(x) for x in out["losses_phase2"])
    # no checkpoint before step 10: the restart trains from step 0 again
    assert out["losses_phase2"][0] == out["losses_phase1"][0]
    cfg = train_tiny_lm.tiny_100m()
    j_cfg = _reference_example("train_tiny_lm").tiny_100m()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    params = build_model(cfg, dtype=torch.float32, device="cpu").init(
        torch.Generator("cpu").manual_seed(0))
    j_params = jax.tree.map(jnp.asarray,
                            convert.lm_params_to_numpy(params, cfg))
    raw = JSyntheticLM(vocab=cfg.vocab, seq_len=8, global_batch=2,
                       seed=0).batch_at(0)
    j_loss, _ = j_build_model(j_cfg, dtype=jnp.float32).train_loss(
        j_params, {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")})
    _close_scaled(out["losses_phase1"][0], j_loss)
