"""The port's LM pipeline runtime (``runtime/pipeline.py``: ``plan_stages``
and ``pipeline_forward``, and ``stap_pipeline.replicated_forward`` behind
its ``plan=`` path) against the reference's, on the CPU.

Every position of the port's mesh sits on the CPU (``devices=["cpu"] *
n``); the reference runs on the emulated CPU devices of
``tests/conftest.py``. Inputs are made with numpy from a seed. Plans are
held field by field; outputs within the reference tests' 2e-5, the
pipelined Llama smoke decoder within 1e-4 of the JAX decoder. The
reference's own ``pipeline_forward`` without a plan is red under this
JAX (a ``ShardingTypeError`` on its output slice), so that path is held
against the sequential oracle, as its reference test does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import require_devices
from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as j_transformer
from repro.models.api import build_model as j_build_model
from repro.runtime import stap_pipeline as j_sp
from repro.runtime.pipeline import pipeline_forward as j_pipeline_forward
from repro.runtime.pipeline import plan_stages as j_plan_stages
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.core.stap import StapPlan
from repro_torch.models import transformer
from repro_torch.runtime import stap_pipeline as sp
from repro_torch.runtime.pipeline import pipeline_forward, plan_stages

TOL = dict(rtol=2e-5, atol=2e-5)

# (layer_weight_bytes, layer_act_bytes, layer_flops, boundary_act_bytes,
#  extra_chips) per model; each planned at the capacities beside it
_LLAMA_W = 60_821_504 * 4
_OLMOE_W = (4 * 2048 * 2048 + 64 * 3 * 2048 * 1024 + 2048 * 64 + 2 * 2048) * 4
_ATTN = 4 * 1024 * 1024 * 2048 / 2   # causal QK^T and PV, one sequence
PLAN_CASES = [
    ("test_runtime", [4e9] * 8, [0.0] * 8,
     [1e12, 1e12, 4e12, 4e12, 1e12, 1e12, 1e12, 1e12], 1e6, 2,
     [9e9]),
    ("llama3.2-1b", [_LLAMA_W] * 16, [4_194_304] * 16,
     [2 * 60_821_504 * 1024 + _ATTN] * 16, 8_388_608, 3,
     [5.0e8, 1.0e9, 2.0e9]),
    ("olmoe-1b-7b", [_OLMOE_W] * 16, [8_388_608] * 16,
     [2 * (4 * 2048 * 2048 + 8 * 3 * 2048 * 1024) * 1024 + _ATTN] * 16,
     8_388_608, 4, [2.0e9, 4.0e9, 8.0e9]),
]


def _plan_ids():
    return [f"{c[0]}-{cap:.0e}" for c in PLAN_CASES for cap in c[-1]]


@pytest.mark.parametrize("case,cap", [(c, cap) for c in PLAN_CASES
                                      for cap in c[-1]], ids=_plan_ids())
def test_plan_stages_equals_reference(case, cap):
    """Every field of the stage plan: partition (boundaries, spans,
    transfers, DP tables), spans, FLOPs and the STAP plan."""
    _, w, a, fl, boundary, extra, _ = case
    kw = dict(boundary_act_bytes=boundary, stage_capacity_bytes=cap,
              extra_chips=extra)
    got = plan_stages(w, a, fl, **kw)
    want = j_plan_stages(w, a, fl, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got = plan_stages(w, a, fl, chip_flops_per_s=67e12, **kw)
    want = j_plan_stages(w, a, fl, chip_flops_per_s=67e12, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_plan_stages_llama_at_one_gigabyte():
    """The chip path's plan: 4 layers a stage (989.9 MB; 5 would not
    fit), the first three stages replicated twice."""
    _, w, a, fl, boundary, _, _ = PLAN_CASES[1]
    plan = plan_stages(w, a, fl, boundary_act_bytes=boundary,
                       stage_capacity_bytes=1.0e9, chip_flops_per_s=67e12,
                       extra_chips=3)
    assert plan.stage_spans == ((0, 4), (4, 8), (8, 12), (12, 16))
    assert plan.stap.replicas == (2, 2, 2, 1)


def _tanh_inputs(s, m, mb=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((s, d, d)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((m, mb, d)).astype(np.float32)
    return ws, xs


def _sequential(ws, xs):
    """The reference test's oracle: every stage in turn, in JAX."""
    ref = jnp.asarray(xs)
    for w in ws:
        ref = jnp.tanh(ref @ jnp.asarray(w))
    return np.asarray(ref)


def _cpu_mesh(shape, axes):
    n = int(np.prod(shape))
    return sp.DeviceMesh(sp._grid([torch.device("cpu")] * n, shape), axes)


@pytest.mark.parametrize("m", [1, 3, 6])
def test_pipeline_forward_matches_sequential(m):
    ws, xs = _tanh_inputs(4, m)
    calls = []

    def stage_fn(w, x):
        calls.append(1)
        return torch.tanh(x @ w)

    out = pipeline_forward(stage_fn, torch.from_numpy(ws),
                           torch.from_numpy(xs), _cpu_mesh((4,), ("stage",)))
    assert out.shape == xs.shape
    np.testing.assert_allclose(out.numpy(), _sequential(ws, xs), **TOL)
    # inactive (stage, tick) pairs are skipped: S x M calls
    assert len(calls) == 4 * m


def test_pipeline_forward_dict_params_and_a_wider_mesh():
    """Stage params as a dict of stacked leaves; the stage axis of a 2-D
    mesh (the other axis at index 0)."""
    ws, xs = _tanh_inputs(4, 5, seed=3)
    bs = np.random.default_rng(4).standard_normal((4, 8)).astype(np.float32)
    out = pipeline_forward(
        lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
        {"w": torch.from_numpy(ws), "b": torch.from_numpy(bs)},
        torch.from_numpy(xs), _cpu_mesh((4, 2), ("stage", "data")))
    ref = jnp.asarray(xs)
    for w, b in zip(ws, bs):
        ref = jnp.tanh(ref @ jnp.asarray(w) + jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("as_plan", [False, True], ids=["counts", "StapPlan"])
def test_pipeline_forward_replicated_matches_reference(as_plan):
    """plan=(1, 2, 1) on a 3 x 2 mesh, against the reference's own
    ``pipeline_forward(..., plan=(1, 2, 1))`` on 6 emulated devices."""
    require_devices(6)
    ws, xs = _tanh_inputs(3, 4, seed=1)

    def j_stage(w, x):
        return jnp.tanh(x @ w)

    want = j_pipeline_forward(j_stage, jnp.asarray(ws), jnp.asarray(xs),
                              j_sp.stap_mesh(3, 2), plan=(1, 2, 1))
    plan = (1, 2, 1)
    if as_plan:
        plan = StapPlan((1.0, 1.0, 1.0), (1, 2, 1), 1.0, 3.0, 4)
    got = pipeline_forward(lambda w, x: torch.tanh(x @ w),
                           torch.from_numpy(ws), torch.from_numpy(xs),
                           sp.stap_mesh(3, 2, devices=["cpu"] * 6),
                           plan=plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), _sequential(ws, xs), **TOL)


def test_replicated_forward_shares_stage_tensors():
    """Replicas on one device take views of the stage's row, no copy."""
    ws, xs = _tanh_inputs(3, 5, seed=2)
    w = torch.from_numpy(ws)
    seen = {}

    def stage_fn(p, x):
        seen.setdefault(p.data_ptr(), set()).add(id(p))
        return torch.tanh(x @ p)

    plan = StapPlan((1.0, 1.0, 1.0), (2, 1, 2), 1.0, 3.0, 5)
    got = sp.replicated_forward(stage_fn, w, torch.from_numpy(xs),
                                sp.stap_mesh(3, 2, devices=["cpu"] * 6),
                                plan)
    np.testing.assert_allclose(got.numpy(), _sequential(ws, xs), **TOL)
    assert sorted(seen) == sorted(w[i].data_ptr() for i in range(3))
    assert all(len(ids) == 1 for ids in seen.values())


def test_mismatched_mesh_raises():
    """A mesh whose replica axis differs from the schedule's width fails
    loudly, as the reference's ``test_mismatched_mesh_raises``."""
    mesh = sp.stap_mesh(3, 2, devices=["cpu"] * 6)
    ws, xs = torch.zeros((3, 4, 4)), torch.zeros((2, 2, 4))
    with pytest.raises(ValueError, match="schedule needs"):
        pipeline_forward(lambda w, x: x @ w, ws, xs, mesh, plan=(1, 1, 1))
    with pytest.raises(ValueError, match="stage_params hold 3 stages"):
        pipeline_forward(lambda w, x: x @ w, ws, xs,
                         _cpu_mesh((4,), ("stage",)))


@pytest.mark.parametrize("plan", [None, (1, 2, 2, 1)],
                         ids=["gpipe", "replicated"])
def test_llama_smoke_pipeline_matches_jax_decoder(plan):
    """The Llama smoke config at 8 layers, 2 per stage over 4 stages, 3
    microbatches of 2 x 16 embedded tokens, each stage an
    ``nn.ModuleList`` slice of the decoder's layers: against the JAX
    decoder stack on the same (converted) parameters, within 1e-4."""
    j_cfg = dataclasses.replace(j_get_smoke("llama3.2-1b"), n_layers=8)
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), n_layers=8)
    params_np = jax.tree.map(np.asarray, j_build_model(
        j_cfg, dtype=jnp.float32).init(jax.random.PRNGKey(0)))
    params = convert.lm_params_from_numpy(params_np, cfg, "cpu")
    m, mb, s = 3, 2, 16
    rng = np.random.default_rng(5)
    x = rng.standard_normal((m * mb, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (m * mb, s)).copy()
    want, _, _ = jax.jit(lambda p, x_, pos_: j_transformer.decoder_stack(
        p, x_, j_cfg, pos_))(jax.tree.map(jnp.asarray, params_np),
                             jnp.asarray(x), jnp.asarray(pos))
    positions = torch.from_numpy(pos[:mb])
    seen = set()

    def stage_fn(layers_, h):
        seen.update(id(layer) for layer in layers_)
        for layer in layers_:
            h, _, _ = transformer._sublayer_apply(
                layer, h, cfg, positions, None, None, "flash", "kernel")
        return h

    stages = [params.layers[2 * i:2 * i + 2] for i in range(4)]
    mesh = _cpu_mesh((4,), ("stage",)) if plan is None else \
        sp.stap_mesh(4, 2, devices=["cpu"] * 8)
    with torch.no_grad():
        got = pipeline_forward(stage_fn, stages,
                               torch.from_numpy(x).reshape(m, mb, s, -1),
                               mesh, plan=plan)
    np.testing.assert_allclose(got.reshape(m * mb, s, -1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)
    # every position ran the decoder's own layers: no stage was copied
    assert seen == {id(layer) for layer in params.layers}
