"""The dry run's cells (``launch/specs.py``) and the sharding rules
(``transformer.param_spec_tree``, ``cache_axes``, ``shard_caches``)
against the reference on the CPU.

Partition specs, input stand-ins and shard contexts are held exactly:
the specs at full width for all ten configs (the reference's tree from
``jax.eval_shape``, the port's from the ``meta`` device, each port name
mapped to its reference path by ``convert.reference_path``). The port's
``arguments_bytes`` and ``alias_bytes`` equal the reference's compiled
``memory_analysis()`` on a (2, 4) mesh of the emulated CPU devices
(Auto axes: the reference's ``make_production_mesh`` builds Explicit
ones under this JAX, and its cells then fail). The ``meta`` FLOP count
equals ``FlopCounterMode`` over the same cell run on the CPU."""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from torch.utils.flop_counter import FlopCounterMode

from conftest import require_devices
from repro import configs as j_configs
from repro.launch import specs as j_specs
from repro.models import api as j_api
from repro.models import sharding as j_sharding
from repro.models import transformer as j_transformer
from repro_torch import configs, convert
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api, encdec, transformer
from repro_torch.runtime import stap_pipeline as sp

SMOKE_ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "mamba2-1.3b")
KINDS = ("train", "prefill", "decode")


def _meta_mesh(shape):
    n = int(np.prod(shape))
    return sp.DeviceMesh(sp._grid([torch.device("meta")] * n, shape),
                         ("data", "model"))


def _path_key(path) -> tuple[str, ...]:
    return tuple(getattr(p, "key", getattr(p, "name", "")) for p in path)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_spec_tree_equals_reference(arch):
    """Every parameter of the full-width config: the reference's rule
    (without its stacked leaf's leading None) for the port's name."""
    j_params = jax.eval_shape(j_api.build_model(j_configs.get_config(arch))
                              .init, jax.random.PRNGKey(0))
    j_tree = j_transformer.param_spec_tree(j_params)
    j_specs_by_path = {
        _path_key(path): spec for path, spec in
        jax.tree_util.tree_flatten_with_path(
            j_tree, is_leaf=lambda x: isinstance(x, tuple))[0]}
    cfg = configs.get_config(arch)
    params = api.build_model(cfg, device="meta").init()
    got = transformer.param_spec_tree(params)
    assert list(got) == [n for n, _ in params.named_parameters()]
    seen = set()
    for name, spec in got.items():
        path, index = convert.reference_path(name, cfg)
        want = j_specs_by_path[path]
        if index is not None:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert spec == want, (name, spec, want)
        seen.add(path)
    assert seen == set(j_specs_by_path)


def test_meta_init_draws_nothing_and_needs_meta():
    cfg = configs.get_smoke("llama3.2-1b")
    params = api.build_model(cfg, device="meta").init()
    assert all(p.is_meta for p in params.parameters())
    with pytest.raises(ValueError, match="meta device"):
        api.build_model(cfg, device="cpu").init()


@pytest.mark.parametrize("n", range(8))
def test_cache_axes_equal_reference(n):
    assert transformer.cache_axes(n) == j_transformer.cache_axes(n)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_shard_caches_returns_its_input(arch):
    cfg = configs.get_smoke(arch)
    caches = api.build_model(cfg, device="meta").init_caches(2, 8)
    assert transformer.shard_caches(caches) is caches
    mod = encdec if cfg.is_enc_dec else transformer
    assert mod.shard_caches is transformer.shard_caches


def _cells():
    return [(arch, name) for arch in configs.ARCHS
            for name in configs.applicable_shapes(configs.get_config(arch))]


@pytest.mark.parametrize("arch,shape_name", _cells())
def test_input_specs_equal_reference(arch, shape_name):
    want = j_specs.input_specs(j_configs.get_config(arch),
                               j_configs.SHAPE_GRID[shape_name])
    got = specs.input_specs(configs.get_config(arch),
                            configs.SHAPE_GRID[shape_name])
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.is_meta
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == want[k].dtype.name, k


@pytest.mark.parametrize("act_seq", ["1", "0"])
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod", "multi-pod"])
def test_make_ctx_and_batch_partition_equal_reference(monkeypatch, multi_pod,
                                                      act_seq):
    """The reference reads only ``mesh.shape``; both production meshes,
    every shape of the grid, the reference at its default sequence
    parallelism (on for training). The port reads no environment: with
    REPRO_ACT_SEQ set either way, its contexts are the reference's
    default ones."""
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    monkeypatch.setenv("REPRO_ACT_SEQ", act_seq)
    ctxs = {name: specs.make_ctx(mesh, multi_pod, shape)
            for name, shape in configs.SHAPE_GRID.items()}
    monkeypatch.delenv("REPRO_ACT_SEQ")
    j_mesh = types.SimpleNamespace(shape=mesh.shape)
    for name, ctx in ctxs.items():
        j_ctx = j_specs.make_ctx(j_mesh, multi_pod,
                                 j_configs.SHAPE_GRID[name])
        assert ctx.data_axes == j_ctx.data_axes
        assert ctx.model_axis == j_ctx.model_axis
        assert ctx.symbols == j_ctx.symbols, name
        for b in (1, 8, 32, 128, 256, 384):
            assert specs.batch_partition(ctx, b) == j_specs.batch_partition(
                j_ctx, b), (name, b)


def _smoke_shape(pkg, kind):
    return pkg.ShapeCfg(f"smoke_{kind}", 64, 8, kind)


@pytest.mark.parametrize("arch,kind", [(a, k) for a in SMOKE_ARCHS
                                       for k in KINDS]
                         + [("seamless-m4t-large-v2", "decode")])
def test_argument_and_alias_bytes_equal_reference_memory_analysis(arch,
                                                                  kind):
    """Batch 8 x 64 on a (2, 4) mesh: the reference's cell lowered and
    compiled by XLA, the port's counted from its specs (the
    encoder-decoder's decode reads no encoder weight, and XLA drops
    them)."""
    require_devices(8)
    j_mesh = jax.make_mesh((2, 4), ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2)
    j_shape = _smoke_shape(j_configs, kind)
    j_ctx = j_specs.make_ctx(j_mesh, False, j_shape)
    with j_sharding.use_shardings(j_ctx):
        cell = j_specs.build_cell(j_configs.get_smoke(arch), j_shape, j_ctx)
        mem = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                      donate_argnums=cell.donate_argnums).lower(
            *cell.args_sds).compile().memory_analysis()
    shape = _smoke_shape(configs, kind)
    ctx = specs.make_ctx(_meta_mesh((2, 4)), False, shape)
    rec = dryrun.cell_record(configs.get_smoke(arch), shape, ctx)
    got = rec["memory_per_device"]
    assert got["arguments_bytes"] == mem.argument_size_in_bytes
    assert got["alias_bytes"] == mem.alias_size_in_bytes


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_meta_flops_and_bytes_equal_a_cpu_run(arch, kind):
    """The record's ``flops_global`` equals FlopCounterMode over the cell
    drawn on the CPU and run there; on a (1, 1) mesh its arguments' and
    donated arguments' bytes equal the real tensors' (phase 18 of
    chip_smoke.py checks the same at full width on the card)."""
    cfg, shape = configs.get_smoke(arch), _smoke_shape(configs, kind)
    ctx = specs.make_ctx(_meta_mesh((1, 1)), False, shape)
    rec = dryrun.cell_record(cfg, shape, ctx)
    cell = specs.build_cell(cfg, shape, ctx,
                            generator=torch.Generator().manual_seed(0))
    leaves = [dryrun.flat_leaves(a, torch.Tensor) for a in cell.args]
    assert not any(t.is_meta for ts in leaves for t in ts)
    nbytes = [sum(t.numel() * t.element_size() for t in ts) for ts in leaves]
    # an attention-free model reads no position: its int32 pos goes
    unread = 4 if kind == "decode" and cfg.attention_free else 0
    mem = rec["memory_per_device"]
    assert sum(nbytes) - unread == mem["arguments_bytes"]
    assert sum(nbytes[i] for i in cell.donate_argnums) == mem["alias_bytes"]
    with FlopCounterMode(display=False) as counter:
        cell.fn(*cell.args)
    assert counter.get_total_flops() == rec["cost_per_device"][
        "flops_global"]
    assert rec["cost_per_device"]["flops"] == rec["cost_per_device"][
        "flops_global"]
