"""What the port executes across mesh positions, against the reference on
the CPU: the sharding context (``models/sharding.py``), the production
mesh (``launch/mesh.py``), the MoE layer's expert-parallel path
(``impl="ep_shard_map"``) and the compressed all-reduce
(``optim/compression.allreduce_compressed``).

The port's mesh positions all sit on the CPU; the reference runs on the
emulated CPU devices of ``tests/conftest.py``. Inputs are made with numpy
from a seed. Partition specs are held exactly; EP's output within the
reference test's 2e-4 / 2e-5 of the local path where nothing drops, and
within 1e-5 of the reference's per-shard formula where tokens drop; the
all-reduce's int32 sums exactly and its floats within 1e-6 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from conftest import require_devices
from repro.configs.base import MoECfg as JMoECfg
from repro.launch import mesh as j_mesh
from repro.models import moe as j_moe
from repro.models import sharding as j_sharding
from repro.optim import compression as j_compression
from repro_torch.configs.base import MoECfg
from repro_torch.launch import mesh
from repro_torch.models import moe, sharding
from repro_torch.optim import compression
from repro_torch.runtime import stap_pipeline as sp

# the no-drop config of tests/test_moe_parallel.py, and one with drops
B, S, D = 4, 16, 24
NO_DROP = dict(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=4.0)
DROPS = dict(NO_DROP, capacity_factor=1.0)


def _cpu_mesh(shape, axes):
    n = int(np.prod(shape))
    return sp.DeviceMesh(sp._grid([torch.device("cpu")] * n, shape), axes)


# ------------------------------------------------------------ the context

SYMBOLS = [None, "data", "model", "both", "act_seq", "cache_b", "cache_s",
           "heads"]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multi-pod"])
def test_resolve_equals_reference_specs(multi_pod):
    """Every symbol, alone and together, under a context whose
    ``symbols`` add one, single- and multi-pod."""
    require_devices(8)
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = j_mesh.data_axes(multi_pod) + ("model",)
    assert mesh.data_axes(multi_pod) == j_mesh.data_axes(multi_pod)
    extra = (("heads", "model"),)
    j_ctx = j_sharding.ShardCtx(jax.make_mesh(shape, axes),
                                data_axes=j_mesh.data_axes(multi_pod),
                                symbols=extra)
    ctx = sharding.ShardCtx(_cpu_mesh(shape, axes),
                            data_axes=mesh.data_axes(multi_pod),
                            symbols=extra)
    for want_axes in [(a,) for a in SYMBOLS] + [tuple(SYMBOLS)]:
        with j_sharding.use_shardings(j_ctx):
            want = j_sharding.resolve(*want_axes)
        with sharding.use_shardings(ctx):
            got = sharding.resolve(*want_axes)
            named = sharding.named(*want_axes)
        assert isinstance(want, JP)
        assert tuple(got) == tuple(want), want_axes
        assert named.mesh is ctx.mesh and named.spec == got
    with sharding.use_shardings(ctx), pytest.raises(ValueError,
                                                     match="unknown"):
        sharding.resolve("nope")


def test_context_is_scoped_and_shard_is_the_identity():
    ctx = sharding.ShardCtx(_cpu_mesh((1, 2), ("data", "model")))
    x = torch.ones(3)
    assert sharding.current_ctx() is None and sharding.named("data") is None
    with sharding.use_shardings(ctx):
        assert sharding.current_ctx() is ctx
        assert sharding.shard(x, "data") is x
        with sharding.use_shardings(None):
            assert sharding.current_ctx() is None
        assert sharding.current_ctx() is ctx
    assert sharding.current_ctx() is None
    assert repr(sharding.P("data", None)) == "P('data', None)"


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multi-pod"])
def test_production_mesh(multi_pod):
    n = 512 if multi_pod else 256
    got = mesh.make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * n)
    want = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    assert got.shape == want
    assert got.axis_names == tuple(want)
    assert set(got.flat) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="devices="):
        mesh.make_production_mesh(multi_pod=multi_pod,
                                  devices=["cpu"] * (n - 1))


def test_mesh_along_an_axis():
    devs = [torch.device("cpu", i) for i in range(6)]
    m = sp.DeviceMesh(sp._grid(devs, (2, 3)), ("stage", "replica"))
    assert m.along("stage") == [devs[0], devs[3]]
    assert m.along("replica") == devs[:3]


# ------------------------------------------------------ expert parallelism

def _moe_inputs(cfg_kw, b=B, seed=0):
    """The reference's MoE params (numpy) and tokens, and the port's."""
    j_cfg, cfg = JMoECfg(**cfg_kw), MoECfg(**cfg_kw)
    p = jax.tree.map(np.asarray, j_moe.init_moe(
        jax.random.PRNGKey(seed), D, j_cfg, dtype=jnp.float32))
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, S, D)).astype(np.float32)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    return j_cfg, cfg, p, x, tp


def _ep(tp, x, cfg, shape=(2, 4), impl="ep_shard_map"):
    ctx = sharding.ShardCtx(_cpu_mesh(shape, ("data", "model")))
    with sharding.use_shardings(ctx):
        return moe.moe_sublayer(tp, torch.from_numpy(x), cfg, impl=impl)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_ep_without_drops_matches_reference_local():
    j_cfg, cfg, p, x, tp = _moe_inputs(NO_DROP)
    want, _ = jax.jit(lambda p_, x_: j_moe.moe_sublayer(p_, x_, j_cfg))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    y, aux = _ep(tp, x, cfg)
    _close(y, want, 2e-4, 2e-5)
    assert set(aux) == {"load_balance_loss", "router_z_loss"}


def _per_shard_formula(j_cfg, p, x, dp, tp):
    """The reference's ``shmap_fn`` body without ``shard_map``: JAX's
    ``_local_moe`` per (data shard, model position) with its expert slice
    and ``e_start = r * E / tp``, the partials summed over the model
    positions; the losses of the first data shard."""
    e, el = j_cfg.n_experts, j_cfg.n_experts // tp
    bl = x.shape[0] // dp
    local = jax.jit(lambda xd, router, w1, w3, w2, e_start: j_moe._local_moe(
        xd, router, w1, w3, w2, e_total=e, k=j_cfg.top_k,
        cap_factor=j_cfg.capacity_factor, e_start=e_start,
        sentinel_t=xd.shape[0]))
    ys, aux0 = [], None
    for d in range(dp):
        xd = jnp.asarray(x[d * bl:(d + 1) * bl].reshape(-1, D))
        acc = 0.0
        for r in range(tp):
            sl = slice(r * el, (r + 1) * el)
            y2, aux = local(xd, jnp.asarray(p["router"]),
                            jnp.asarray(p["w1"][sl]),
                            jnp.asarray(p["w3"][sl]),
                            jnp.asarray(p["w2"][sl]), r * el)
            acc = acc + y2
            aux0 = aux if aux0 is None else aux0
        ys.append(np.asarray(acc).reshape(bl, S, D))
    return np.concatenate(ys), aux0


def test_ep_with_drops_matches_reference_per_shard_formula():
    """capacity_factor 1.0: tokens drop per data shard's capacity, so EP
    differs from the local path, in the reference too."""
    j_cfg, cfg, p, x, tp = _moe_inputs(DROPS)
    want, (lb, z) = _per_shard_formula(j_cfg, p, x, 2, 4)
    y, aux = _ep(tp, x, cfg)
    _close(y, want, 1e-5, 1e-5)
    _close(aux["load_balance_loss"], lb, 1e-5, 1e-5)
    _close(aux["router_z_loss"], z, 1e-5, 1e-5)
    local, _ = moe.moe_sublayer(tp, torch.from_numpy(x), cfg, impl="local")
    assert float((local - y).abs().max()) > 1e-3


@pytest.mark.parametrize("impl", ["ep_shard_map", "local"])
@pytest.mark.parametrize("b", [B, 3], ids=["sharded", "replicated"])
def test_ep_matches_reference_ep_on_a_mesh(b, impl):
    """The reference's own ``moe_sublayer`` on a (2, 4) mesh of emulated
    devices, with drops; a batch of 3 does not divide the data axis and
    is replicated over it, in both. Under a context an explicit
    ``"local"`` runs EP too, in both."""
    require_devices(8)
    j_cfg, cfg, p, x, tp = _moe_inputs(DROPS, b=b, seed=2)
    j_ctx = j_sharding.ShardCtx(jax.make_mesh((2, 4), ("data", "model")))
    with j_sharding.use_shardings(j_ctx):
        want, j_aux = jax.jit(lambda p_, x_: j_moe.moe_sublayer(
            p_, x_, j_cfg, impl=impl))(
                jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    y, aux = _ep(tp, x, cfg, impl=impl)
    _close(y, want, 1e-5, 1e-5)
    for name in j_aux:
        _close(aux[name], j_aux[name], 1e-5, 1e-5)


def test_default_impl_under_a_context_is_ep(monkeypatch):
    _, cfg, _, x, tp = _moe_inputs(DROPS)
    calls = []
    ep = moe._moe_ep

    def spy(*a, **kw):
        calls.append(1)
        return ep(*a, **kw)

    monkeypatch.setattr(moe, "_moe_ep", spy)
    y, _ = _ep(tp, x, cfg, impl=None)
    assert len(calls) == 1
    want, _ = _ep(tp, x, cfg)
    assert torch.equal(y, want)
    moe.moe_sublayer(tp, torch.from_numpy(x), cfg)   # no context: local
    assert len(calls) == 2


def test_ep_experts_must_divide_the_model_axis():
    _, cfg, _, x, tp = _moe_inputs(DROPS)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        _ep(tp, x, cfg, shape=(1, 3))


# ------------------------------------------------- the compressed all-reduce

def _grad_trees(n=4, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    return [[(rng.standard_normal(s) * (i + 1)).astype(np.float32)
             for s in shapes] for i in range(n)]


def _reference_allreduce():
    """The reference's ``allreduce_compressed`` once per participant
    inside ``shard_map`` over 4 emulated devices: f(trees, residuals) ->
    (means, new residuals), each leaf stacked over the participants."""
    mesh_ = jax.make_mesh((4,), ("data",))

    def body(gs, rs):
        mean, st = j_compression.allreduce_compressed(
            [g[0] for g in gs], j_compression.EFState([r[0] for r in rs]),
            "data", 4)
        return [m[None] for m in mean], [r[None] for r in st.residual]

    spec = [JP("data")] * 3
    f = jax.jit(j_sharding.shard_map_compat(
        body, mesh=mesh_, in_specs=(spec, spec), out_specs=(spec, spec),
        check_vma=False))

    def run(trees, residuals):
        mean, new_res = f([jnp.asarray(np.stack(leaf))
                           for leaf in zip(*trees)],
                          [jnp.asarray(np.stack(leaf))
                           for leaf in zip(*residuals)])
        return [np.asarray(m) for m in mean], [np.asarray(r)
                                               for r in new_res]

    return run


def test_allreduce_compressed_matches_reference():
    """Two rounds (the second on the first round's residuals): each
    position's mean and new residual against the reference's per
    participant (floats within 1e-6 of each tensor's max); each
    position's int8 payload, and their int32 sum, exactly the
    reference's ``compress``'s."""
    require_devices(4)
    m4 = _cpu_mesh((4,), ("data",))
    trees = _grad_trees()
    residuals = [[np.zeros_like(g) for g in t] for t in trees]
    states = [compression.init_ef([torch.from_numpy(g) for g in t])
              for t in trees]
    reference = _reference_allreduce()
    for _ in range(2):
        for leaf in range(3):
            got_q = [compression.compress(
                torch.from_numpy(t[leaf]), st.residual[leaf])[0]
                for t, st in zip(trees, states)]
            want_q = [np.asarray(j_compression.compress(
                jnp.asarray(t[leaf]), jnp.asarray(r[leaf]))[0])
                for t, r in zip(trees, residuals)]
            for g, w in zip(got_q, want_q):
                np.testing.assert_array_equal(g.numpy(), w)
            np.testing.assert_array_equal(
                sum(q.to(torch.int32) for q in got_q).numpy(),
                np.sum(np.stack(want_q).astype(np.int32), axis=0))
        grads = [[torch.from_numpy(g) for g in t] for t in trees]
        means, states = compression.allreduce_compressed(grads, states, m4,
                                                         "data")
        want_mean, want_res = reference(trees, residuals)
        for p in range(4):
            for leaf, got in enumerate(means[p]):
                _close(got, want_mean[leaf][p], 1e-6,
                       1e-6 * np.abs(want_mean[leaf]).max())
                _close(states[p].residual[leaf], want_res[leaf][p], 1e-6,
                       1e-6 * np.abs(trees[p][leaf]).max())
        residuals = [[np.asarray(r[p]) for r in want_res] for p in range(4)]


def test_allreduce_compressed_checks_the_positions():
    m4 = _cpu_mesh((4,), ("data",))
    g = [[torch.zeros(2)]] * 3
    with pytest.raises(ValueError, match="4 positions"):
        compression.allreduce_compressed(
            g, [compression.init_ef(t) for t in g], m4, "data")
