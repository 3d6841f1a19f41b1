"""The port's span engine against the reference's: the oracle, the routes
(names and reasons), ``execute_partition`` under every engine on CPU
tensors, and model == machine traffic counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import chain as j_chain
from repro.core.partition import partition_cnn as j_partition_cnn
from repro.models import cnn as j_cnn
from repro.occam.registry import BackendError as JBackendError
from repro.runtime import span_engine as j_span_engine
from repro_torch import convert
from repro_torch.core.graph import chain
from repro_torch.core.partition import partition_cnn
from repro_torch.models import cnn
from repro_torch.occam.registry import BackendError
from repro_torch.runtime import span_engine

C, P = "conv", "pool"
TOL = dict(rtol=1e-4, atol=1e-4)

# (name, specs, hw, in_ch, residual edges, capacities, the reference
# engine that stands in for its interpret-mode kernel route)
NETS = [
    ("vgg_mini", [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0),
                  (C, 3, 1, 1, 16), (C, 3, 1, 1, 16), (P, 2, 2, 0, 0),
                  (C, 3, 1, 1, 16)], 16, 3, (), (2_000, 6_000), "scan"),
    # stride-2 option-A shortcut with channel zero-pad 4 -> 8
    ("res-s2", [(C, 3, 2, 1, 4), (P, 3, 2, 1, 0), (C, 3, 1, 1, 4),
                (C, 3, 1, 1, 4), (C, 3, 2, 1, 8), (C, 3, 1, 1, 8)], 16, 3,
     ((2, 4), (4, 6)), (300, 700, 5_000), "scan"),
    # the reference's scan of a k=11 span compiles for ~25 s on a CPU, so
    # its oracle engine stands in there
    ("alex-stem", [(C, 11, 4, 0, 8), (P, 3, 2, 0, 0), (C, 5, 1, 2, 8),
                   (P, 3, 2, 0, 0)], 35, 3, (), (2_000, 20_000), "oracle"),
]
CASES = [(name, specs, hw, ch, edges, cap, twin)
         for name, specs, hw, ch, edges, caps, twin in NETS for cap in caps]
IDS = [f"{c[0]}-{c[5]}" for c in CASES]


def build(specs, hw, ch, edges, batch=2, seed=0):
    net = chain("t", specs, in_h=hw, in_w=hw, in_ch=ch,
                residual_edges=edges)
    j_net = j_chain("t", specs, in_h=hw, in_w=hw, in_ch=ch,
                    residual_edges=edges)
    rng = np.random.default_rng(seed)
    params = []
    for layer in net.layers:
        if layer.kind == "conv":
            fan_in = layer.k * layer.k * layer.in_ch
            params.append({
                "w": (rng.standard_normal(
                    (layer.k, layer.k, layer.in_ch, layer.out_ch),
                    np.float32) * np.sqrt(2.0 / fan_in)).astype(np.float32),
                "b": rng.standard_normal((layer.out_ch,), np.float32)
                * np.float32(0.1)})
        else:
            params.append({})
    xs = rng.standard_normal((batch, hw, hw, ch), np.float32)
    return net, j_net, params, xs


def jax_params(params):
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in params]


@pytest.mark.parametrize("name,specs,hw,ch,edges,cap,twin", CASES[::2],
                         ids=IDS[::2])
def test_reference_forward_matches_reference(name, specs, hw, ch, edges,
                                             cap, twin):
    net, j_net, params, xs = build(specs, hw, ch, edges)
    got = cnn.reference_forward(convert.params_from_numpy(params),
                                torch.from_numpy(xs), net, collect=True)
    want = jax.vmap(lambda im: j_cnn.reference_forward(
        jax_params(params), im, j_net, collect=True))(jnp.asarray(xs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name,specs,hw,ch,edges,cap,twin", CASES, ids=IDS)
def test_plan_routes_match_reference(name, specs, hw, ch, edges, cap, twin):
    net, j_net, _p, _x = build(specs, hw, ch, edges)
    part, j_part = partition_cnn(net, cap), j_partition_cnn(j_net, cap)
    assert part.boundaries == j_part.boundaries
    for backend in ("auto", "pallas", "scan", "oracle", "interpreted"):
        for out_rows in (1, 2):
            try:
                want = j_span_engine.plan_routes(j_net, j_part,
                                                 backend=backend,
                                                 out_rows=out_rows)
            except JBackendError as e:
                with pytest.raises(BackendError) as got_err:
                    span_engine.plan_routes(net, part, backend=backend,
                                            out_rows=out_rows)
                assert str(got_err.value) == str(e)
                continue
            got = span_engine.plan_routes(net, part, backend=backend,
                                          out_rows=out_rows)
            assert [(r.start, r.end, r.route, r.reason) for r in got] == \
                [(r.start, r.end, r.route, r.reason) for r in want]
    assert span_engine.ROUTE_KERNEL == j_span_engine.ROUTE_PALLAS


@pytest.mark.parametrize("name,specs,hw,ch,edges,cap,twin", CASES, ids=IDS)
def test_execute_partition_matches_reference(name, specs, hw, ch, edges,
                                             cap, twin):
    """Every engine of the port on CPU tensors equals the reference's
    execute_partition (its kernel-routed spans run on ``twin``), and the
    counters equal predicted_transfers x batch."""
    net, j_net, params, xs = build(specs, hw, ch, edges)
    part, j_part = partition_cnn(net, cap), j_partition_cnn(j_net, cap)
    j_routes = tuple(
        j_span_engine.SpanRoute(r.start, r.end,
                                twin if r.route == "pallas" else r.route,
                                r.reason)
        for r in j_span_engine.plan_routes(j_net, j_part))
    want = np.asarray(j_span_engine.execute_partition(
        jax_params(params), jnp.asarray(xs), j_net, j_part,
        routes=j_routes))
    tparams = convert.params_from_numpy(params)
    predicted = cnn.predicted_transfers(net, part.boundaries)
    assert predicted == j_cnn.predicted_transfers(j_net, j_part.boundaries)
    for backend in ("auto", "scan", "oracle", "interpreted"):
        try:
            routes = span_engine.plan_routes(net, part, backend=backend)
        except BackendError:
            assert backend == "scan"  # oversized single layers
            continue
        counter = cnn.TrafficCounter()
        got = span_engine.execute_partition(tparams, torch.from_numpy(xs),
                                            net, part, counter=counter,
                                            routes=routes)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=backend)
        assert counter.total == predicted * xs.shape[0]
        assert counter.total_bytes == 4.0 * counter.total


def test_init_params_matches_reference_structure():
    """Same layout, shapes and dtypes as the reference's init_params, with
    N(0, 1) x scale draws (values differ: torch.Generator vs jax.random)."""
    name, specs, hw, ch, edges, _caps, _twin = NETS[1]
    net, j_net, _p, _x = build(specs, hw, ch, edges)
    got = cnn.init_params(torch.Generator().manual_seed(0), net, scale=0.5)
    want = j_cnn.init_params(jax.random.PRNGKey(0), j_net, scale=0.5)
    assert [{k: tuple(v.shape) for k, v in p.items()} for p in got] == \
        [{k: tuple(v.shape) for k, v in p.items()} for p in want]
    w = torch.cat([p["w"].flatten() for p in got if p])
    assert all(p["w"].dtype == torch.float32 for p in got if p)
    assert 0.4 < float(w.std()) < 0.6
