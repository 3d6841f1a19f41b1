"""``models/cnn.occam_forward`` (both modes), ``occam_forward_jit`` and
the deprecated one-call shims of ``models/api.py`` against the reference
on the CPU.

The nets are those of ``tests/test_span_engine.py`` and
``tests/test_cnn_fused.py`` (with their partition boundaries); params and
images are made with numpy from a seed. Outputs agree within fp32 1e-4
and the transfer counts are equal; the shims equal the staged API bit for
bit."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import chain as j_chain
from repro.core.partition import partition_cnn as j_partition_cnn
from repro.models import api as j_api
from repro.models import cnn as j_cnn
from repro_torch import convert, occam
from repro_torch.core.graph import chain
from repro_torch.models import api, cnn

C, P = "conv", "pool"

NETS = [
    # (name, specs, hw, in_ch, residual edges, boundaries): the span
    # engine's grid, then the machine-vs-model nets
    ("k1-s1", [(C, 1, 1, 0, 4), (C, 1, 1, 0, 8)], 8, 3, (), []),
    ("k3-s1-deep", [(C, 3, 1, 1, 4), (C, 3, 1, 1, 8), (C, 3, 1, 1, 4)], 8, 3,
     (), []),
    ("k5-s1", [(C, 5, 1, 2, 4), (C, 5, 1, 2, 4)], 10, 2, (), []),
    ("k3-s2", [(C, 3, 2, 1, 4), (C, 3, 1, 1, 8)], 10, 3, (), []),
    ("mixed-k", [(C, 5, 1, 2, 4), (C, 1, 1, 0, 8), (C, 3, 2, 1, 8)], 10, 3,
     (), []),
    ("conv-pool-s2", [(C, 3, 1, 1, 4), (P, 2, 2, 0, 0), (C, 3, 2, 1, 8)], 12,
     3, (), [1]),
    ("pool-k3-s2-pad", [(C, 3, 1, 1, 4), (P, 3, 2, 1, 0)], 9, 3, (), []),
    ("vgg-block", [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0),
                   (C, 3, 1, 1, 16)], 8, 3, (), []),
    ("strided", [(C, 3, 2, 1, 4), (C, 3, 1, 1, 8), (C, 3, 2, 1, 8)], 16, 3,
     (), []),
    ("pooling", [(C, 5, 1, 2, 4), (P, 2, 2, 0, 0), (C, 3, 1, 1, 8),
                 (P, 3, 2, 1, 0)], 16, 3, (), []),
    ("partitioned", [(C, 3, 1, 1, 4)] * 5, 10, 3, (), [1, 3]),
    ("partitioned-all", [(C, 3, 1, 1, 4)] * 5, 10, 3, (), [1, 2, 3, 4]),
    ("residual-inside", [(C, 3, 1, 1, 4)] * 3, 12, 3, ((0, 2), (1, 3)), []),
    ("residual-downsample", [(C, 3, 2, 1, 8), (C, 3, 1, 1, 8)], 12, 4,
     ((0, 2),), []),
    ("residual-crossing", [(C, 3, 1, 1, 4)] * 4, 12, 3, ((1, 4),), [2]),
    ("traffic", [(C, 3, 1, 1, 4), (C, 3, 2, 1, 8), (C, 3, 1, 1, 8),
                 (C, 3, 1, 1, 4)], 16, 3, (), [1, 3]),
    ("dp-partition", [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0),
                      (C, 3, 1, 1, 16), (C, 3, 1, 1, 8)], 16, 4, (), "dp"),
]


def _case(specs, hw, ch, edges, bounds, seed=0):
    rng = np.random.default_rng(seed)
    j_net = j_chain("t", specs, in_h=hw, in_w=hw, in_ch=ch,
                    residual_edges=tuple(edges))
    net = chain("t", specs, in_h=hw, in_w=hw, in_ch=ch,
                residual_edges=tuple(edges))
    params = [{"w": (0.1 * rng.standard_normal(
                   (l.k, l.k, l.in_ch, l.out_ch))).astype(np.float32),
               "b": (0.1 * rng.standard_normal(l.out_ch)).astype(np.float32)}
              if l.kind == "conv" else {} for l in net.layers]
    xs = rng.standard_normal((2, hw, hw, ch)).astype(np.float32)
    if bounds == "dp":
        bounds = j_partition_cnn(j_net, 3000).boundaries
        assert len(bounds) >= 1  # the capacity forces a split
    return j_net, net, params, xs, list(bounds)


@pytest.mark.parametrize("name,specs,hw,ch,edges,bounds", NETS,
                         ids=[n[0] for n in NETS])
def test_occam_forward_matches_reference(name, specs, hw, ch, edges,
                                         bounds):
    """Both modes per image and as a batch, and ``occam_forward_jit``,
    against the reference's ``occam_forward`` per image (its default,
    compiled mode; its own tests hold its interpreted mode to it):
    outputs within fp32 1e-4, transfers equal (a batch counts per
    image)."""
    j_net, net, params, xs, bounds = _case(specs, hw, ch, edges, bounds)
    j_params = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    t_params = convert.params_from_numpy(params)
    want_ctr = j_cnn.TrafficCounter()
    want = np.stack([np.asarray(j_cnn.occam_forward(
        j_params, jnp.asarray(x), j_net, bounds, want_ctr)) for x in xs])
    for mode in ("compiled", "interpreted"):
        got_ctr = cnn.TrafficCounter()
        got = [cnn.occam_forward(t_params, torch.from_numpy(x), net, bounds,
                                 got_ctr, mode=mode).numpy() for x in xs]
        np.testing.assert_allclose(np.stack(got), want, rtol=1e-4,
                                   atol=1e-4, err_msg=f"{name} {mode}")
        assert (got_ctr.reads, got_ctr.writes) == (want_ctr.reads,
                                                   want_ctr.writes)
        assert got_ctr.total == cnn.predicted_transfers(net, bounds) * 2
        batch_ctr = cnn.TrafficCounter()
        ys = cnn.occam_forward(t_params, torch.from_numpy(xs), net, bounds,
                               batch_ctr, mode=mode)
        np.testing.assert_allclose(ys.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} {mode} batch")
        assert batch_ctr.total == want_ctr.total
    jit = cnn.occam_forward_jit(t_params, torch.from_numpy(xs[0]), net,
                                tuple(bounds))
    np.testing.assert_allclose(jit.numpy(), want[0], rtol=1e-4, atol=1e-4,
                               err_msg=f"{name} jit")


def test_params_accessors():
    span = [{"w": torch.ones(1), "b": torch.zeros(1)}, {}]
    assert cnn.params_w(span, 1) is span[0]["w"]
    assert cnn.params_b(span, 1) is span[0]["b"]


def test_occam_forward_rejects_a_bad_mode():
    net = chain("t", [(C, 3, 1, 1, 4)], in_h=8, in_w=8, in_ch=3)
    with pytest.raises(ValueError, match="bad mode"):
        cnn.occam_forward([{}], torch.zeros(8, 8, 3), net, mode="jit")


def _warned(fn, *args, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    (w,) = [c for c in caught if c.category is DeprecationWarning]
    assert "is deprecated; use repro_torch.occam" in str(w.message)
    return out


def _j_warned(fn, *args, **kw):
    """The reference's shim, its own warning swallowed."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


def test_span_executor_warns_and_equals_the_staged_api():
    """Bit for bit the port's staged API; within fp32 1e-4 the reference's
    shim on the same params and images, with the same partition and the
    same transfers."""
    j_net, net, np_params, np_xs, _ = _case(*NETS[-1][1:])
    params = convert.params_from_numpy(np_params)
    xs = torch.from_numpy(np_xs)
    ctr = cnn.TrafficCounter()
    y, part = _warned(api.span_executor, params, xs, net, 3000,
                      counter=ctr, device="cpu")
    dep = occam.plan(net, 3000, batch=2).place().compile(device="cpu")
    assert torch.equal(y, dep.run(params, xs))
    assert part.boundaries == dep.plan.partition.boundaries
    j_ctr = j_cnn.TrafficCounter()
    j_y, j_part = _j_warned(
        j_api.span_executor,
        [{k: jnp.asarray(v) for k, v in p.items()} for p in np_params],
        jnp.asarray(np_xs), j_net, 3000, counter=j_ctr)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), rtol=1e-4,
                               atol=1e-4)
    assert part.boundaries == j_part.boundaries
    assert (ctr.reads, ctr.writes) == (j_ctr.reads, j_ctr.writes)


def test_stap_executor_warns_and_equals_the_staged_api():
    """Bit for bit the port's staged API; within fp32 1e-4 the reference's
    shim on the same params and images, with the same STAP plan (stage
    times, replicas) and conveyor traffic. The port is given as many CPU
    positions as the reference sees devices, since both cap replication
    at the devices they have."""
    j_net, net, np_params, np_xs, _ = _case(*NETS[-1][1:])
    params = convert.params_from_numpy(np_params)
    xs = torch.from_numpy(np_xs)
    devices = [torch.device("cpu")] * jax.device_count()
    y, pipe = _warned(api.stap_executor, params, xs, net, 3000, max_chips=4,
                      devices=devices, device="cpu")
    dep = occam.plan(net, 3000).place(
        chips=4, microbatch=1, devices=devices,
        pipeline=True).compile(device="cpu")
    assert torch.equal(y, dep.run(params, xs))
    assert type(pipe).__name__ == "StapPipeline"
    j_y, j_pipe = _j_warned(
        j_api.stap_executor,
        [{k: jnp.asarray(v) for k, v in p.items()} for p in np_params],
        jnp.asarray(np_xs), j_net, 3000, max_chips=4)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), rtol=1e-4,
                               atol=1e-4)
    assert dataclasses.asdict(pipe.plan) == dataclasses.asdict(j_pipe.plan)
    assert pipe.conveyor_elems_per_image == j_pipe.conveyor_elems_per_image
    with pytest.raises(ValueError, match="batched"):
        _warned(api.stap_executor, params, xs[0], net, 3000, device="cpu")
