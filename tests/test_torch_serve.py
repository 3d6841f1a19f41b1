"""Single-device serving sessions (``Deployment.serve`` -> ``Session``) of
the port against the reference's: one step build serves every submit
size, partial rounds mask correctly (bit-identical lanes, masked lanes
excluded from outputs and measured traffic), ticket order, ``ready``,
the ``max_wait_ticks`` budget, ``max_pending`` backpressure, the serving
geometry, and an int8 session's byte-exact traffic. Everything runs on
the CPU, where the step runs eagerly; the CUDA-graph step is tested on
the card in ``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import occam as j_occam
from repro.core.graph import chain as j_chain
from repro_torch import occam
from repro_torch.core.graph import chain
from repro_torch.models import cnn

C, P = "conv", "pool"
CAPACITY = 6000
VGG = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16),
       (C, 3, 1, 1, 16), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16)]
TWO = [(C, 3, 1, 1, 4), (C, 3, 2, 1, 8)]


def _params(net, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for layer in net.layers:
        if layer.kind == "conv":
            shape = (layer.k, layer.k, layer.in_ch, layer.out_ch)
            out.append({
                "w": rng.standard_normal(shape, np.float32) * np.float32(0.1),
                "b": rng.standard_normal((layer.out_ch,), np.float32)
                * np.float32(0.1)})
        else:
            out.append({})
    return out


def _images(net, n, seed):
    rng = np.random.default_rng(100 + seed)
    return rng.standard_normal((n,) + net.map_shape(0), np.float32)


def _ref(params, net, xs):
    from repro_torch import convert

    return cnn.reference_forward(convert.params_from_numpy(params),
                                 torch.from_numpy(xs), net).numpy()


def _jax(params):
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in params]


def assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def served():
    """One single-device deployment shared by the session tests (the step
    is cached on the deployment, so every session at one round size
    shares ONE build)."""
    net = chain("vgg_mini", VGG, in_h=16, in_w=16, in_ch=3)
    plan = occam.plan(net, CAPACITY, batch=2)
    assert plan.n_spans == 3
    return net, _params(net), plan.place().compile(device="cpu")


# --------------------------------------------------------------------------
# One build across mixed submit sizes
# --------------------------------------------------------------------------

def test_one_compile_across_mixed_submit_sizes():
    net = chain("t", TWO, in_h=10, in_w=10, in_ch=3)
    j_net = j_chain("t", TWO, in_h=10, in_w=10, in_ch=3)
    params = _params(net)
    dep = occam.plan(net, 10**6).place().compile(device="cpu")
    j_dep = j_occam.plan(j_net, 10**6).place().compile(interpret=True)
    sess = dep.serve(params, round_batch=4)
    j_sess = j_dep.serve(_jax(params), round_batch=4)
    sizes = [1, 3, 9]
    xs = [_images(net, b, i) for i, b in enumerate(sizes)]
    tickets = [sess.submit(x) for x in xs]
    for x in xs:
        j_sess.submit(jnp.asarray(x))
    res, j_res = sess.results(), j_sess.results()
    assert sess.compile_count == j_sess.compile_count == 1
    assert [t.uid for t, _ in res] == [t.uid for t in tickets] == \
        [t.uid for t, _ in j_res]
    assert [t.images for t, _ in res] == sizes
    for (_t, y), (_jt, jy), x in zip(res, j_res, xs):
        assert y.shape[0] == x.shape[0]
        assert_close(y, jy)
        assert_close(y, _ref(params, net, x))
    rep = sess.report()
    assert rep.images == sum(sizes)
    assert rep.matches_prediction      # padded lanes never counted
    assert rep.measured_elems == j_sess.report().measured_elems
    # the flush did not end the session; a second session at the same
    # round size shares the build
    sess.submit(xs[1])
    (_t, y2), = sess.results()
    assert_close(y2, _ref(params, net, xs[1]))
    sess2 = dep.serve(params, round_batch=4)
    sess2.submit(xs[0])
    sess2.results()
    assert sess.compile_count == sess2.compile_count == 1
    assert dep.serve(params, round_batch=3).compile_count == 1
    assert sorted(dep._steps) == [3, 4]


# --------------------------------------------------------------------------
# Partial-final-round masking
# --------------------------------------------------------------------------

def test_partial_round_masked_lanes_bit_identical(served):
    """A flushed partial round computes its valid lanes bit-identically
    to a full round of the same images and to ``run`` at the round's
    size (masked lanes change nothing), and the padding never leaks into
    outputs."""
    net, params, dep = served
    s_full, s_part = dep.serve(params), dep.serve(params)
    rb = s_full.round_batch
    assert rb == 2                     # the placement microbatch
    s_full, s_part = (dep.serve(params, round_batch=4) for _ in range(2))
    rb = s_full.round_batch
    xs = _images(net, rb, 42)
    s_full.submit(xs)
    (_, y_full), = s_full.results()
    assert torch.equal(y_full, dep.run(params, xs))
    for n in range(1, rb):
        s_part.submit(xs[:n])
        (_, y_part), = s_part.results()
        assert y_part.shape[0] == n
        assert torch.equal(y_part, y_full[:n])


def test_session_report_masked_lanes_excluded(served):
    """measured_* counts valid lanes only: after any mix of submit sizes
    (with partial, masked final rounds) the per-image measurement equals
    the plan's prediction exactly."""
    net, params, dep = served
    sess = dep.serve(params, round_batch=4)
    rb = sess.round_batch
    sizes = [1, rb - 1, rb + 2, 1]
    for i, b in enumerate(sizes):
        sess.submit(_images(net, b, 60 + i))
    sess.results()
    rep = sess.report()
    assert rep.images == sum(sizes)
    assert rep.measured_elems == rep.images * rep.offchip_elems
    assert rep.matches_prediction
    assert rep.offchip_elems == cnn.predicted_transfers(
        net, dep.plan.boundaries)
    # two full rounds and one with a masked lane, each timed
    assert rep.serving.rounds_served == 3 == rep.timing["tick_count"]
    assert rep.serving.flush_count == 1 and rep.serving.pending_lanes == 0


# --------------------------------------------------------------------------
# Ticket semantics
# --------------------------------------------------------------------------

def test_ticket_ordering_across_rounds(served):
    """Results come back in submit order however tickets straddle round
    boundaries."""
    net, params, dep = served
    sess = dep.serve(params, round_batch=4)
    rb = sess.round_batch
    sizes = [rb - 1, 1, 3, rb, 2, 2 * rb + 1]
    xs = [_images(net, b, 80 + i) for i, b in enumerate(sizes)]
    tickets = [sess.submit(x) for x in xs]
    res = sess.results()
    assert [t.uid for t, _ in res] == [t.uid for t in tickets]
    for (_t, y), x in zip(res, xs):
        assert_close(y, _ref(params, net, x))


def test_ready_peeks_without_flushing(served):
    net, params, dep = served
    sess = dep.serve(params, round_batch=4)
    rb, depth = sess.round_batch, sess.ring_depth
    assert depth == 1
    xs = _images(net, rb, 7)
    t1 = sess.submit(xs)
    assert sess.ready() == (t1,)       # a full round runs on submit
    t2 = sess.submit(xs[:1])
    assert sess.ready() == (t1,)       # the partial round waits
    got = sess.results(flush=False)
    assert [t.uid for t, _ in got] == [t1.uid]
    assert_close(got[0][1], _ref(params, net, xs))
    assert sess.ready() == ()          # collected tickets leave
    rest = sess.results()              # the flush runs the partial
    assert [t.uid for t, _ in rest] == [t2.uid]


def test_lone_submit_completes_under_max_wait_ticks(served):
    """Sub-round latency budget: a lone 1-image submit auto-flushes after
    max_wait_ticks session ticks — no explicit flush()/results() call."""
    net, params, dep = served
    sess = dep.serve(params, round_batch=4, max_wait_ticks=2)
    x = _images(net, 1, 11)
    t = sess.submit(x)
    polls = [sess.ready() for _ in range(3)]
    assert polls[0] == () and polls[1] == (t,) == polls[2]
    got = sess.results(flush=False)    # completed without any flush
    assert [tk.uid for tk, _ in got] == [t.uid]
    assert_close(got[0][1], _ref(params, net, x))
    assert sess.report().matches_prediction
    assert sess.serving_stats().waited_ticks == 2


def test_max_wait_one_still_batches_the_next_submit(served):
    """max_wait_ticks=1 must not degenerate to flush-per-submit: the
    submit that starts a partial round doesn't age it, so immediately
    following traffic still batches into the same round."""
    net, params, dep = served
    sess = dep.serve(params, round_batch=4, max_wait_ticks=1)
    rb = sess.round_batch
    t1 = sess.submit(_images(net, 1, 13))
    assert sess.describe()["queued_images"] == 1   # waiting, not flushed
    t2 = sess.submit(_images(net, rb - 1, 14))
    # both requests packed into ONE full (unmasked) round
    assert sess.describe()["queued_images"] == 0
    assert sess.serving_stats().rounds_served == 1
    got = sess.results()
    assert [tk.uid for tk, _ in got] == [t1.uid, t2.uid]
    assert sess.report().matches_prediction


def test_max_wait_ticks_none_waits_indefinitely(served):
    """Without a budget, a partial round only flushes on demand, however
    often the session is polled."""
    net, params, dep = served
    sess = dep.serve(params, round_batch=4)
    t = sess.submit(_images(net, 1, 12))
    for _ in range(8):
        assert sess.ready() == ()
    got = sess.results()               # explicit flush still required
    assert [tk.uid for tk, _ in got] == [t.uid]


def test_max_pending_backpressure(served):
    net, params, dep = served
    sess = dep.serve(params, round_batch=4, max_pending=1)
    rb = sess.round_batch
    xs = _images(net, rb, 9)
    accepted = []
    with pytest.raises(RuntimeError, match="max_pending"):
        for _ in range(3):
            accepted.append(sess.submit(xs))
    assert len(accepted) == 1
    with pytest.raises(RuntimeError, match="max_pending"):
        sess.pump()
    # the refused submit's images were NOT lost: its ticket is queued and
    # results() serves it along with everything accepted before it
    res = sess.results()
    assert len(res) == len(accepted) + 1
    assert [t.uid for t, _ in res] == sorted(t.uid for t, _ in res)
    for _t, y in res:
        assert_close(y, _ref(params, net, xs))
    sess.submit(xs)                    # backpressure cleared; serving resumes
    assert len(sess.results()) == 1


def test_pump_and_close(served):
    net, params, dep = served
    with dep.serve(params, round_batch=4) as sess:
        assert sess.pump() is False    # idle queue, nothing in flight
        t = sess.submit(_images(net, 2, 5))
        assert sess.pump() is False    # a partial round waits...
        assert sess.pump(allow_partial=True) is True   # ...unless allowed
        assert sess.ready() == (t,)
        assert sess.in_flight_rounds == 0
        assert sess.sync() is sess
    assert sess.close() == []          # the context manager closed it
    with pytest.raises(RuntimeError, match="closed"):
        sess.submit(_images(net, 1, 6))
    with pytest.raises(RuntimeError, match="closed"):
        sess.pump()
    desc = sess.describe()
    assert desc["kind"] == "single" and desc["compile_count"] == 1
    assert desc["images_entered"] == 2 and desc["tickets_open"] == 0


# --------------------------------------------------------------------------
# Serving geometry and argument checks
# --------------------------------------------------------------------------

def test_serve_geometry_matches_reference():
    net = chain("vgg_mini", VGG, in_h=16, in_w=16, in_ch=3)
    j_net = j_chain("vgg_mini", VGG, in_h=16, in_w=16, in_ch=3)
    for kw in ({"batch": 2}, {"batch": 2, "round_batch": 8}):
        ps = occam.plan(net, CAPACITY, **kw).place()
        j_ps = j_occam.plan(j_net, CAPACITY, **kw).place()
        assert ps.ring_depth == j_ps.ring_depth == 1
        for rb in (None, 1, 5):
            assert ps.serve_geometry(rb) == j_ps.serve_geometry(rb)
        for bad in (0, -2):
            with pytest.raises(ValueError, match="round_batch"):
                ps.serve_geometry(bad)
            with pytest.raises(ValueError, match="round_batch"):
                j_ps.serve_geometry(bad)
    assert occam.plan(net, CAPACITY, batch=2, round_batch=8).place() \
        .serve_geometry() == (8, 8)
    assert occam.plan(net, CAPACITY, batch=2).place().microbatch == 2
    # a pipeline's rounds are whole multiples of its round width
    pl = occam.plan(net, CAPACITY, batch=2).place(replicas=(1, 2, 1))
    j_pl = j_occam.plan(j_net, CAPACITY, batch=2).place(replicas=(1, 2, 1))
    assert pl.ring_depth == j_pl.ring_depth == 3
    for rb in (None, 2, 6):
        assert pl.serve_geometry(rb) == j_pl.serve_geometry(rb)
    with pytest.raises(ValueError, match="round width 2"):
        pl.serve_geometry(3)


def test_serve_argument_errors(served):
    net, params, dep = served
    with pytest.raises(ValueError, match="round_batch"):
        dep.serve(params, round_batch=0)
    with pytest.raises(ValueError, match="max_pending"):
        dep.serve(params, max_pending=0)
    with pytest.raises(ValueError, match="max_wait_ticks"):
        dep.serve(params, max_wait_ticks=0)


def test_degenerate_submits_rejected():
    net = chain("t", TWO, in_h=10, in_w=10, in_ch=3)
    dep = occam.plan(net, 10**6).place().compile(device="cpu")
    sess = dep.serve(_params(net), round_batch=4)
    with pytest.raises(ValueError, match="B >= 1"):
        sess.submit(np.zeros((0, 10, 10, 3), np.float32))
    with pytest.raises(ValueError, match="images"):
        sess.submit(np.zeros((2, 7, 7, 3), np.float32))
    with pytest.raises(ValueError, match="dtype"):
        sess.submit(np.zeros((2, 10, 10, 3), np.float64))
    # a single (H, W, C) image is a one-image request
    t = sess.submit(np.zeros((10, 10, 3), np.float32))
    (tk, y), = sess.results()
    assert tk == t and tuple(y.shape) == (1,) + net.map_shape(net.n_layers)
    assert sess.report().images == 1


# --------------------------------------------------------------------------
# Dtype policies in a session
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["int8", "bf16"])
def test_policy_session_traffic_byte_exact(policy):
    """A quantized session's lanes equal ``run`` at the round's size bit
    for bit and the reference's session within one int8 step (bf16
    5e-2), and its masked-lane traffic is byte-exact."""
    net = chain("vgg_mini", VGG, in_h=16, in_w=16, in_ch=3)
    j_net = j_chain("vgg_mini", VGG, in_h=16, in_w=16, in_ch=3)
    params = _params(net, 3)
    dep = occam.plan(net, CAPACITY, dtype_policy=policy).place() \
        .compile(device="cpu")
    j_dep = j_occam.plan(j_net, CAPACITY, dtype_policy=policy).place() \
        .compile(interpret=True)
    xs = _images(net, 6, 3)
    with dep.serve(params, round_batch=3) as sess, \
            j_dep.serve(_jax(params), round_batch=3) as j_sess:
        for part in (xs[:2], xs[2:]):
            sess.submit(part)
            j_sess.submit(jnp.asarray(part))
        got = torch.cat([y for _t, y in sess.results()])
        want = np.concatenate([np.asarray(y) for _t, y in j_sess.results()])
        rep, j_rep = sess.report(), j_sess.report()
    assert torch.equal(got, torch.cat([dep.run(params, xs[:3]),
                                       dep.run(params, xs[3:])]))
    band = 0.05 + 1e-6 if policy == "int8" else 5e-2
    assert float(np.max(np.abs(got.numpy() - want))) <= band
    assert rep.matches_prediction and rep.matches_prediction_bytes
    assert rep.images == 6
    assert rep.measured_bytes == j_rep.measured_bytes
    assert rep.measured_bytes == rep.images * rep.offchip_bytes
    assert rep.boundary_bytes_per_elem == \
        occam.POLICIES[policy].boundary_bytes


def test_scale_and_reconcile_raise(served):
    """Without a planning frontier ``scale`` and ``reconcile`` raise the
    reference's ``ValueError``; a session on a frontier-deployed
    deployment hands over to ``for_rate``'s pick, as the reference's
    does."""
    net, params, dep = served
    sess = dep.serve(params)
    with pytest.raises(ValueError, match="no frontier"):
        sess.scale(arrival_rate=100.0)
    with pytest.raises(ValueError, match="no frontier"):
        dep.reconcile(arrival_rate=100.0)
    fleet = dict(chips=1, vmem_elems=CAPACITY,
                 dtype_policy=("fp32", "int8", "bf16"))
    frontier = occam.autoplan(net, occam.Fleet(**fleet))
    j_frontier = j_occam.autoplan(j_chain("vgg_mini", VGG, in_h=16, in_w=16,
                                          in_ch=3), j_occam.Fleet(**fleet))
    rate = 1e-3 * min(c.throughput for c in frontier)
    fast = frontier.best("throughput")
    sess = fast.deploy(device="cpu").serve(params, round_batch=3)
    j_sess = j_frontier.best("throughput").deploy().serve(_jax(params),
                                                          round_batch=3)
    xs = _images(net, 4, seed=5)
    sess.submit(xs)
    j_sess.submit(jnp.asarray(xs))
    scaled, j_scaled = sess.scale(arrival_rate=rate), \
        j_sess.scale(arrival_rate=rate)
    assert scaled is not sess and j_scaled is not j_sess
    assert list(frontier).index(scaled.deployment.candidate) == \
        list(j_frontier).index(j_scaled.deployment.candidate)
    assert scaled.round_batch == j_scaled.round_batch == 3
    (_t, y), = sess.results()
    assert torch.equal(y, fast.deploy(device="cpu").run(params, xs))
    scaled.submit(xs)
    (_t, y), = scaled.results()
    assert torch.equal(y, scaled.deployment.run(params, xs))
