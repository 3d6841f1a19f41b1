"""The port's dtype policies against the reference's: the casting twins bit
for bit (int8 codes equal, ties included), plan documents under a policy
equal to the reference's and loading both ways, and int8 / bf16 runs of a
tiny VGG on the CPU against the JAX package's (Pallas kernel in interpret
mode), byte-exact traffic and the same accuracy band."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import occam as j_occam
from repro.core.graph import chain as j_chain
from repro.models import zoo as j_zoo
from repro.occam.quant import casting as j_casting
from repro_torch import convert, occam
from repro_torch.core.graph import chain
from repro_torch.models import cnn, zoo
from repro_torch.occam.quant import POLICIES, casting

C, P = "conv", "pool"
CAPACITY = 6000
VGG = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16),
       (C, 3, 1, 1, 16), (P, 2, 2, 0, 0), (C, 3, 1, 1, 16)]


def _samples(scale: float) -> np.ndarray:
    """Seeded values: a normal spread past the int8 clip range, exact
    half-step ties k * scale + scale / 2 (exact when the scale is a power
    of two), and zeros of both signs."""
    rng = np.random.default_rng(0)
    spread = rng.standard_normal(512).astype(np.float32) * 4.0 * scale * 40
    ties = ((np.arange(-130, 130) + 0.5) * scale).astype(np.float32)
    return np.concatenate([spread, ties, np.float32([0.0, -0.0])])


@pytest.mark.parametrize("scale", [0.05, 0.25])
def test_int8_codes_and_round_trip_equal_reference(scale):
    x = _samples(scale)
    if scale == 0.25:  # exact ties really occur, and round to even
        assert np.any(np.abs(x / scale - np.round(x / scale)) == 0.5)
    q = casting.quantize(torch.from_numpy(x), "int8", scale)
    j_q = j_casting.quantize(jnp.asarray(x), "int8", scale)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(j_q))
    assert int(q.min()) == -127 and int(q.max()) == 127  # clipped
    fq = casting.fake_quant(torch.from_numpy(x), "int8", scale)
    j_fq = j_casting.fake_quant(jnp.asarray(x), "int8", scale)
    assert fq.dtype == torch.float32
    np.testing.assert_array_equal(fq.numpy().view(np.uint32),
                                  np.asarray(j_fq).view(np.uint32))
    deq = casting.dequantize(q, "int8", scale)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(
        j_casting.dequantize(j_q, "int8", scale)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_float_fake_quant_equals_reference(dtype):
    x = _samples(0.05)
    got = casting.fake_quant(torch.from_numpy(x), dtype)
    want = j_casting.fake_quant(jnp.asarray(x), dtype)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    assert casting.quantize(torch.from_numpy(x), dtype).dtype == \
        casting.torch_dtype(dtype)
    # int8 fake-quant of a bfloat16 tensor stays bfloat16, as the
    # reference's does, with the scale taken in bfloat16
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = casting.fake_quant(xb, "int8")
    want = j_casting.fake_quant(jnp.asarray(x, jnp.bfloat16), "int8")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    with pytest.raises(ValueError, match="unknown policy dtype"):
        casting.torch_dtype("int4")


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_fake_quant_is_idempotent(dtype):
    x = torch.from_numpy(_samples(0.05))
    once = casting.fake_quant(x, dtype)
    assert torch.equal(casting.fake_quant(once, dtype), once)
    if dtype == "int8":
        assert torch.equal(casting.quantize(once, dtype),
                           casting.quantize(x, dtype))
    assert casting.fake_quant(x, "float32") is x


@pytest.mark.parametrize("name", ["fp32", "bf16", "int8"])
def test_quantize_params_equal_reference(name):
    rng = np.random.default_rng(1)
    params = [{"w": rng.standard_normal((3, 3, 4, 8), np.float32) * 0.3,
               "b": rng.standard_normal((8,), np.float32)}, {}]
    policy = POLICIES[name]
    got = casting.quantize_params(convert.params_from_numpy(params), policy)
    want = j_casting.quantize_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        j_occam.resolve_policy(name))
    assert [sorted(p) for p in got] == [sorted(p) for p in want]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    assert casting.quantize_params(params, None) is params


POLICY_PLAN_CASES = [
    ("resnet18", 400_000), ("resnet18", 1_048_576), ("resnet18", 3_145_728),
    ("vggnet", 786_432), ("alexnet", 3_145_728),
]


@pytest.mark.parametrize("policy", ["int8", "bf16"])
@pytest.mark.parametrize("name,capacity", POLICY_PLAN_CASES)
def test_policy_plan_documents_equal_reference(name, capacity, policy):
    got = occam.plan(zoo.get_network(name), capacity, dtype_policy=policy)
    want = j_occam.plan(j_zoo.get_network(name), capacity,
                        dtype_policy=policy)
    assert got.to_dict() == want.to_dict()
    assert got.to_dict()["quant"] == POLICIES[policy].to_dict()
    assert got.predicted.offchip_bytes == want.predicted.offchip_bytes
    assert got.predicted.boundary_bytes_per_elem == \
        POLICIES[policy].boundary_bytes


def test_policy_moves_the_resnet18_cut():
    """The byte-denominated DP at 3,145,728 elements: int8 keeps fp32's
    cuts at a quarter of the bytes; bf16 fuses into three spans."""
    net = zoo.resnet18()
    f32 = occam.plan(net, 3_145_728)
    i8 = occam.plan(net, 3_145_728, dtype_policy="int8")
    b16 = occam.plan(net, 3_145_728, dtype_policy="bf16")
    assert (f32.boundaries, i8.boundaries, b16.boundaries) == \
        ([12, 15, 16, 17], [12, 15, 16, 17], [12, 16])
    assert (f32.predicted.offchip_bytes, i8.predicted.offchip_bytes,
            b16.predicted.offchip_bytes) == (2_207_744, 551_936, 652_288)
    for plan in (i8, b16):
        assert [r.route for r in plan.routes] == ["pallas"] * plan.n_spans


@pytest.mark.parametrize("policy", ["int8", "bf16"])
def test_v5_documents_round_trip_both_ways(policy):
    net = chain("vgg_mini", VGG, in_h=16, in_w=16, in_ch=3)
    j_net = j_chain("vgg_mini", VGG, in_h=16, in_w=16, in_ch=3)
    mine = occam.plan(net, CAPACITY, dtype_policy=policy)
    theirs = j_occam.plan(j_net, CAPACITY, dtype_policy=policy)
    assert mine.to_dict() == theirs.to_dict()
    for doc in (mine.to_json(), theirs.to_json()):
        for load in (occam.plan_from_json, j_occam.plan_from_json):
            loaded = load(doc)
            assert loaded.to_dict() == mine.to_dict()
            assert loaded.quant.to_dict() == POLICIES[policy].to_dict()
            # the byte widths are re-stamped from the quant block
            assert loaded.predicted.offchip_bytes == \
                mine.predicted.offchip_bytes


def test_stray_quant_block_on_v4_document_rejected():
    net = chain("vgg_mini", VGG, in_h=16, in_w=16, in_ch=3)
    d = occam.plan(net, CAPACITY, dtype_policy="int8").to_dict()
    d["version"] = 4
    with pytest.raises(ValueError, match="version 5"):
        occam.plan_from_dict(d)
    # an explicit null, or no key at all, is the implicit fp32 policy
    d["quant"] = None
    assert occam.plan_from_dict(d).quant is None
    d.pop("quant")
    assert occam.plan_from_dict(d).predicted.boundary_bytes_per_elem == 4.0


@pytest.fixture(scope="module")
def vgg_case():
    rng = np.random.default_rng(2)
    net = chain("vgg_mini", VGG, in_h=16, in_w=16, in_ch=3)
    j_net = j_chain("vgg_mini", VGG, in_h=16, in_w=16, in_ch=3)
    params = []
    for layer in net.layers:
        if layer.kind == "conv":
            shape = (layer.k, layer.k, layer.in_ch, layer.out_ch)
            params.append({
                "w": rng.standard_normal(shape, np.float32) * np.float32(0.1),
                "b": rng.standard_normal((layer.out_ch,), np.float32)
                * np.float32(0.1)})
        else:
            params.append({})
    xs = rng.standard_normal((6, 16, 16, 3), np.float32) * np.float32(0.5)
    ref = cnn.reference_forward(convert.params_from_numpy(params),
                                torch.from_numpy(xs), net)
    return net, j_net, params, xs, ref.numpy()


# one int8 step (a sum taken in another order can flip a rounding at a
# boundary); bf16 within 5e-2
POLICY_BANDS = {"int8": 0.05 + 1e-6, "bf16": 5e-2}


@pytest.mark.pallas_interpret
@pytest.mark.parametrize("policy", ["int8", "bf16"])
def test_policy_run_matches_reference(vgg_case, policy):
    net, j_net, params, xs, _ref = vgg_case
    dep = occam.plan(net, CAPACITY, batch=6, dtype_policy=policy) \
        .place().compile(device="cpu")
    j_dep = j_occam.plan(j_net, CAPACITY, batch=6, dtype_policy=policy) \
        .place().compile(interpret=True)
    assert [r.route for r in dep.routes] == \
        [r.route for r in j_dep.routes] == ["pallas"] * dep.plan.n_spans
    got = dep.run(params, xs)
    want = np.asarray(j_dep.run(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        jnp.asarray(xs)))
    assert float(np.max(np.abs(got.numpy() - want))) <= POLICY_BANDS[policy]
    for rep in (dep.report(), j_dep.report()):
        assert rep.matches_prediction and rep.matches_prediction_bytes
    rep = dep.report()
    assert rep.boundary_bytes_per_elem == POLICIES[policy].boundary_bytes
    assert rep.measured_bytes == j_dep.report().measured_bytes
    assert rep.measured_bytes < rep.measured_elems * 4.0
    assert dep.describe()["quant"] == POLICIES[policy].to_dict()
    if policy == "int8":  # every output value is on the int8 grid
        codes = got.numpy() / 0.05
        assert np.max(np.abs(codes - np.round(codes))) < 1e-3


def test_quantized_accuracy_band(vgg_case):
    """int8 outputs differ from the fp32 reference (quantization really
    happened) but stay inside the band the per-tensor scale bounds; bf16
    sits between."""
    net, _j_net, params, xs, ref = vgg_case
    errs = {}
    for policy in ("int8", "bf16"):
        y = occam.plan(net, CAPACITY, batch=6, dtype_policy=policy) \
            .place().compile(device="cpu").run(params, xs)
        errs[policy] = float(np.max(np.abs(y.numpy() - ref)))
    assert 0.0 < errs["int8"] < 0.25
    assert 0.0 < errs["bf16"] < errs["int8"]
