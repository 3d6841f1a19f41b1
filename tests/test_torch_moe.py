"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's on the CPU: the capacity rule, the routing math (indices and
positions exactly, weights and losses within 1e-5), both single-device
dispatch paths with the reference's capacity drops (fp32 within 1e-5,
bf16 within 5e-2), and the no-drop path against a dense per-token
oracle. Inputs are made with numpy from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import moe as j_moe
from repro_torch.configs import get_smoke
from repro_torch.convert import array_from_numpy
from repro_torch.models import moe

ARCHS = ["olmoe-1b-7b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b"]
IMPLS = ["local", "gspmd_scatter"]
TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def params(arch, dtype=jnp.float32, seed=0):
    """The reference's MoE parameters as numpy, and the port's copy."""
    cfg = j_get_smoke(arch)
    p = j_moe.init_moe(jax.random.PRNGKey(seed), cfg.d_model, cfg.moe, dtype)
    return cfg, p, {name: array_from_numpy(np.asarray(v))
                    for name, v in p.items()}


def tokens(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


@pytest.mark.parametrize("tokens_,n_experts,top_k,factor", [
    (1, 8, 2, 1.25), (2, 8, 2, 1.25), (4, 64, 8, 1.25), (48, 8, 2, 1.25),
    (4096, 64, 8, 1.25), (4096, 64, 6, 1.25), (7, 4, 2, 1.0),
    (12, 8, 3, 8 / 3), (1024, 16, 2, 1.25), (3, 64, 8, 0.5)])
def test_capacity_matches_reference(tokens_, n_experts, top_k, factor):
    want = j_moe.capacity(tokens_, n_experts, top_k, factor)
    assert moe.capacity(tokens_, n_experts, top_k, factor) == want
    assert isinstance(want, int) and want >= 1


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [1, 4, 48])
def test_route_matches_reference(arch, n):
    """Indices and positions exactly; weights and both losses within
    1e-5."""
    cfg, jp, tp = params(arch)
    x = tokens((n, cfg.d_model))
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    jw, jidx, jpos, (jlb, jz) = j_moe._route(jnp.asarray(x), jp["router"],
                                             e, k)
    w, idx, pos, (lb, z) = moe._route(t(x), tp["router"], e, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    close(w, jw)
    close(lb, jlb)
    close(z, jz)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(4, 12), (2, 24), (4, 1)],
                         ids=["prefill", "long", "decode"])
def test_moe_sublayer_matches_reference_fp32(arch, impl, shape):
    """The default capacity factor, with drops (at the decode shape the
    capacity is 1 per expert), within 1e-5 in output and aux losses."""
    cfg, jp, tp = params(arch)
    x = tokens(shape + (cfg.d_model,))
    jy, jaux = j_moe.moe_sublayer(jp, jnp.asarray(x), cfg.moe, impl=impl)
    y, aux = moe.moe_sublayer(tp, t(x), cfg.moe, impl=impl)
    assert y.shape == x.shape and y.dtype == torch.float32
    close(y, jy)
    assert set(aux) == set(jaux)
    for name in aux:
        assert aux[name].shape == () and aux[name].dtype == torch.float32
        close(aux[name], jaux[name])


def test_default_factor_drops_assignments():
    """The case the fp32 parity test holds: at 48 tokens, and at a decode
    shape of 4, the olmoe smoke config drops assignments past the
    capacity, as many as the reference."""
    cfg, jp, tp = params("olmoe-1b-7b")
    e, k, f = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    for n in (48, 4):
        x = tokens((n, cfg.d_model))
        _, _, pos, _ = moe._route(t(x), tp["router"], e, k)
        _, _, jpos, _ = j_moe._route(jnp.asarray(x), jp["router"], e, k)
        c = moe.capacity(n, e, k, f)
        assert int((pos >= c).sum()) == int((np.asarray(jpos) >= c).sum()) > 0


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_sublayer_matches_reference_bf16(impl):
    cfg, jp, tp = params("olmoe-1b-7b", dtype=jnp.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["w1"].dtype == torch.bfloat16
    x = tokens((2, 12, cfg.d_model))
    jy, _ = j_moe.moe_sublayer(jp, jnp.asarray(x, jnp.bfloat16), cfg.moe,
                               impl=impl)
    y, _ = moe.moe_sublayer(tp, t(x).to(torch.bfloat16), cfg.moe, impl=impl)
    assert y.dtype == torch.bfloat16
    close(y, np.asarray(jy.astype(jnp.float32)), dict(rtol=5e-2, atol=5e-2))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_no_drop_matches_dense_oracle(arch, impl):
    """At capacity_factor E / k no assignment is dropped, and the layer
    equals sum over each token's top-k experts of w * FFN_e(x)."""
    cfg, _, tp = params(arch)
    mc = dataclasses.replace(get_smoke(arch).moe, capacity_factor=float(
        cfg.moe.n_experts / cfg.moe.top_k))
    x = t(tokens((3, 10, cfg.d_model)))
    y, _ = moe.moe_sublayer(tp, x, mc, impl=impl)
    x2 = x.reshape(-1, cfg.d_model)
    w, idx, _, _ = moe._route(x2, tp["router"], mc.n_experts, mc.top_k)
    want = torch.zeros_like(x2)
    for i in range(x2.shape[0]):
        for j in range(mc.top_k):
            e = int(idx[i, j])
            h = torch.nn.functional.silu(x2[i] @ tp["w1"][e]) \
                * (x2[i] @ tp["w3"][e])
            want[i] += w[i, j] * (h @ tp["w2"][e])
    close(y.reshape(-1, cfg.d_model), want.numpy())


def test_ep_shard_map_without_a_context_is_local():
    """Without a ``ShardCtx`` the expert-parallel impl runs every expert
    locally, as the reference's; an unknown impl raises."""
    cfg, _, tp = params("olmoe-1b-7b")
    x = t(tokens((1, 4, cfg.d_model)))
    y, aux = moe.moe_sublayer(tp, x, cfg.moe, impl="ep_shard_map")
    want, want_aux = moe.moe_sublayer(tp, x, cfg.moe, impl="local")
    assert torch.equal(y, want)
    assert all(torch.equal(aux[k], want_aux[k]) for k in want_aux)
    with pytest.raises(ValueError, match="impl"):
        moe.moe_sublayer(tp, x, cfg.moe, impl="dense")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_moe_matches_reference_tree(dtype):
    """Shapes as the reference's, the router fp32 whatever the dtype,
    and the distributions' scales."""
    cfg = get_smoke("olmoe-1b-7b")
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model,
                       cfg.moe, dtype)
    _, _, want = params("olmoe-1b-7b")
    assert {n: tuple(v.shape) for n, v in got.items()} == \
        {n: tuple(v.shape) for n, v in want.items()}
    assert got["router"].dtype == torch.float32
    assert all(got[n].dtype == dtype for n in ("w1", "w3", "w2"))
    for name in got:
        ratio = float(got[name].detach().float().std() / want[name].std())
        assert 0.9 < ratio < 1.1, (name, ratio)
