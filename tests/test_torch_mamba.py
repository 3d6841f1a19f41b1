"""The port's Mamba-2 serving path against the JAX package on the CPU:
the causal conv, the Mamba sublayer (prefill into a cache, decode), and
the whole prefill + decode and greedy generation of the mamba2-1.3b smoke
config (chunk 16), on parameters converted from JAX and the same
numpy-made tokens, for both prefill scans (``ssd_impl="kernel"``, whose
CPU route is the kernel's plain version, and ``"chunked"``). fp32
throughout."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import mamba as j_mamba
from repro.models.api import build_model as j_build_model
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.launch.serve import generate, serve
from repro_torch.models import mamba
from repro_torch.models.api import build_model, make_batch

ARCH = "mamba2-1.3b"
IMPLS = ["kernel", "chunked"]
B, S, S_MAX, N_DECODE = 2, 40, 48, 3   # S: three chunks of 16, ragged
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               **tol)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("t_len", [2, 40])
def test_causal_conv_matches_jax(t_len):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, t_len, 24), np.float32)
    w = rng.standard_normal((4, 24), np.float32)
    b = rng.standard_normal((24,), np.float32)
    close(mamba._causal_conv(t(x), t(w), t(b)),
          j_mamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b)), LAYER_TOL)


def mamba_params():
    """JAX Mamba params with random dt_bias, A_log, D, conv_b and norm
    (the init's are constants), as numpy, and the port's copy."""
    cfg = j_get_smoke(ARCH)
    p = j_mamba.init_mamba(jax.random.PRNGKey(1), cfg.d_model, cfg.ssm,
                           jnp.float32)
    rng = np.random.default_rng(1)
    p = {name: np.asarray(v) for name, v in p.items()}
    for name in ("dt_bias", "A_log", "conv_b"):
        p[name] = rng.standard_normal(p[name].shape, np.float32) * 0.5
    for name in ("D", "norm"):
        p[name] = 1.0 + rng.standard_normal(p[name].shape, np.float32) * 0.1
    return cfg, p, {name: t(v) for name, v in p.items()}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("t_len", [2, 40])
def test_mamba_sublayer_matches_jax(t_len, impl):
    """Without a cache; prefill into a cache holding a nonzero state (at
    T = 2 the conv window is padded); then one decode step: y, conv and
    state."""
    cfg, jp, tp = mamba_params()
    ssm = cfg.ssm
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, t_len, cfg.d_model), np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    jp = {name: jnp.asarray(v) for name, v in jp.items()}

    y, none = mamba.mamba_sublayer(tp, t(x), ssm, ssd_impl=impl)
    jy, _ = j_mamba.mamba_sublayer(jp, jnp.asarray(x), ssm)
    assert none is None
    close(y, jy, LAYER_TOL)

    cache = mamba.init_ssm_cache(get_smoke(ARCH), B, torch.float32)
    state = rng.standard_normal(tuple(cache.state.shape), np.float32)
    cache.state.copy_(t(state))
    jcache = j_mamba.init_ssm_cache(cfg, B, jnp.float32)._replace(
        state=jnp.asarray(state))
    y, cache = mamba.mamba_sublayer(tp, t(x), ssm, cache=cache,
                                    ssd_impl=impl)
    jy, jcache = j_mamba.mamba_sublayer(jp, jnp.asarray(x), ssm,
                                        cache=jcache)
    close(y, jy, LAYER_TOL)
    close(cache.conv, jcache.conv, LAYER_TOL)
    close(cache.state, jcache.state, LAYER_TOL)
    assert cache.state.dtype == torch.float32

    y, cache = mamba.mamba_sublayer(tp, t(x1), ssm, cache=cache,
                                    cache_pos=t_len, ssd_impl=impl)
    jy, jcache = j_mamba.mamba_sublayer(jp, jnp.asarray(x1), ssm,
                                        cache=jcache, cache_pos=t_len)
    close(y, jy, LAYER_TOL)
    close(cache.conv, jcache.conv, LAYER_TOL)
    close(cache.state, jcache.state, LAYER_TOL)


def test_sublayer_rejects_unknown_ssd_impl():
    _, _, tp = mamba_params()
    with pytest.raises(ValueError, match="ssd_impl"):
        mamba.mamba_sublayer(tp, torch.zeros((1, 4, 64)),
                             get_smoke(ARCH).ssm, ssd_impl="pallas")
    with pytest.raises(ValueError, match="ssd_impl"):
        build_model(get_smoke(ARCH), device="cpu", ssd_impl="scan")


# ------------------------------------------------------- the whole slice

def inputs(cfg):
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (B, N_DECODE)).astype(np.int32)
    return tokens, steps


@functools.cache
def jax_serving():
    """The JAX package's serving path on the smoke config: params, prefill
    logits and caches, and the logits and caches after each of N_DECODE
    decode steps, all as numpy."""
    cfg = j_get_smoke(ARCH)
    api = j_build_model(cfg, dtype=jnp.float32)
    params = api.init(jax.random.PRNGKey(0))
    tokens, steps = inputs(cfg)
    logits, caches = jax.jit(lambda p, b: api.prefill(p, b, S_MAX))(
        params, {"tokens": jnp.asarray(tokens)})
    out = [(np.asarray(logits), jax.tree.map(np.asarray, caches))]
    decode = jax.jit(api.decode_step)
    for i in range(N_DECODE):
        logits, caches = decode(params, jnp.asarray(steps[:, i:i + 1]),
                                caches, jnp.asarray(S + i, jnp.int32))
        out.append((np.asarray(logits), jax.tree.map(np.asarray, caches)))
    return jax.tree.map(np.asarray, params), out


def port_api(impl):
    cfg = get_smoke(ARCH)
    params_np, _ = jax_serving()
    api = build_model(cfg, dtype=torch.float32, device="cpu", ssd_impl=impl)
    return cfg, api, convert.lm_params_from_numpy(params_np, cfg, "cpu")


def close_caches(cfg, got, want):
    want = convert.lm_caches_from_numpy(want, cfg)
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        assert isinstance(g, mamba.SSMCache) and isinstance(w, mamba.SSMCache)
        close(g.conv, w.conv.numpy(), MODEL_TOL)
        close(g.state, w.state.numpy(), MODEL_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_jax(impl):
    """Prefill last-token logits and every layer's SSMCache, then three
    decode steps fed the same tokens, against the JAX serving path."""
    cfg, api, params = port_api(impl)
    _, want = jax_serving()
    tokens, steps = inputs(cfg)
    logits, caches = api.prefill(params, {"tokens": t(tokens)}, S_MAX)
    assert logits.shape == (B, 1, cfg.vocab_padded)
    close(logits, want[0][0], MODEL_TOL)
    close_caches(cfg, caches, want[0][1])
    for i in range(N_DECODE):
        logits, caches = api.decode_step(params, t(steps[:, i:i + 1]),
                                         caches, S + i)
        close(logits, want[i + 1][0], MODEL_TOL)
        close_caches(cfg, caches, want[i + 1][1])


@pytest.mark.parametrize("impl", IMPLS)
def test_decoder_stack_without_cache_matches_jax(impl):
    """The no-cache forward of the whole stack (the training path's
    forward)."""
    from repro.models import transformer as j_transformer
    from repro_torch.models import transformer

    cfg, _, params = port_api(impl)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    got, caches = transformer.decoder_stack(params, t(x), cfg, t(pos),
                                            ssd_impl=impl)
    assert caches is None
    j_params = jax.tree.map(jnp.asarray, jax_serving()[0])
    j_cfg = j_get_smoke(ARCH)
    want, _, _ = jax.jit(lambda p, x_, pos_: j_transformer.decoder_stack(
        p, x_, j_cfg, pos_))(j_params, jnp.asarray(x), jnp.asarray(pos))
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_greedy_tokens_match_jax(impl):
    """``generate`` emits the tokens of the JAX serving loop (prefill,
    argmax, gen - 1 decode steps)."""
    gen = 6
    cfg, api, params = port_api(impl)
    tokens, _ = inputs(cfg)
    out = generate(api, params, {"tokens": t(tokens)}, gen)

    j_api = j_build_model(j_get_smoke(ARCH), dtype=jnp.float32)
    j_params = jax.tree.map(jnp.asarray, jax_serving()[0])
    logits, caches = jax.jit(lambda p, b: j_api.prefill(p, b, S + gen))(
        j_params, {"tokens": jnp.asarray(tokens)})
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    want = [tok]
    decode = jax.jit(j_api.decode_step)
    for i in range(gen - 1):
        logits, caches = decode(j_params, tok, caches,
                                jnp.asarray(S + i, jnp.int32))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        want.append(tok)
    assert out["tokens"].shape == (B, gen)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))


@pytest.mark.parametrize("impl", IMPLS)
def test_init_matches_jax_tree(impl):
    """``api.init`` draws parameters with the shapes and dtypes of the
    converted JAX tree (no norm2 or ffn: Mamba2 layers have no FFN), the
    fp32 dt_bias / A_log / D, and the distributions' scales; the caches
    keep the state in fp32 under a bf16 model."""
    cfg = get_smoke(ARCH)
    api = build_model(cfg, dtype=torch.float32, device="cpu", ssd_impl=impl)
    got = dict(api.init(torch.Generator().manual_seed(0)).named_parameters())
    want = dict(convert.lm_params_from_numpy(
        jax_serving()[0], cfg).named_parameters())
    assert {n: (p.shape, p.dtype) for n, p in got.items()} == \
        {n: (p.shape, p.dtype) for n, p in want.items()}
    assert "layers.0.ssm.wz" in got and "layers.0.ffn.w1" not in got
    for name in ("embed", "layers.0.ssm.wx", "layers.1.ssm.conv_w",
                 "layers.1.ssm.wo"):
        ratio = float(got[name].detach().std() / want[name].detach().std())
        assert 0.8 < ratio < 1.25, (name, ratio)
    bf16 = build_model(cfg, dtype=torch.bfloat16, device="cpu",
                       ssd_impl=impl)
    cache = bf16.init_caches(B, S_MAX)[0]
    assert cache.conv.dtype == torch.bfloat16
    assert cache.state.dtype == torch.float32
    assert tuple(cache.state.shape) == (B, 1, 8, 16, 16)


@pytest.mark.parametrize("impl", IMPLS)
def test_serve_on_cpu(impl):
    """``serve`` runs Mamba2 on the CPU (its default ``ssd_impl``), and
    ``generate`` on the same seeds emits the same tokens with either
    prefill scan."""
    r = serve(ARCH, batch=2, prompt_len=20, gen=4, device="cpu")
    assert set(r) == {"tokens", "prefill_s", "decode_tok_per_s"}
    assert r["tokens"].shape == (2, 4) and r["tokens"].dtype == torch.int32
    cfg = get_smoke(ARCH)
    api = build_model(cfg, dtype=torch.float32, device="cpu", ssd_impl=impl)
    params = api.init(torch.Generator().manual_seed(0))
    prompt = make_batch(cfg, 2, 20, generator=torch.Generator().manual_seed(1))
    prompt.pop("labels")
    assert torch.equal(generate(api, params, prompt, 4)["tokens"],
                       r["tokens"])


def test_caches_convert_by_type():
    """JAX SSM caches become the port's SSMCache (a KVCache is a pair too,
    so unpacking alone would accept them); a bare pair is refused."""
    cfg = get_smoke(ARCH)
    want = jax_serving()[1][0][1]
    caches = convert.lm_caches_from_numpy(want, cfg)
    assert all(type(c) is mamba.SSMCache for c in caches)
    np.testing.assert_array_equal(caches[1].state.numpy(),
                                  want["sub_0"].state[1])
    bare = {"sub_0": (want["sub_0"].conv, want["sub_0"].state)}
    with pytest.raises(TypeError, match="sub_0"):
        convert.lm_caches_from_numpy(bare, cfg)
