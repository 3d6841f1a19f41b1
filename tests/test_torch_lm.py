"""The port's LM serving path against the JAX package on the CPU: layers
(RMSNorm, RoPE / M-RoPE, chunked and decode attention, the attention
sublayer) and the whole prefill + decode of the five dense decoder-only
smoke configs, on parameters converted from JAX and the same numpy-made
tokens. fp32 throughout."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import layers as j_layers
from repro.models.api import build_model as j_build_model
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch.serve import generate, serve
from repro_torch.models import layers
from repro_torch.models.api import build_model, make_batch

DENSE = ["llama3.2-1b", "internlm2-1.8b", "minitron-4b", "qwen2.5-14b",
         "qwen2-vl-2b"]
IMPLS = ["flash", "chunked"]
B, S, S_MAX, N_DECODE = 2, 12, 20, 3
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               **tol)


# ---------------------------------------------------------------- layers

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3
    w = rng.standard_normal((64,), np.float32)
    close(layers.rms_norm(t(x), t(w), 1e-5),
          j_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), LAYER_TOL)


@pytest.mark.parametrize("theta,sections", [(1e4, None), (5e5, None),
                                            (1e4, (2, 3, 3))])
def test_apply_rope_matches_jax(theta, sections):
    """RoPE, and M-RoPE with three distinct position streams."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16), np.float32)
    if sections is None:
        pos = np.broadcast_to(np.arange(7, dtype=np.int32) + 3, (2, 7))
    else:
        pos = rng.integers(0, 40, (2, 7, 3)).astype(np.int32)
    close(layers.apply_rope(t(x), t(pos), theta, sections),
          j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                              sections), LAYER_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(causal):
    """Several chunks with a short last one, and Skv > Sq."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 24, 4, 16), np.float32)
    k = rng.standard_normal((2, 40, 4, 16), np.float32)
    v = rng.standard_normal((2, 40, 4, 16), np.float32)
    close(layers.chunked_attention(t(q), t(k), t(v), causal=causal,
                                   chunk=16),
          j_layers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     chunk=16), LAYER_TOL)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16), np.float32)
    k = rng.standard_normal((2, 24, 2, 16), np.float32)
    v = rng.standard_normal((2, 24, 2, 16), np.float32)
    close(layers.decode_attention(t(q), t(k), t(v), 13),
          j_layers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 13), LAYER_TOL)


def attn_params(arch):
    """JAX attention params (random biases where the config has them) as
    numpy, and the port's copy."""
    cfg = j_get_smoke(arch)
    p = j_layers.init_attention(jax.random.PRNGKey(4), cfg,
                                dtype=jnp.float32)
    rng = np.random.default_rng(4)
    p = {name: (rng.standard_normal(v.shape, np.float32) * 0.1
                if name.startswith("b") else np.asarray(v))
         for name, v in p.items()}
    return cfg, p, {name: t(v) for name, v in p.items()}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-14b"])
def test_attention_sublayer_matches_jax(arch, impl):
    """Without a cache, prefill into a cache, then one decode step at
    cache_pos; qwen2.5 exercises qkv_bias."""
    cfg, jp, tp = attn_params(arch)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jp = {name: jnp.asarray(v) for name, v in jp.items()}

    y, _ = layers.attention_sublayer(tp, t(x), cfg, t(pos), attn_impl=impl)
    jy, _ = j_layers.attention_sublayer(jp, jnp.asarray(x), cfg,
                                        jnp.asarray(pos))
    close(y, jy, LAYER_TOL)

    shape = (B, S_MAX, cfg.n_kv_heads, cfg.d_head)
    cache = layers.KVCache(torch.zeros(shape), torch.zeros(shape))
    jcache = j_layers.KVCache(jnp.zeros(shape), jnp.zeros(shape))
    y, cache = layers.attention_sublayer(tp, t(x), cfg, t(pos), cache=cache,
                                         attn_impl=impl)
    jy, jcache = j_layers.attention_sublayer(jp, jnp.asarray(x), cfg,
                                             jnp.asarray(pos), cache=jcache)
    close(y, jy, LAYER_TOL)
    close(cache.k, jcache.k, LAYER_TOL)
    close(cache.v, jcache.v, LAYER_TOL)

    pos1 = np.full((B, 1), S, np.int32)
    y, cache = layers.attention_sublayer(tp, t(x1), cfg, t(pos1),
                                         cache=cache, cache_pos=S,
                                         attn_impl=impl)
    jy, jcache = j_layers.attention_sublayer(jp, jnp.asarray(x1), cfg,
                                             jnp.asarray(pos1), cache=jcache,
                                             cache_pos=S)
    close(y, jy, LAYER_TOL)
    close(cache.k, jcache.k, LAYER_TOL)
    close(cache.v, jcache.v, LAYER_TOL)


def test_cross_attention_not_ported_yet():
    cfg, _, tp = attn_params("llama3.2-1b")
    x = torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(NotImplementedError, match="Queue A 10"):
        layers.attention_sublayer(tp, x, cfg, None, kv_override=(x, x))


# ------------------------------------------------------- the whole slice

def inputs(cfg):
    """Prompt tokens, prefill positions (three distinct streams for
    M-RoPE) and the tokens fed to the decode steps, made with numpy."""
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (B, N_DECODE)).astype(np.int32)
    ar = np.arange(S, dtype=np.int32)
    if cfg.mrope_sections is not None:
        pos = np.stack([ar, ar // 2, ar % 5], -1)
        pos = np.broadcast_to(pos, (B, S, 3)).copy()
    else:
        pos = np.broadcast_to(ar, (B, S)).copy()
    return tokens, pos, steps


@functools.cache
def jax_serving(arch):
    """The JAX package's default path on ``arch``'s smoke config: params,
    prefill logits and caches, and the logits and caches after each of
    N_DECODE decode steps, all as numpy."""
    cfg = j_get_smoke(arch)
    api = j_build_model(cfg, dtype=jnp.float32)
    params = api.init(jax.random.PRNGKey(0))
    tokens, pos, steps = inputs(cfg)
    logits, caches = jax.jit(lambda p, b: api.prefill(p, b, S_MAX))(
        params, {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos)})
    out = [(np.asarray(logits), jax.tree.map(np.asarray, caches))]
    decode = jax.jit(api.decode_step)
    for i in range(N_DECODE):
        logits, caches = decode(params, jnp.asarray(steps[:, i:i + 1]),
                                caches, jnp.asarray(S + i, jnp.int32))
        out.append((np.asarray(logits), jax.tree.map(np.asarray, caches)))
    return jax.tree.map(np.asarray, params), out


def port_api(arch, impl):
    cfg = get_smoke(arch)
    params_np, _ = jax_serving(arch)
    api = build_model(cfg, dtype=torch.float32, device="cpu", attn_impl=impl)
    return cfg, api, convert.lm_params_from_numpy(params_np, cfg, "cpu")


def close_caches(cfg, got, want):
    want = convert.lm_caches_from_numpy(want, cfg)
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        close(g.k, w.k.numpy(), MODEL_TOL)
        close(g.v, w.v.numpy(), MODEL_TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, impl):
    """Prefill last-token logits and filled caches, then three decode steps
    fed the same tokens, against the JAX default (chunked) path."""
    cfg, api, params = port_api(arch, impl)
    _, want = jax_serving(arch)
    tokens, pos, steps = inputs(cfg)
    logits, caches = api.prefill(params, {"tokens": t(tokens),
                                          "positions": t(pos)}, S_MAX)
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
    forward), on the M-RoPE config."""
    from repro.models import transformer as j_transformer
    from repro_torch.models import transformer

    arch = "qwen2-vl-2b"
    cfg, _, params = port_api(arch, impl)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    _, pos, _ = inputs(cfg)
    got, caches = transformer.decoder_stack(params, t(x), cfg, t(pos),
                                            attn_impl=impl)
    assert caches is None
    j_params = jax.tree.map(jnp.asarray, jax_serving(arch)[0])
    j_cfg = j_get_smoke(arch)
    want, _, _ = jax.jit(lambda p, x_, pos_: j_transformer.decoder_stack(
        p, x_, j_cfg, pos_))(j_params, jnp.asarray(x), jnp.asarray(pos))
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_greedy_tokens_match_jax(impl):
    """``generate`` on the llama smoke config emits the tokens of the JAX
    serving loop (prefill, argmax, gen - 1 decode steps)."""
    arch, gen = "llama3.2-1b", 6
    cfg, api, params = port_api(arch, impl)
    tokens, _, _ = inputs(cfg)
    out = generate(api, params, {"tokens": t(tokens)}, gen)

    j_api = j_build_model(j_get_smoke(arch), dtype=jnp.float32)
    j_params = jax.tree.map(jnp.asarray, jax_serving(arch)[0])
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
    assert out["prefill_s"] > 0 and out["decode_tok_per_s"] > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-14b"])
def test_init_matches_jax_tree(arch):
    """``api.init`` draws parameters with the shapes and dtypes of the
    converted JAX tree, and the distributions' scales."""
    cfg = get_smoke(arch)
    api = build_model(cfg, dtype=torch.float32, device="cpu")
    got = dict(api.init(torch.Generator().manual_seed(0)).named_parameters())
    want = dict(convert.lm_params_from_numpy(
        jax_serving(arch)[0], cfg).named_parameters())
    assert {n: (p.shape, p.dtype) for n, p in got.items()} == \
        {n: (p.shape, p.dtype) for n, p in want.items()}
    for name in ("embed", "layers.0.attn.wq", "layers.1.ffn.w2"):
        ratio = float(got[name].detach().std() / want[name].detach().std())
        assert 0.8 < ratio < 1.25, (name, ratio)


def test_serve_on_cpu():
    r = serve("llama3.2-1b", batch=2, prompt_len=8, gen=4, device="cpu")
    assert set(r) == {"tokens", "prefill_s", "decode_tok_per_s"}
    assert r["tokens"].shape == (2, 4) and r["tokens"].dtype == torch.int32


def test_make_batch_mrope_positions():
    cfg = get_smoke("qwen2-vl-2b")
    b = make_batch(cfg, 3, 5, generator=torch.Generator().manual_seed(0))
    assert b["tokens"].shape == b["labels"].shape == (3, 5)
    assert int(b["tokens"].max()) < cfg.vocab
    assert b["positions"].shape == (3, 5, 3)
    assert torch.equal(b["positions"][1, :, 2],
                       torch.arange(5, dtype=torch.int32))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_unported_archs_raise(arch):
    """MoE configs (also the SSM/attention hybrid with MoE layers) and
    enc-dec configs are not served yet."""
    with pytest.raises(NotImplementedError, match="Queue A 10"):
        build_model(get_smoke(arch), device="cpu")


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device exists here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model(get_config("llama3.2-1b"))
