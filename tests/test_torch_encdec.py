"""The port's encoder-decoder stack (``repro_torch.models.encdec``, the
SeamlessM4T backbone) against the JAX package's on the CPU: cross-
attention through ``attention_sublayer``'s ``kv_override`` (prefill and
decode), the encoder, and prefill plus three decode steps of the
``seamless-m4t-large-v2`` smoke config (logits, self caches and cross
caches) within 1e-4, for both prefill attention impls, on parameters
converted from JAX and the same numpy-made inputs. fp32 throughout."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import encdec as j_encdec
from repro.models import layers as j_layers
from repro.models.api import build_model as j_build_model
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.launch.serve import generate, serve
from repro_torch.models import encdec, layers
from repro_torch.models.api import build_model, make_batch

ARCH = "seamless-m4t-large-v2"
IMPLS = ["flash", "chunked"]
B, S, S_ENC, S_MAX, N_DECODE = 2, 10, 14, 18, 3
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               **tol)


def inputs(cfg):
    """Frame embeddings (B, S_ENC, d), prompt tokens and the tokens fed to
    the decode steps, made with numpy."""
    rng = np.random.default_rng(11)
    enc = rng.standard_normal((B, S_ENC, cfg.d_model), np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (B, N_DECODE)).astype(np.int32)
    return enc, tokens, steps


# ------------------------------------------------------ cross-attention

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("s", [S, 1], ids=["prefill", "decode"])
def test_cross_attention_sublayer_matches_jax(s, impl):
    """``kv_override``: q unrotated against the encoder's K/V, non-causal
    over all S_enc rows (the flash kernel's plain version or the chunked
    twin at Sq != Skv; a one-token x takes the decode path); no cache is
    written even when one is passed."""
    cfg = j_get_smoke(ARCH)
    jp = j_layers.init_attention(jax.random.PRNGKey(4), cfg,
                                 dtype=jnp.float32)
    tp = {name: t(v) for name, v in jp.items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, s, cfg.d_model), np.float32)
    kv = [rng.standard_normal((B, S_ENC, cfg.n_kv_heads, cfg.d_head),
                              np.float32) for _ in range(2)]
    pos = np.broadcast_to(np.arange(s, dtype=np.int32) + 3, (B, s)).copy()
    shape = (B, S_MAX, cfg.n_kv_heads, cfg.d_head)
    cache = layers.KVCache(torch.zeros(shape), torch.zeros(shape))
    y, new_cache = layers.attention_sublayer(
        tp, t(x), cfg, t(pos), causal=False, cache=cache, cache_pos=4,
        kv_override=(t(kv[0]), t(kv[1])), attn_impl=impl)
    jy, _ = j_layers.attention_sublayer(
        jp, jnp.asarray(x), cfg, jnp.asarray(pos), causal=False,
        kv_override=(jnp.asarray(kv[0]), jnp.asarray(kv[1])))
    assert new_cache is None and not bool(cache.k.any())
    close(y, jy, LAYER_TOL)


def test_cross_attention_leaves_q_unrotated():
    """Positions do not move cross-attention (RoPE applies to self-
    attention only), unlike self-attention."""
    cfg = get_smoke(ARCH)
    p = layers.init_attention(torch.Generator().manual_seed(0), cfg,
                              dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 4, cfg.d_model), generator=g)
    kv = (torch.randn((1, 6, cfg.n_kv_heads, cfg.d_head), generator=g),
          torch.randn((1, 6, cfg.n_kv_heads, cfg.d_head), generator=g))
    at = [layers.attention_sublayer(p, x, cfg, torch.full((1, 4), start),
                                    causal=False, kv_override=kv)[0]
          for start in (0, 7)]
    torch.testing.assert_close(at[0], at[1], rtol=0, atol=0)
    own = [layers.attention_sublayer(p, x, cfg, torch.arange(4)[None] * m,
                                     causal=False)[0] for m in (1, 2)]
    assert not torch.allclose(own[0], own[1])


# ---------------------------------------------------------- the stack

@functools.cache
def jax_serving():
    """The JAX package's default path on the smoke config: params, the
    encoder's output, prefill logits and caches, and the logits and caches
    after each of N_DECODE decode steps, all as numpy."""
    cfg = j_get_smoke(ARCH)
    api = j_build_model(cfg, dtype=jnp.float32)
    params = api.init(jax.random.PRNGKey(0))
    enc, tokens, steps = inputs(cfg)
    memory = jax.jit(lambda p, e: j_encdec.encoder_forward(p, e, cfg))(
        params, jnp.asarray(enc))
    logits, caches = jax.jit(lambda p, b: api.prefill(p, b, S_MAX))(
        params, {"enc_embeds": jnp.asarray(enc),
                 "tokens": jnp.asarray(tokens)})
    out = [(np.asarray(logits), jax.tree.map(np.asarray, caches))]
    decode = jax.jit(api.decode_step)
    for i in range(N_DECODE):
        logits, caches = decode(params, jnp.asarray(steps[:, i:i + 1]),
                                caches, jnp.asarray(S + i, jnp.int32))
        out.append((np.asarray(logits), jax.tree.map(np.asarray, caches)))
    return jax.tree.map(np.asarray, params), np.asarray(memory), out


def port_api(impl):
    cfg = get_smoke(ARCH)
    api = build_model(cfg, dtype=torch.float32, device="cpu", attn_impl=impl)
    return cfg, api, convert.lm_params_from_numpy(jax_serving()[0], cfg)


def close_caches(cfg, got, want):
    """Each decoder layer's self K/V and cross K/V."""
    want = convert.lm_caches_from_numpy(want, cfg)
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"self", "cross"}
        assert isinstance(g["cross"], encdec.CrossCache)
        for part in ("self", "cross"):
            for g_leaf, w_leaf in zip(g[part], w[part]):
                close(g_leaf, w_leaf.numpy(), MODEL_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_matches_jax(impl):
    cfg, _, params = port_api(impl)
    enc, _, _ = inputs(cfg)
    got = encdec.encoder_forward(params, t(enc), cfg, attn_impl=impl)
    close(got, jax_serving()[1], MODEL_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_jax(impl):
    """Prefill last-token logits, self caches (prefix written) and cross
    caches (the encoder's K/V), then three decode steps fed the same
    tokens, each step's logits and caches, against the JAX default
    (chunked) path."""
    cfg, api, params = port_api(impl)
    _, _, want = jax_serving()
    enc, tokens, steps = inputs(cfg)
    logits, caches = api.prefill(params, {"enc_embeds": t(enc),
                                          "tokens": t(tokens)}, S_MAX)
    assert logits.shape == (B, 1, cfg.vocab_padded)
    assert caches[0]["cross"].k.shape == (B, S_ENC, cfg.n_kv_heads,
                                          cfg.d_head)
    close(logits, want[0][0], MODEL_TOL)
    close_caches(cfg, caches, want[0][1])
    for i in range(N_DECODE):
        logits, caches = api.decode_step(params, t(steps[:, i:i + 1]),
                                         caches, S + i)
        close(logits, want[i + 1][0], MODEL_TOL)
        close_caches(cfg, caches, want[i + 1][1])


def test_decode_reads_cross_kv_from_the_cache():
    """A decode step does not recompute the cross K/V: changing the
    cross weights after prefill leaves its logits as they were, and
    changing the cached K/V changes them."""
    cfg, api, params = port_api("chunked")
    enc, tokens, steps = inputs(cfg)
    _, caches = api.prefill(params, {"enc_embeds": t(enc),
                                     "tokens": t(tokens)}, S_MAX)
    snapshot = [{part: type(c[part])(*(leaf.clone() for leaf in c[part]))
                 for part in c} for c in caches]
    want, _ = api.decode_step(params, t(steps[:, :1]), caches, S)
    with torch.no_grad():
        for layer in params.dec_layers:
            layer.xattn["wk"].mul_(3.0)
            layer.xattn["wv"].mul_(-1.0)
    got, _ = api.decode_step(params, t(steps[:, :1]), snapshot, S)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for c in snapshot:
        c["cross"].v.mul_(2.0)
    moved, _ = api.decode_step(params, t(steps[:, :1]), snapshot, S)
    assert not torch.allclose(moved, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_greedy_tokens_match_jax(impl):
    """``generate`` passes ``enc_embeds`` through the prompt and emits the
    tokens of the JAX serving loop."""
    gen = 5
    cfg, api, params = port_api(impl)
    enc, tokens, _ = inputs(cfg)
    out = generate(api, params, {"enc_embeds": t(enc), "tokens": t(tokens)},
                   gen)
    j_api = j_build_model(j_get_smoke(ARCH), dtype=jnp.float32)
    j_params = jax.tree.map(jnp.asarray, jax_serving()[0])
    logits, caches = jax.jit(lambda p, b: j_api.prefill(p, b, S + gen))(
        j_params, {"enc_embeds": jnp.asarray(enc),
                   "tokens": jnp.asarray(tokens)})
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    want = [tok]
    decode = jax.jit(j_api.decode_step)
    for i in range(gen - 1):
        logits, caches = decode(j_params, tok, caches,
                                jnp.asarray(S + i, jnp.int32))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        want.append(tok)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))


def test_init_matches_jax_tree():
    """``api.init`` draws the enc-dec parameters with the shapes and
    dtypes of the converted JAX tree, and the distributions' scales."""
    cfg = get_smoke(ARCH)
    api = build_model(cfg, dtype=torch.float32, device="cpu")
    got = dict(api.init(torch.Generator().manual_seed(0)).named_parameters())
    want = dict(convert.lm_params_from_numpy(
        jax_serving()[0], cfg).named_parameters())
    assert {n: (p.shape, p.dtype) for n, p in got.items()} == \
        {n: (p.shape, p.dtype) for n, p in want.items()}
    assert len([n for n in got if n.startswith("enc_layers.")]) == \
        cfg.n_enc_layers * 9
    for name in ("embed", "lm_head", "enc_layers.0.attn.wq",
                 "dec_layers.1.xattn.wk", "dec_layers.0.ffn.w2"):
        ratio = float(got[name].detach().std() / want[name].detach().std())
        assert 0.8 < ratio < 1.25, (name, ratio)


def test_init_caches_signature():
    """``init_caches(b, s_max, s_enc=None)``, as the reference's: the
    cross caches take ``s_enc``, else ``s_max``."""
    cfg = get_smoke(ARCH)
    api = build_model(cfg, dtype=torch.float32, device="cpu")
    for s_enc, want in ((None, S_MAX), (S_ENC, S_ENC)):
        caches = api.init_caches(B, S_MAX, s_enc)
        assert len(caches) == cfg.n_layers
        assert caches[0]["self"].k.shape == (B, S_MAX, cfg.n_kv_heads,
                                             cfg.d_head)
        assert caches[0]["cross"].v.shape == (B, want, cfg.n_kv_heads,
                                              cfg.d_head)


def test_make_batch_enc_dec():
    cfg = get_smoke(ARCH)
    b = make_batch(cfg, 3, 5, generator=torch.Generator().manual_seed(0))
    assert set(b) == {"enc_embeds", "tokens", "labels"}
    assert b["enc_embeds"].shape == (3, 5, cfg.d_model)
    assert b["enc_embeds"].dtype == torch.float32
    assert b["tokens"].shape == b["labels"].shape == (3, 5)
    assert int(b["tokens"].max()) < cfg.vocab
    assert 0.7 < float(b["enc_embeds"].std()) < 1.3
    half = make_batch(cfg, 3, 5, generator=torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16)
    assert half["enc_embeds"].dtype == torch.bfloat16
    assert torch.equal(half["tokens"], b["tokens"])


def test_serve_on_cpu():
    r = serve(ARCH, batch=2, prompt_len=8, gen=4, device="cpu")
    assert r["tokens"].shape == (2, 4) and r["tokens"].dtype == torch.int32
