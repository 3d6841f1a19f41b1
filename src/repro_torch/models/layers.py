"""Transformer building blocks: RMSNorm, RoPE / M-RoPE, GQA attention
(prefill through the flash kernel or the chunked twin, cache decode path),
SwiGLU FFN. The port of ``repro/models/layers.py`` on one device.

Layouts are the reference's: activations (B, S, H, D) in the model and
(B, H, S, D) at the attention op; weights (in, out), applied as
``x @ w``. Parameters are ``nn.ParameterDict``s (or any mapping of
tensors) with the reference's names. The reference's ``shard`` calls are
dropped: the port runs on one device.

Prefill attention takes its implementation as an argument
(``attn_impl``): ``"flash"`` calls ``kernels.flash_attention.ops``, which
launches the CUDA kernel on a CUDA tensor and runs its plain version on a
CPU tensor; ``"chunked"`` calls :func:`chunked_attention`, the twin of
the reference's default XLA path. Decode always uses
:func:`decode_attention`, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30
ATTN_IMPLS = ("flash", "chunked")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


# --------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# --------------------------------------------------------------------------

def _rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, int, int] | None = None
               ) -> torch.Tensor:
    """x: (B, S, H, D). positions: (B, S) int, or (B, S, 3) for M-RoPE.

    M-RoPE (Qwen2-VL): the rotary half-dims are split into
    (temporal, height, width) sections, each rotated by its own position
    stream. Text tokens carry identical t/h/w positions, reducing to RoPE.
    """
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)  # (d/2,)
    if mrope_sections is None:
        if positions.ndim == 3:
            positions = positions[..., 0]
        ang = positions[..., None].float() * freqs  # (B, S, d/2)
    else:
        if positions.ndim == 2:  # text-only: same position for all sections
            positions = positions[..., None].expand(*positions.shape, 3)
        t_s, h_s, w_s = mrope_sections
        if t_s + h_s + w_s != d // 2:
            raise ValueError("mrope sections must cover d/2")
        sec = torch.tensor([0] * t_s + [1] * h_s + [2] * w_s,
                           device=x.device)
        # (B, S, d/2): per-freq position from its section stream
        ang = positions.float()[..., sec] * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, H_kv, D)
    v: torch.Tensor


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int = 1024) -> torch.Tensor:
    """Flash recurrence in plain PyTorch: q/k/v (B, S, H, D), heads
    pre-repeated.

    Loops over kv chunks carrying (m, l, acc), the dependence closure of
    the query block, so no more than one (B, H, Sq, chunk) score block is
    held at once. The causal mask is bottom-aligned with offset Skv - Sq
    (not clamped), as in the reference. Under autograd each chunk is
    checkpointed, as the reference's: the backward recomputes the score
    block instead of keeping one per chunk.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq != hkv:
        raise ValueError("repeat kv heads before chunked_attention")
    qf = q.float() / math.sqrt(d)
    chunk = min(chunk, sk)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    # bottom-aligned causal (prefill continuation safe)
    offset = sk - sq if causal else None
    for start in range(0, sk, chunk):
        m, l, acc = maybe_checkpoint(
            _attention_chunk_step, qf, k[:, start:start + chunk],
            v[:, start:start + chunk], m, l, acc, start, offset)
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).transpose(1, 2)  # (B, S, H, D)
    return out.to(q.dtype)


def _attention_chunk_step(qf, kc, vc, m, l, acc, start: int,
                          offset: int | None):
    """One KV chunk of :func:`chunked_attention`: its (B, H, Sq, chunk)
    score block folded into the carried (m, l, acc). ``offset`` is the
    causal mask's (Skv - Sq), None when not causal."""
    kb, vb = kc.float(), vc.float()
    s = torch.einsum("bshd,bkhd->bhsk", qf, kb)
    if offset is not None:  # the last chunk may be short: no padded tail
        q_ids = torch.arange(qf.shape[1], device=qf.device)[:, None]
        kv_ids = torch.arange(start, start + kb.shape[1],
                              device=qf.device)[None, :]
        s = s.masked_fill(kv_ids > q_ids + offset, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bhsk,bkhd->bhsd", p, vb)
    return m_new, l, acc


def maybe_checkpoint(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant)
    when autograd records: the backward recomputes ``fn``'s intermediates
    instead of keeping them, as the reference's ``jax.checkpoint``. The
    models draw no random numbers, so no RNG state is kept for the
    recomputation."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int) -> torch.Tensor:
    """One-token attention against a cache: q (B, 1, Hq, D), k/v
    (B, S, Hkv, D); cache rows at or past ``length`` are masked.

    Plain einsum + masked softmax in fp32. The reference contracts in the
    cache dtype with fp32 accumulation; here the operands are upcast,
    which is the same for an fp32 cache.
    """
    b, _, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    qg = (q.reshape(b, hkv, g, d) / math.sqrt(d)).to(k.dtype)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float())
    mask = torch.arange(sk, device=q.device)[None, None, None, :] < length
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, 1, hq, d).to(q.dtype)


# --------------------------------------------------------------------------
# Attention sublayer (projections + rope + cache plumbing)
# --------------------------------------------------------------------------

class _MetaDraw:
    """Stands in for a generator on the ``meta`` device, which has none
    (``torch.Generator(device="meta")`` raises): the init functions put
    each tensor on its ``device`` and :func:`normal_init` draws nothing."""

    device = torch.device("meta")


META_DRAW = _MetaDraw()


def normal_init(generator: torch.Generator, shape, std: float, dtype):
    t = torch.empty(shape, dtype=dtype, device=generator.device)
    return t if t.is_meta else t.normal_(0.0, std, generator=generator)


def init_attention(generator: torch.Generator, cfg, d_model=None,
                   dtype=torch.bfloat16) -> nn.ParameterDict:
    """Attention parameters on ``generator``'s device, distributed as the
    reference's: N(0, 1/d) in, N(0, 1/(Hq*Dh)) out, zero biases."""
    d = d_model or cfg.d_model
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(hq * dh)
    p = {
        "wq": normal_init(generator, (d, hq * dh), s_in, dtype),
        "wk": normal_init(generator, (d, hkv * dh), s_in, dtype),
        "wv": normal_init(generator, (d, hkv * dh), s_in, dtype),
        "wo": normal_init(generator, (hq * dh, d), s_out, dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((n,), dtype=dtype, device=generator.device)
    return nn.ParameterDict(p)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, attn_impl: str = "flash") -> torch.Tensor:
    """Prefill attention on (B, S, H, D) activations.

    ``"flash"``: the flash-attention op on (B, H, S, D) views, GQA by
    index; ``"chunked"``: kv heads repeated to the query heads, then
    :func:`chunked_attention`.
    """
    if attn_impl == "flash":
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal)
        return o.transpose(1, 2)
    if attn_impl == "chunked":
        g = q.shape[2] // k.shape[2]
        if g > 1:
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        return chunked_attention(q, k, v, causal=causal)
    raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                     f"{attn_impl!r}")


def attention_sublayer(p, x, cfg, positions, *, causal=True,
                       cache: KVCache | None = None,
                       cache_pos: int | None = None, kv_override=None,
                       rope: bool = True, attn_impl: str = "flash"):
    """Returns (y, new_cache).

    Modes:
      train/prefill: cache=None, or a fresh cache to fill; full attention.
      decode: x is (B, 1, D); cache holds past KV; cache_pos an int.
      cross-attention: kv_override = (k, v), each (B, S_enc, Hkv, D),
        precomputed from the encoder; q is not rotated, no cache is
        written, and a one-token x attends to all S_enc rows.

    The cache is updated in place (the reference returns an updated copy)
    and returned as ``new_cache``.
    """
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(b, s, hq, dh)
    if kv_override is None:
        k = x @ p["wk"]
        v = x @ p["wv"]
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        k = k.reshape(b, s, hkv, dh)
        v = v.reshape(b, s, hkv, dh)
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        k, v = kv_override

    new_cache = None
    if cache is not None and kv_override is None:
        if s == 1:  # decode: insert at cache_pos
            cache.k[:, cache_pos:cache_pos + 1] = k.to(cache.k.dtype)
            cache.v[:, cache_pos:cache_pos + 1] = v.to(cache.v.dtype)
            o = decode_attention(q, cache.k, cache.v, cache_pos + 1)
        else:  # prefill: write the whole prefix
            cache.k[:, :s] = k.to(cache.k.dtype)
            cache.v[:, :s] = v.to(cache.v.dtype)
            o = full_attention(q, k, v, causal=causal, attn_impl=attn_impl)
        new_cache = cache
    elif s == 1 and kv_override is not None:
        # cross-attention decode: the whole memory, no growth
        o = decode_attention(q, k, v, k.shape[1])
    else:
        o = full_attention(q, k, v, causal=causal, attn_impl=attn_impl)
    y = row_parallel(o.reshape(b, s, hq * dh), p["wo"])
    return y, new_cache


# --------------------------------------------------------------------------
# Dense SwiGLU FFN
# --------------------------------------------------------------------------

def init_ffn(generator: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.bfloat16) -> nn.ParameterDict:
    """FFN parameters on ``generator``'s device, N(0, 1/d_model) in and
    N(0, 1/d_ff) out, as the reference's."""
    si, so = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return nn.ParameterDict({
        "w1": normal_init(generator, (d_model, d_ff), si, dtype),
        "w3": normal_init(generator, (d_model, d_ff), si, dtype),
        "w2": normal_init(generator, (d_ff, d_model), so, dtype),
    })


def row_parallel(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The output projection ``h @ w`` in h's dtype (the reference's
    row-parallel einsum; on one device there is no reduction to shrink)."""
    return h @ w.to(h.dtype)


def ffn_sublayer(p, x):
    h = nn.functional.silu(x @ p["w1"]) * (x @ p["w3"])
    return row_parallel(h, p["w2"])
