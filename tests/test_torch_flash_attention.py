"""The port's flash attention on CPU tensors (its plain version) against
the JAX package's flash attention (Pallas kernel in interpret mode) and
oracle, on the same numpy-made inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as j_kernel
from repro.kernels.flash_attention.ops import attention_ref as j_attention_ref
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, flash_attention_plain_call)

CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal): the reference's non-slow grid
    (2, 4, 2, 64, 64, 32, True),     # GQA causal
    (1, 4, 4, 48, 48, 16, False),    # MHA ragged blocks
    (2, 8, 2, 32, 96, 64, True),     # cross lengths, bottom-aligned causal
    (1, 2, 1, 1, 128, 32, False),    # decode: 1 query vs cache (MQA)
    (1, 2, 1, 1, 100, 32, True),     # decode causal, ragged cache
]


def qkv(case, seed=0):
    b, hq, hkv, sq, sk, d, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), np.float32),
            rng.standard_normal((b, hkv, sk, d), np.float32),
            rng.standard_normal((b, hkv, sk, d), np.float32))


def port(q, k, v, **kw):
    out = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              **kw)
    return out.float().numpy()


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_plain_flash_matches_jax_f32(case):
    """fp32 within the reference test's own 2e-5 band, against both the
    JAX flash attention and its oracle; the oracles agree too."""
    causal = case[-1]
    q, k, v = qkv(case)
    got = port(q, k, v, causal=causal)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, causal=causal, block_q=32,
                              block_k=32))
    ref = np.asarray(j_attention_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    mine = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                         causal=causal).numpy()
    np.testing.assert_allclose(mine, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", [(1, 4, 2, 64, 64, 64, True),
                                  (1, 2, 1, 1, 96, 32, False)])
def test_plain_flash_matches_jax_bf16(case):
    """bf16 inputs (the same values in both packages) within 5e-2."""
    causal = case[-1]
    jx = [jnp.asarray(x, jnp.bfloat16) for x in qkv(case, seed=7)]
    tx = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
          for x in jx]
    got = ops.flash_attention(*tx, causal=causal)
    assert got.dtype == torch.bfloat16
    want = j_flash(*jx, causal=causal, block_q=32, block_k=32)
    ref = j_attention_ref(*jx, causal=causal)
    for other in (want, ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(other, np.float32),
                                   rtol=5e-2, atol=5e-2)


def test_block_size_invariance():
    """Block sizes are the TPU tile: they change no value of the port's
    op, which equals the JAX op at either tiling."""
    case = (1, 4, 2, 64, 64, 32, True)
    q, k, v = qkv(case, seed=3)
    o1 = port(q, k, v, block_q=16, block_k=16)
    o2 = port(q, k, v, block_q=64, block_k=32)
    np.testing.assert_array_equal(o1, o2)
    jx = [jnp.asarray(x) for x in (q, k, v)]
    for bq, bk in ((16, 16), (64, 32)):
        np.testing.assert_allclose(
            o1, np.asarray(j_flash(*jx, block_q=bq, block_k=bk)),
            rtol=1e-5, atol=1e-6)


def test_rejects_bad_gqa():
    q = torch.zeros((1, 3, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)


def test_causal_offset_clamped_when_queries_outnumber_keys():
    """Sq > Skv under the causal mask: the kernel's offset is
    max(Skv - Sq, 0), so row r sees kv rows <= r, as the JAX flash
    attention does (its oracle masks the first Sq - Skv rows instead)."""
    case = (1, 4, 2, 48, 32, 16, True)
    q, k, v = qkv(case, seed=5)
    got = port(q, k, v, causal=True)
    jx = [jnp.asarray(x) for x in (q, k, v)]
    want = np.asarray(j_flash(*jx, causal=True, block_q=16, block_k=16))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    ref = np.asarray(j_attention_ref(*jx, causal=True))
    assert not np.allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_call_masks_rows_past_seq_k_valid(causal):
    """``flash_attention_plain_call`` keeps the TPU kernel's contract on
    padded inputs: kv rows at or past seq_k_valid are masked, and the
    causal offset comes from the valid lengths. Held against
    ``flash_attention_call`` itself on (B*H, S, D) block-padded views."""
    b, h, sq, sk, d = 2, 2, 32, 64, 16
    sq_valid, sk_valid = 20, 45
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, h, sq, d), np.float32)
    k = rng.standard_normal((b, h, sk, d), np.float32)
    v = rng.standard_normal((b, h, sk, d), np.float32)
    got = flash_attention_plain_call(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        seq_q_valid=sq_valid, seq_k_valid=sk_valid).numpy()
    want = j_kernel.flash_attention_call(
        *(jnp.asarray(x.reshape(b * h, -1, d)) for x in (q, k, v)),
        seq_q_valid=sq_valid, seq_k_valid=sk_valid, causal=causal,
        block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want).reshape(got.shape),
                               rtol=2e-5, atol=2e-5)


def test_fully_masked_rows_give_zero():
    """With no kv row to attend (seq_k_valid == 0), l == 0 and the row is
    0, as in the TPU kernel's finalize."""
    q = torch.randn((1, 2, 4, 16), generator=torch.Generator().manual_seed(0))
    k = torch.randn((1, 1, 8, 16), generator=torch.Generator().manual_seed(1))
    out = flash_attention_plain_call(q, k, k, causal=False, seq_k_valid=0)
    assert torch.equal(out, torch.zeros_like(out))


def test_cuda_route_rejects_cpu_tensors():
    """The kernel's wrapper never runs the plain version: a CPU tensor is
    refused (the op routes it to the plain version instead)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda_call)

    x = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda_call(x, x, x)
    with pytest.raises(ValueError, match="no flash-attention route"):
        ops.flash_attention(x.to("meta"), x.to("meta"), x.to("meta"))
