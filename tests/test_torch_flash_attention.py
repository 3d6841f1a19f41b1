"""The port's flash attention on CPU tensors (its plain version) against
the JAX package's flash attention (Pallas kernel in interpret mode) and
oracle, on the same numpy-made inputs; and, with no card, the numbers
behind the CUDA kernel's design: its 3xTF32 products and its
shared-memory budget."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as j_kernel
from repro.kernels.flash_attention.ops import attention_ref as j_attention_ref
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro_torch.kernels.flash_attention import kernel as t_kernel
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


def tf32(x: np.ndarray) -> np.ndarray:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped 13 bits to
    the magnitude's bits, then clear them."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_truncated(x: np.ndarray) -> np.ndarray:
    """The top 19 bits of an fp32, which a TF32 tensor core reads of an
    operand that is not already TF32 (the kernel's small parts)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_scores(q: np.ndarray, k: np.ndarray, passes: int) -> np.ndarray:
    """q kᵀ as the kernel's tensor cores form it, sums in float64: one pass
    multiplies the TF32-rounded operands; three add big x small and small
    x big, with small = x - big read to 19 bits."""
    qb, kb = tf32(q), tf32(k)
    s = qb.astype(np.float64) @ kb.T.astype(np.float64)
    if passes == 3:
        qs, ks = tf32_truncated(q - qb), tf32_truncated(k - kb)
        s += qb.astype(np.float64) @ ks.T.astype(np.float64)
        s += qs.astype(np.float64) @ kb.T.astype(np.float64)
    return s


def test_tf32_rounding_helper_matches_cvt_rna():
    """Ties go away from zero; below half of the dropped bits rounds
    down; the result keeps 10 mantissa bits."""
    one = np.float32(1.0)
    tie = np.float32(1.0 + 2.0 ** -11)   # exactly half a TF32 ulp above 1
    assert tf32(tie) == np.float32(1.0 + 2.0 ** -10)
    assert tf32(-tie) == np.float32(-(1.0 + 2.0 ** -10))
    assert tf32(np.float32(1.0 + 2.0 ** -12)) == one
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    assert not np.any(tf32(x).view(np.uint32) & np.uint32(0x1FFF))
    np.testing.assert_array_less(np.abs(tf32(x) - x), np.abs(x) * 2.0 ** -11
                                 + 1e-30)


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)],
                         ids=["3xTF32", "one TF32 pass"])
def test_tf32_scores_against_the_fp32_band(passes, within):
    """Scores of Llama-3.2-1B's head dim (64), q pre-scaled by 1/8 as the
    kernel does, on numpy-made randn rows: the three-term split product
    stays within the kernel's fp32 band (rtol = atol = 2e-5) of the fp32
    product, and a single TF32 pass does not, which is why fp32 inputs
    take three products and no TF32 mode serves them."""
    rng = np.random.default_rng(17)
    q = (rng.standard_normal((256, 64), np.float32) * np.float32(0.125))
    k = rng.standard_normal((256, 64), np.float32)
    want = q.astype(np.float64) @ k.T.astype(np.float64)
    fp32 = (q @ k.T).astype(np.float64)  # the fp32 product itself
    np.testing.assert_allclose(fp32, want, rtol=2e-5, atol=2e-5)
    got = tf32_scores(q, k, passes)
    assert np.allclose(got, fp32, rtol=2e-5, atol=2e-5) == within
    if within:
        assert np.abs(got - want).max() < 1e-5


def test_kernel_shared_memory_fits_four_ctas_per_sm():
    """The kernel's shared memory (``smem_bytes``, the twin of the
    source's): every instantiation fits a block's 227 KB, and at d = 64
    fp32 four CTAs fit an H100 SM (228 KB, 1 KB reserved per CTA), as
    its launch bounds ask."""
    for d in t_kernel.HEAD_DIMS:
        for itemsize in (4, 2):
            assert t_kernel.smem_bytes(d, itemsize) <= 232_448
    assert t_kernel.smem_bytes(64, 4) == 52_224
    assert 4 * (t_kernel.smem_bytes(64, 4) + 1024) <= 233_472
