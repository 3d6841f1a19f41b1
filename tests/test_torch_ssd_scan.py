"""The port's SSD scan on CPU tensors (its plain version) against the JAX
package's SSD scan (Pallas kernel in interpret mode), its oracle and the
model's ``ssd_chunked``, on the same numpy-made inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref
from repro.models import mamba as j_mamba
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda_call
from repro_torch.kernels.ssd_scan.ref import ssd_ref, ssd_scan_plain_call
from repro_torch.models import mamba

CASES = [
    # (B, T, H, G, P, N, chunk): the reference's grid, with its slow marks
    (2, 128, 4, 1, 16, 8, 32),
    (1, 100, 4, 2, 32, 16, 32),    # ragged T (padded)
    (1, 64, 2, 2, 8, 4, 64),       # single chunk
    pytest.param((1, 256, 8, 1, 64, 128, 64),   # mamba2-like dims
                 marks=pytest.mark.slow),
    pytest.param((2, 96, 4, 4, 16, 16, 16),     # B/C per head
                 marks=pytest.mark.slow),
]


def make(case, seed=0):
    """x, a = -softplus(normal), b, c = 0.5 normal, as numpy fp32."""
    bsz, t, h, g, p, n, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, t, h, p), np.float32)
    a = -np.logaddexp(0.0, rng.standard_normal((bsz, t, h))).astype(
        np.float32)
    b = rng.standard_normal((bsz, t, g, n), np.float32) * np.float32(0.5)
    c = rng.standard_normal((bsz, t, g, n), np.float32) * np.float32(0.5)
    return x, a, b, c


def t(x):
    return torch.from_numpy(np.array(x))


def close_scaled(got, want, atol):
    """The reference's band: |got - want| <= atol * max(max|want|, 1)."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale,
                               want / scale, atol=atol, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_plain_scan_matches_jax_f32(case):
    """The op's CPU route against the JAX op (Pallas, interpret mode)
    within the reference test's 2e-5 band."""
    x, a, b, c = make(case)
    got = ops.ssd_scan(t(x), t(a), t(b), t(c), chunk=case[-1])
    want = j_ssd_scan(*(jnp.asarray(v) for v in (x, a, b, c)),
                      chunk=case[-1])
    assert got.dtype == torch.float32 and got.shape == x.shape
    close_scaled(got.numpy(), want, 2e-5)


def test_plain_scan_matches_jax_bf16():
    """bf16 inputs (the same values in both packages) within 5e-2."""
    case = (1, 128, 4, 1, 16, 16, 32)
    jx = [jnp.asarray(v, jnp.bfloat16) for v in make(case)]
    tx = [torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
          for v in jx]
    got = ops.ssd_scan(*tx, chunk=32)
    assert got.dtype == torch.bfloat16
    want = j_ssd_scan(*jx, chunk=32)
    close_scaled(got.float().numpy(), np.asarray(want, np.float32), 5e-2)


def test_ssd_ref_matches_jax():
    """The sequential recurrence on (BH, T, P) heads."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 40, 8), np.float32)
    a = -np.logaddexp(0.0, rng.standard_normal((3, 40))).astype(np.float32)
    b = rng.standard_normal((3, 40, 6), np.float32)
    c = rng.standard_normal((3, 40, 6), np.float32)
    got = ssd_ref(t(x), t(a), t(b), t(c))
    want = j_ssd_ref(*(jnp.asarray(v) for v in (x, a, b, c)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_chunk_size_invariance():
    """The inter-chunk state passing is exact: chunking changes no value
    beyond rounding, and both chunkings equal the JAX op."""
    case = (1, 128, 2, 1, 16, 8, 32)
    x, a, b, c = make(case, seed=5)
    o1 = ops.ssd_scan(t(x), t(a), t(b), t(c), chunk=16).numpy()
    o2 = ops.ssd_scan(t(x), t(a), t(b), t(c), chunk=128).numpy()
    np.testing.assert_allclose(o1, o2, rtol=1e-4, atol=1e-5)
    want = j_ssd_scan(*(jnp.asarray(v) for v in (x, a, b, c)), chunk=16)
    np.testing.assert_allclose(o1, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_decay_zero_is_cumulative_outer_product():
    """a = 0 (decay 1): the state is a running sum, y_t equals
    C_t . sum_{s<=t} B_s x_s^T."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 16, 1, 4), np.float32)
    b = rng.standard_normal((1, 16, 1, 4), np.float32)
    c = rng.standard_normal((1, 16, 1, 4), np.float32)
    a = np.zeros((1, 16, 1), np.float32)
    got = ops.ssd_scan(t(x), t(a), t(b), t(c), chunk=8).numpy()
    s = np.cumsum(b[0, :, 0, :, None] * x[0, :, 0, None, :], axis=0)
    want = np.einsum("tn,tnp->tp", c[0, :, 0], s)[None, :, None, :]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t_len", [37, 64, 100])
def test_plain_call_state_matches_jax_ssd_chunked(t_len, with_state):
    """``ssd_scan_plain_call``'s y and final state, from a zero or a
    nonzero state, against the JAX model's ``ssd_chunked`` at ragged T
    (its state is (B, G, R, N, P); the kernel's (B, H, N, P))."""
    case = (2, t_len, 4, 2, 16, 8, 32)
    x, a, b, c = make(case, seed=2)
    s0 = (np.random.default_rng(3).standard_normal((2, 2, 2, 8, 16),
                                                   np.float32)
          if with_state else None)
    got, state = ssd_scan_plain_call(
        t(x), t(a), t(b), t(c), chunk=32, return_state=True,
        state0=None if s0 is None else t(s0).reshape(2, 4, 8, 16))
    want, want_state = j_mamba.ssd_chunked(
        *(jnp.asarray(v) for v in (x, a, b, c)), n_groups=2, chunk=16,
        state0=None if s0 is None else jnp.asarray(s0))
    close_scaled(got.numpy(), want, 2e-5)
    close_scaled(state.reshape(2, 2, 2, 8, 16).numpy(), want_state, 2e-5)
    if s0 is None:  # no state asked for: the same y, no state
        y_only, none = ssd_scan_plain_call(t(x), t(a), t(b), t(c), chunk=32)
        assert none is None and torch.equal(y_only, got)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_chunked_twin_matches_jax(chunk, with_state):
    """The port's ``ssd_chunked`` (two-operand products) against the JAX
    one: y and state, several chunks with a ragged last one."""
    case = (2, 50, 6, 3, 8, 4, chunk)
    x, a, b, c = make(case, seed=4)
    s0 = (np.random.default_rng(6).standard_normal((2, 3, 2, 4, 8),
                                                   np.float32)
          if with_state else None)
    got, state = mamba.ssd_chunked(
        t(x), t(a), t(b), t(c), n_groups=3, chunk=chunk,
        state0=None if s0 is None else t(s0))
    want, want_state = j_mamba.ssd_chunked(
        *(jnp.asarray(v) for v in (x, a, b, c)), n_groups=3, chunk=chunk,
        state0=None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               rtol=1e-5, atol=1e-5)


def test_state_carries_across_calls():
    """Scanning T tokens at once equals scanning a prefix, then the rest
    from the prefix's state (what prefill then decode relies on)."""
    x, a, b, c = (t(v) for v in make((1, 90, 4, 1, 16, 8, 32), seed=8))
    whole, s_whole = ssd_scan_plain_call(x, a, b, c, return_state=True)
    y1, s1 = ssd_scan_plain_call(x[:, :50], a[:, :50], b[:, :50],
                                 c[:, :50], chunk=16, return_state=True)
    y2, s2 = ssd_scan_plain_call(x[:, 50:], a[:, 50:], b[:, 50:],
                                 c[:, 50:], chunk=32, state0=s1,
                                 return_state=True)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), whole,
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s2, s_whole, rtol=1e-4, atol=1e-5)


def test_rejects_bad_groups():
    x = torch.zeros((1, 8, 3, 4))
    b = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="multiple of G"):
        ops.ssd_scan(x, torch.zeros((1, 8, 3)), b, b)


def test_cuda_route_rejects_cpu_tensors():
    """The kernel's wrapper never runs the plain version: a CPU tensor is
    refused (the op routes it to the plain version instead), and a device
    with no route raises."""
    x = torch.zeros((1, 8, 2, 4))
    a = torch.zeros((1, 8, 2))
    b = torch.zeros((1, 8, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda_call(x, a, b, b)
    with pytest.raises(ValueError, match="no SSD-scan route"):
        ops.ssd_scan(x.to("meta"), a.to("meta"), b.to("meta"),
                     b.to("meta"))
