"""GPU-only tests of the port: the CUDA fused-span, flash-attention and
SSD-scan kernels against their plain PyTorch versions, a deployment on the
GPU against the same deployment on the CPU, and the LMs' (Llama, Mamba2)
prefill and decode on the GPU against the CPU.

This file imports neither JAX nor ``repro``, so it runs on a GPU machine
that has only PyTorch: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``. Without a visible GPU each test skips itself.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch import convert, occam
from repro_torch.configs import get_smoke
from repro_torch.core.graph import chain
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_plain_call
from repro_torch.kernels.fused_span import kernel
from repro_torch.kernels.fused_span.ops import span_plain_call
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain_call
from repro_torch.launch.serve import generate
from repro_torch.models import cnn
from repro_torch.models.api import build_model, make_batch

C, P = "conv", "pool"

# (name, specs, hw, in_ch, residual edges, span)
CASES = [
    ("k1-s1", [(C, 1, 1, 0, 4), (C, 1, 1, 0, 8)], 8, 3, (), None),
    ("k5-s1", [(C, 5, 1, 2, 4), (C, 5, 1, 2, 4)], 10, 2, (), None),
    ("k3-s2", [(C, 3, 2, 1, 4), (C, 3, 1, 1, 8)], 10, 3, (), None),
    ("conv-pool-s2", [(C, 3, 1, 1, 4), (P, 2, 2, 0, 0), (C, 3, 2, 1, 8)],
     12, 3, (), None),
    ("pool-k3-s2-pad", [(C, 3, 1, 1, 4), (P, 3, 2, 1, 0)], 9, 3, (), None),
    # span (1, 4): (0, 2) crosses in from memory, (1, 4) adds from ring 0,
    # (2, 5) leaves the span so map 2 spills; stride-2 option-A shortcut
    ("res-src-spill", [(C, 3, 1, 1, 4)] * 3 + [(C, 3, 2, 1, 8),
                                                (C, 3, 1, 1, 8)],
     10, 3, ((0, 2), (1, 4), (2, 5)), (1, 4)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def numpy_params(net, rng):
    params = []
    for layer in net.layers:
        if layer.kind == "conv":
            fan_in = layer.k * layer.k * layer.in_ch
            params.append({
                "w": (rng.standard_normal(
                    (layer.k, layer.k, layer.in_ch, layer.out_ch),
                    np.float32) * np.sqrt(2.0 / fan_in)).astype(np.float32),
                "b": rng.standard_normal((layer.out_ch,), np.float32)
                * np.float32(0.1)})
        else:
            params.append({})
    return params


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,specs,hw,ch,edges,span", CASES,
                         ids=[c[0] for c in CASES])
def test_cuda_kernel_matches_plain_version(cuda, dtype, name, specs, hw, ch,
                                           edges, span):
    """The CUDA kernel equals its plain version on the card (fp32 1e-4
    with TF32 off; bf16 5e-2), output and spills, at out_rows 1 and 2, and
    each call is one counted launch."""
    rng = np.random.default_rng(0)
    net = chain(name, specs, in_h=hw, in_w=hw, in_ch=ch,
                residual_edges=edges)
    params = [{k: v.to(dtype) for k, v in p.items()} for p in
              convert.params_from_numpy(numpy_params(net, rng), cuda)]
    xs = torch.from_numpy(rng.standard_normal((2, hw, hw, ch),
                                              np.float32)).to(cuda, dtype)
    maps = cnn.reference_forward(params, xs, net, collect=True)
    a, b = span or (0, net.n_layers)
    cuts = [c for c in (a, b) if 0 < c < net.n_layers]
    spill = tuple(sorted({s for (s, t) in edges
                          if any(s < p < t for p in cuts) and a < s < b}))
    srcs = {s: maps[s] for (s, t) in edges if s < a < t <= b}
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for out_rows in (1, 2):
        before = kernel.launches
        got, got_sp = kernel.span_cuda_call(maps[a], params[a:b], net, a, b,
                                            out_rows=out_rows, srcs=srcs,
                                            spill=spill)
        assert kernel.launches == before + 1
        want, want_sp = span_plain_call(maps[a], params[a:b], net, a, b,
                                        out_rows=out_rows, srcs=srcs,
                                        spill=spill)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert set(got_sp) == set(spill)
        for m in spill:
            torch.testing.assert_close(got_sp[m].float(), want_sp[m].float(),
                                       rtol=tol, atol=tol)


@pytest.mark.cuda
def test_deployment_on_gpu_matches_cpu(cuda):
    """``compile()`` defaults to the GPU; its kernel-routed run equals the
    CPU deployment's plain-version run, with the same traffic counts."""
    net = chain("res", [(C, 3, 2, 1, 4), (P, 3, 2, 1, 0), (C, 3, 1, 1, 4),
                        (C, 3, 1, 1, 4), (C, 3, 2, 1, 8), (C, 3, 1, 1, 8)],
                in_h=16, in_w=16, in_ch=3, residual_edges=((2, 4), (4, 6)))
    rng = np.random.default_rng(1)
    params = numpy_params(net, rng)
    xs = rng.standard_normal((3, 16, 16, 3), np.float32)
    plan = occam.plan(net, 700)
    gpu = plan.place().compile()
    cpu = plan.place().compile(device="cpu")
    assert gpu.device.type == "cuda"
    before = kernel.launches
    got = gpu.run(params, xs)
    kernel_spans = sum(r.route == "pallas" for r in gpu.routes)
    assert kernel_spans > 0
    assert kernel.launches == before + kernel_spans
    want = cpu.run(params, xs)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert gpu.report().matches_prediction
    assert gpu.counter.total == cpu.counter.total


FLASH_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal): the reference's grid, slow cases
    # included, and one Sq > Skv causal case for the clamped offset
    (2, 4, 2, 64, 64, 32, True),
    (1, 4, 4, 48, 48, 16, False),
    (2, 8, 2, 32, 96, 64, True),
    (1, 2, 1, 1, 128, 32, False),
    (1, 2, 1, 1, 100, 32, True),
    (2, 4, 4, 80, 80, 64, True),
    (1, 16, 2, 64, 64, 128, True),
    (1, 4, 2, 48, 32, 16, True),
]


def flash_inputs(case, dev, dtype=torch.float32, seed=0):
    b, hq, hkv, sq, sk, d, _ = case
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev, dtype)
            for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(c) for c in FLASH_CASES])
def test_flash_kernel_matches_plain_f32(cuda, case):
    """fp32 within the reference test's 2e-5 band; one counted launch."""
    q, k, v = flash_inputs(case, cuda)
    before = flash_kernel.launches
    got = flash_kernel.flash_attention_cuda_call(q, k, v, causal=case[-1])
    assert flash_kernel.launches == before + 1
    want = flash_attention_plain_call(q, k, v, causal=case[-1])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", [(1, 4, 2, 64, 64, 64, True),
                                  (1, 2, 1, 1, 96, 32, False)])
def test_flash_kernel_matches_plain_half(cuda, case, dtype):
    q, k, v = flash_inputs(case, cuda, dtype, seed=7)
    got = flash_kernel.flash_attention_cuda_call(q, k, v, causal=case[-1])
    assert got.dtype == dtype
    want = flash_attention_plain_call(q, k, v, causal=case[-1])
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_reads_strided_views_and_valid_lengths(cuda, causal):
    """(B, S, H, D) activations go in as transposed views, without a copy;
    kv rows past seq_k_valid are masked and the causal offset comes from
    the valid lengths."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 70, 8, 64), generator=g).to(cuda).transpose(1, 2)
    k = torch.randn((2, 130, 2, 64), generator=g).to(cuda).transpose(1, 2)
    v = torch.randn((2, 130, 2, 64), generator=g).to(cuda).transpose(1, 2)
    kw = dict(causal=causal, seq_q_valid=60, seq_k_valid=111)
    got = flash_kernel.flash_attention_cuda_call(q, k, v, **kw)
    assert got.stride() == q.stride()
    want = flash_attention_plain_call(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_llama_smoke_serving_on_gpu_matches_cpu(cuda):
    """The same parameters on both devices: GPU prefill (one kernel launch
    per layer) and decode logits match the CPU's plain-version path, and
    greedy generation emits the same tokens."""
    cfg = get_smoke("llama3.2-1b")
    cpu_api = build_model(cfg, dtype=torch.float32, device="cpu")
    gpu_api = build_model(cfg, dtype=torch.float32)
    assert gpu_api.device.type == "cuda"
    params = cpu_api.init(torch.Generator().manual_seed(0))
    gpu_params = copy.deepcopy(params).to(cuda)
    prompt = make_batch(cfg, 2, 40, generator=torch.Generator().manual_seed(1))
    prompt.pop("labels")
    before = flash_kernel.launches
    got, got_caches = gpu_api.prefill(gpu_params, prompt, 48)
    assert flash_kernel.launches == before + cfg.n_layers
    want, want_caches = cpu_api.prefill(params, prompt, 48)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    tok = want[:, -1].argmax(-1)[:, None]
    got, _ = gpu_api.decode_step(gpu_params, tok, got_caches, 40)
    want, _ = cpu_api.decode_step(params, tok, want_caches, 40)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    out_gpu = generate(gpu_api, gpu_params, prompt, 8)
    out_cpu = generate(cpu_api, params, prompt, 8)
    assert torch.equal(out_gpu["tokens"].cpu(), out_cpu["tokens"])


SSD_CASES = [
    # (B, T, H, G, P, N, chunk): the reference's grid, slow cases included
    (2, 128, 4, 1, 16, 8, 32),
    (1, 100, 4, 2, 32, 16, 32),
    (1, 64, 2, 2, 8, 4, 64),
    (1, 256, 8, 1, 64, 128, 64),
    (2, 96, 4, 4, 16, 16, 16),
]


def ssd_inputs(case, dev, dtype=torch.float32, seed=0):
    """x, a = -softplus(normal), b, c as the reference's test makes them."""
    bsz, t, h, g, p, n, _ = case
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((bsz, t, h, p), generator=gen)
    a = -torch.nn.functional.softplus(torch.randn((bsz, t, h), generator=gen))
    b = torch.randn((bsz, t, g, n), generator=gen) * 0.5
    c = torch.randn((bsz, t, g, n), generator=gen) * 0.5
    return [v.to(dev, dtype) for v in (x, a, b, c)]


def close_scaled(got, want, atol):
    """max|got - want| <= atol * max(max|want|, 1), the reference's band."""
    scale = max(float(want.float().abs().max()), 1.0)
    torch.testing.assert_close(got.float() / scale, want.float() / scale,
                               rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_kernel_matches_plain_f32(cuda, case):
    """fp32 within the reference test's 2e-5 band (scaled by
    max(|plain|, 1)); the kernel's own chunk (64) against the case's
    chunk in the plain version; one counted launch."""
    x, a, b, c = ssd_inputs(case, cuda)
    before = ssd_kernel.launches
    got, state = ssd_kernel.ssd_scan_cuda_call(x, a, b, c)
    assert ssd_kernel.launches == before + 1 and state is None
    want, _ = ssd_scan_plain_call(x, a, b, c, chunk=case[-1])
    torch.cuda.synchronize()
    close_scaled(got, want, 2e-5)


@pytest.mark.cuda
def test_ssd_kernel_matches_plain_bf16(cuda):
    """The reference's bf16 case: y in bf16, math in fp32, within 5e-2."""
    case = (1, 128, 4, 1, 16, 16, 32)
    x, a, b, c = ssd_inputs(case, cuda, torch.bfloat16)
    got, _ = ssd_kernel.ssd_scan_cuda_call(x, a, b, c)
    assert got.dtype == torch.bfloat16
    want, _ = ssd_scan_plain_call(x, a, b, c, chunk=32)
    close_scaled(got, want, 5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 63, 200])
def test_ssd_kernel_state_in_and_out(cuda, t):
    """A nonzero state in, the state after the last (ragged) token out,
    and strided (B, T, H, P) views read in place."""
    case = (2, t, 4, 2, 32, 16, 32)
    x, a, b, c = ssd_inputs(case, cuda, seed=3)
    x = x.transpose(1, 2).contiguous().transpose(1, 2)  # strided view
    gen = torch.Generator().manual_seed(4)
    s0 = torch.randn((2, 4, 16, 32), generator=gen).to(cuda)
    got, got_s = ssd_kernel.ssd_scan_cuda_call(x, a, b, c, state0=s0,
                                               return_state=True)
    want, want_s = ssd_scan_plain_call(x, a, b, c, chunk=32, state0=s0,
                                       return_state=True)
    close_scaled(got, want, 2e-5)
    close_scaled(got_s, want_s, 2e-5)


@pytest.mark.cuda
def test_mamba_smoke_serving_on_gpu_matches_cpu(cuda):
    """The same parameters on both devices: GPU prefill (one SSD-kernel
    launch per layer, none in decode) matches the CPU's plain-version
    prefill in logits and every layer's state, decode logits match, and
    greedy generation emits the same tokens."""
    cfg = get_smoke("mamba2-1.3b")
    cpu_api = build_model(cfg, dtype=torch.float32, device="cpu")
    gpu_api = build_model(cfg, dtype=torch.float32)
    assert gpu_api.device.type == "cuda"
    params = cpu_api.init(torch.Generator().manual_seed(0))
    gpu_params = copy.deepcopy(params).to(cuda)
    prompt = make_batch(cfg, 2, 40, generator=torch.Generator().manual_seed(1))
    prompt.pop("labels")
    before = ssd_kernel.launches
    got, got_caches = gpu_api.prefill(gpu_params, prompt, 48)
    assert ssd_kernel.launches == before + cfg.n_layers
    want, want_caches = cpu_api.prefill(params, prompt, 48)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for g, w in zip(got_caches, want_caches):
        torch.testing.assert_close(g.state.cpu(), w.state, rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(g.conv.cpu(), w.conv, rtol=1e-4,
                                   atol=1e-4)
    tok = want[:, -1].argmax(-1)[:, None]
    got, _ = gpu_api.decode_step(gpu_params, tok, got_caches, 40)
    want, _ = cpu_api.decode_step(params, tok, want_caches, 40)
    assert ssd_kernel.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    out_gpu = generate(gpu_api, gpu_params, prompt, 8)
    out_cpu = generate(cpu_api, params, prompt, 8)
    assert torch.equal(out_gpu["tokens"].cpu(), out_cpu["tokens"])


@pytest.mark.cuda
def test_ssd_kernel_empty_sequence_launches_nothing(cuda):
    """T = 0: no launch; the state out is the state in (or zeros)."""
    x, a, b, c = ssd_inputs((2, 0, 4, 2, 8, 4, 16), cuda)
    s0 = torch.randn((2, 4, 4, 8), generator=torch.Generator().manual_seed(5)
                     ).to(cuda)
    before = ssd_kernel.launches
    y, state = ssd_kernel.ssd_scan_cuda_call(x, a, b, c, state0=s0,
                                             return_state=True)
    _, zeros = ssd_kernel.ssd_scan_cuda_call(x, a, b, c, return_state=True)
    assert ssd_kernel.launches == before
    assert y.shape == (2, 0, 4, 8)
    assert torch.equal(state, s0) and not bool(zeros.any())
