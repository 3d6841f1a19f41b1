"""GPU-only tests of the port: the CUDA fused-span kernel against its plain
PyTorch version, and a deployment on the GPU against the same deployment
on the CPU.

This file imports neither JAX nor ``repro``, so it runs on a GPU machine
that has only PyTorch: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``. Without a visible GPU each test skips itself.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert, occam
from repro_torch.core.graph import chain
from repro_torch.kernels.fused_span import kernel
from repro_torch.kernels.fused_span.ops import span_plain_call
from repro_torch.models import cnn

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
        pytest.skip("needs a CUDA device: the fused-span kernel has no CPU "
                    "mode (its plain version is tested on the CPU)")
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
