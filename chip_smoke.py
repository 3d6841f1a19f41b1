#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Occam (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the script with a non-zero exit code:

1. Device and build: the GPU's name and power limit, the torch and CUDA
   versions, the CUDA kernels built from ``src/repro_torch/kernels/**/
   csrc/*.cu`` into ``build/`` (seconds printed). TF32 is turned off for
   cuDNN and for matmuls, so every fp32 comparison is full fp32.
2. Kernel vs plain: the fused-span kernel against its plain PyTorch
   version on the card — small spans (k in {1,3}, stride in {1,2}, pools,
   residual adds from a ring and from memory, spills) at out_rows 1 and 2
   in fp32 (rtol = atol = 1e-4) and one in bf16 (5e-2); then the five
   spans of ResNet-18 and AlexNet's span (0, 8) at full width, held to
   max|kernel - plain| <= 1e-3 * max|plain|: deep fp32 sums (fan-in up to
   4,608) taken in another order.
3. Main path: ``plan(resnet18(), 3_145_728).place().compile()`` serving
   requests of 8, 1 and 5 images at 224x224 (He-scaled random weights from
   ``--seed``), every span on the kernel, outputs against the layer-by-
   layer cuDNN oracle and ``report().matches_prediction``; then
   ``examples/alexnet.plan.json`` on 4 images at 227x227. The kernel's
   launch count is set to 0 just before each of the two paths and read
   just after it.
4. Times: CUDA events, median of 5 after a warm-up, per span for the
   kernel, its plain version and the cuDNN oracle, with the span's bound
   (multiply-adds of the taps inside the input, bytes moved once);
   whole-``run`` time at batch 8.

Then the LM serving path, Llama-3.2-1B at its full published width
(16 layers x d_model 2048, 32/8 heads of 64, d_ff 8192, vocab 128,256;
fp32, random weights from ``--seed``):

5. Flash kernel vs plain, on the card: the reference's test grid (GQA,
   ragged, cross lengths, decode rows, D = 16..128) and one Sq > Skv causal
   case in fp32 (rtol = atol = 2e-5), two bf16 cases (5e-2), and the
   slice's full-width shapes, q (4, 32, 1024, 64) against k/v
   (4, 8, 1024, 64) and a ragged (1, 32, 200, 64) prompt, held to
   max|kernel - plain| <= 1e-3 * max|plain|.
6. Main path ``llama3.2-1b-serve``: ``build_model`` on the GPU, then three
   requests through ``launch.serve.generate`` (batch x prompt -> gen:
   4 x 1024 -> 32, 1 x 200 -> 16, 4 x 32 -> 16), one kernel launch per
   layer in each prefill (48 in all; decode adds none); the first
   request's prefill logits against the ``attn_impl="chunked"`` prefill
   within 1e-3 * max|chunked|.
7. Times on the first request's shape: the kernel, its plain version and
   ``scaled_dot_product_attention`` (CUDA events, median of 5 after a
   warm-up) beside the kernel's bound; the whole prefill and one decode
   step; peak device memory. Then ``torch.profiler`` records one more
   prefill and one decode step: the device's busy time against the host
   clock, and the kernels that take the most device time.

Then the Mamba2 serving path, Mamba2-1.3B at its full published width
(48 layers x d_model 2048, d_inner 4096, 64 SSD heads of 64, d_state 128,
1 group, vocab 50,280; fp32, random weights from ``--seed``), after the
Llama path's tensors are freed and the peak-memory counter reset:

8. SSD-scan kernel vs plain, on the card: the reference's test grid
   (slow cases included) within 2e-5 x max(|plain|, 1) in fp32 and its
   bf16 case within 5e-2, one case with a nonzero state in and the state
   out, and the slice's full-width shapes, x (4, 1024, 64, 64) against
   b/c (4, 1024, 1, 128) and a ragged (1, 200, ...) prompt, y and final
   state held to max|kernel - plain| <= 1e-3 * max|plain|.
9. Main path ``mamba2-1.3b-serve``: ``build_model`` on the GPU, then the
   same three requests through ``launch.serve.generate``, one kernel
   launch per layer in each prefill (144 in all; decode adds none; the
   flash kernel is not launched); the first request's prefill logits and
   every layer's SSM state and conv window against the
   ``ssd_impl="chunked"`` prefill within 1e-3 * max|chunked|.
10. Times on the first request's shape: the kernel, its plain version and
   the chunked twin (CUDA events, median of 5 after a warm-up) beside the
   kernel's bound, counted from the recurrence (4 N P FLOP per token and
   head); the whole prefill and one decode step; peak device memory; a
   ``torch.profiler`` breakdown of one prefill and one decode step.

The line before the last is the kernels' JSON summary, one record per
path with that path's launches, errors and times; the last line is
``{"ok": true, "device": {...}}``. Without a visible GPU, or outside a
checkout of the repository, the script fails before printing a result.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FP32_TFLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
C, P = "conv", "pool"
SMALL_CASES = [
    # (name, layer specs, h = w, in_ch) — the reference's span test grid
    ("k1-s1", [(C, 1, 1, 0, 4), (C, 1, 1, 0, 8)], 8, 3),
    ("k3-s1-deep", [(C, 3, 1, 1, 4), (C, 3, 1, 1, 8), (C, 3, 1, 1, 4)], 8, 3),
    ("k5-s1", [(C, 5, 1, 2, 4), (C, 5, 1, 2, 4)], 10, 2),
    ("k3-s2", [(C, 3, 2, 1, 4), (C, 3, 1, 1, 8)], 10, 3),
    ("mixed-k", [(C, 5, 1, 2, 4), (C, 1, 1, 0, 8), (C, 3, 2, 1, 8)], 10, 3),
    ("conv-pool-s2", [(C, 3, 1, 1, 4), (P, 2, 2, 0, 0), (C, 3, 2, 1, 8)],
     12, 3),
    ("pool-k3-s2-pad", [(C, 3, 1, 1, 4), (P, 3, 2, 1, 0)], 9, 3),
    ("vgg-block", [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0),
                   (C, 3, 1, 1, 16)], 8, 3),
]

FLASH_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal): the reference's flash-attention
    # test grid, slow cases included, then one Sq > Skv causal case that
    # pins the clamped offset max(Skv - Sq, 0)
    (2, 4, 2, 64, 64, 32, True),
    (1, 4, 4, 48, 48, 16, False),
    (2, 8, 2, 32, 96, 64, True),
    (1, 2, 1, 1, 128, 32, False),
    (1, 2, 1, 1, 100, 32, True),
    (2, 4, 4, 80, 80, 64, True),
    (1, 16, 2, 64, 64, 128, True),
    (1, 4, 2, 48, 32, 16, True),
]
FLASH_BF16_CASES = [(1, 4, 2, 64, 64, 64, True), (1, 2, 1, 1, 96, 32, False)]
# Llama-3.2-1B's attention at the slice's prefill shapes
FLASH_FULL_WIDTH = [(4, 32, 8, 1024, 1024, 64, True),
                    (1, 32, 8, 200, 200, 64, True)]
# (batch, prompt length, tokens to generate) of the three requests
LM_REQUESTS = [(4, 1024, 32), (1, 200, 16), (4, 32, 16)]
LM_PATH = "llama3.2-1b-serve"

SSD_CASES = [
    # (B, T, H, G, P, N, chunk): the reference's SSD-scan test grid, slow
    # cases included; the chunk is the plain version's (the kernel's is 64)
    (2, 128, 4, 1, 16, 8, 32),
    (1, 100, 4, 2, 32, 16, 32),
    (1, 64, 2, 2, 8, 4, 64),
    (1, 256, 8, 1, 64, 128, 64),
    (2, 96, 4, 4, 16, 16, 16),
]
SSD_BF16_CASE = (1, 128, 4, 1, 16, 16, 32)
SSD_STATE_CASE = (2, 100, 4, 2, 32, 16, 32)
# Mamba2-1.3B's scan at the slice's prefill shapes: (B, T, H, G, P, N)
SSD_FULL_WIDTH = [(4, 1024, 64, 1, 64, 128), (1, 200, 64, 1, 64, 128)]
MAMBA_PATH = "mamba2-1.3b-serve"


def he_params(net, rng):
    """Numpy params with weights N(0, 2 / fan_in), so activations stay O(1)
    through a deep ReLU net, and small biases."""
    import numpy as np

    params = []
    for layer in net.layers:
        if layer.kind != "conv":
            params.append({})
            continue
        fan_in = layer.k * layer.k * layer.in_ch
        shape = (layer.k, layer.k, layer.in_ch, layer.out_ch)
        w = rng.standard_normal(shape, np.float32) * np.sqrt(2.0 / fan_in)
        b = rng.standard_normal((layer.out_ch,), np.float32) * 0.01
        params.append({"w": w.astype(np.float32), "b": b})
    return params


def in_range_taps(n_out, n_in, k, stride, pad):
    """(output position, tap) pairs along one axis whose input index lies
    inside [0, n_in): the taps the kernel multiplies. Taps on the zero
    padding are skipped, so they are no work."""
    return sum(1 for r in range(n_out) for d in range(k)
               if 0 <= r * stride - pad + d < n_in)


def span_cost(net, a, b, batch, spill, src_keys, itemsize=4):
    """(MACs, bytes, bound ms, bound_by) of one span launch. MACs count the
    in-range taps of every conv (pools do no multiply-adds); bytes count
    each input read once, each output written once, weights read once."""
    macs = 0
    for layer in net.layers[a:b]:
        if layer.kind == C:
            rows = in_range_taps(layer.out_h, layer.in_h, layer.k,
                                 layer.stride, layer.padding)
            cols = in_range_taps(layer.out_w, layer.in_w, layer.k,
                                 layer.stride, layer.padding)
            macs += rows * cols * layer.in_ch * layer.out_ch
    macs *= batch
    act = net.map_elems(a) + net.map_elems(b)
    act += sum(net.map_elems(s) for s in src_keys)
    act += sum(net.map_elems(m) for m in spill)
    weights = sum(layer.weight_elems + (layer.out_ch if layer.kind == C
                                        else 0) for layer in net.layers[a:b])
    nbytes = (batch * act + weights) * itemsize
    t_ops = 2 * macs / FP32_TFLOPS * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return macs, nbytes, max(t_ops, t_mem), \
        "operations" if t_ops >= t_mem else "bytes"


def flash_cost(b, hq, hkv, sq, sk, d, causal, itemsize=4):
    """(FLOP, bytes, bound ms, bound_by) of one flash-attention call. FLOP
    count 4 * d per (query, key) pair the mask lets through (2 * d for
    q . k, 2 * d for p * v); bytes count q and o once and k and v once per
    kv head."""
    offset = max(sk - sq, 0)
    pairs = (sum(min(r + offset + 1, sk) for r in range(sq)) if causal
             else sq * sk)
    flop = 4 * d * pairs * b * hq
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * itemsize
    t_ops = flop / FP32_TFLOPS * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return flop, nbytes, max(t_ops, t_mem), \
        "operations" if t_ops >= t_mem else "bytes"


def ssd_cost(bsz, t, h, g, p, n, state_in, itemsize=4):
    """(FLOP, bytes, bound ms, bound_by) of one SSD-scan call, counted
    from the recurrence and not from any chunking: per token and head, a
    multiply-add per state element for the update and one for the
    read-out, 4 N P FLOP. Bytes: x, y, a, B and C once each, the final
    state once, and the state in once when one is given."""
    flop = 4 * n * p * bsz * t * h
    nbytes = (2 * bsz * t * h * p + bsz * t * h + 2 * bsz * t * g * n) \
        * itemsize + (2 if state_in else 1) * bsz * h * n * p * 4
    t_ops = flop / FP32_TFLOPS * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return flop, nbytes, max(t_ops, t_mem), \
        "operations" if t_ops >= t_mem else "bytes"


def time_ms(torch, fn, reps=5):
    """Median device time of ``fn`` over ``reps`` runs after a warm-up,
    from CUDA events on the current stream."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def trace_breakdown(torch, name, fn, top=8):
    """Profile one call of ``fn`` (after a warm-up): print the host-clock
    time, the device's busy time and idle share, and the ``top`` kernels
    by device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    idle = max(0.0, 1 - busy_ms / wall_ms) * 100
    print(f"trace {name}: host clock {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle {idle:.2f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / 1e3 / busy_ms * 100:6.2f}% "
              f"x{e.count:<5d} {e.key[:90]}")


def lm_serving(torch, seed, compare) -> dict:
    """Phases 5-7: the flash kernel against its plain version, Llama-3.2-1B
    served at full width through ``generate``, and times. Returns the
    kernel's record for the ``kernels`` line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_plain_call)
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model, make_batch

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)

    def qkv(b, hq, hkv, sq, sk, d, dtype=torch.float32):
        return [torch.randn(shape, generator=gen).to(dev, dtype)
                for shape in ((b, hq, sq, d), (b, hkv, sk, d),
                              (b, hkv, sk, d))]

    # ---- 5. flash kernel vs plain, on the card ---------------------------
    worst = 0.0
    for case in FLASH_CASES:
        q, k, v = qkv(*case[:-1])
        got = fkernel.flash_attention_cuda_call(q, k, v, causal=case[-1])
        want = flash_attention_plain_call(q, k, v, causal=case[-1])
        err, _ = compare(f"flash {case}", got, want, 2e-5, 2e-5)
        worst = max(worst, err)
    for case in FLASH_BF16_CASES:
        q, k, v = qkv(*case[:-1], dtype=torch.bfloat16)
        got = fkernel.flash_attention_cuda_call(q, k, v, causal=case[-1])
        want = flash_attention_plain_call(q, k, v, causal=case[-1])
        compare(f"flash bf16 {case}", got, want, 5e-2, 5e-2)
    print(f"flash kernel vs plain: {len(FLASH_CASES)} fp32 cases within "
          f"2e-5 (worst max|kernel-plain| {worst:.3e}), "
          f"{len(FLASH_BF16_CASES)} bf16 cases within 5e-2")
    full_err = 0.0
    for case in FLASH_FULL_WIDTH:
        q, k, v = qkv(*case[:-1])
        got = fkernel.flash_attention_cuda_call(q, k, v, causal=case[-1])
        want = flash_attention_plain_call(q, k, v, causal=case[-1])
        err, scale = compare(f"flash full width {case}", got, want,
                             rel=1e-3)
        full_err = max(full_err, err)
        print(f"flash full width q {case[0], case[1], case[3], case[5]} "
              f"kv heads {case[2]}: max|kernel-plain| {err:.3e} "
              f"(max|plain| {scale:.3e}, band 1e-3 x max|plain|)")
    torch.cuda.synchronize()

    # ---- 6. main path: Llama-3.2-1B served at full width ----------------
    cfg = get_config("llama3.2-1b")
    width = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.d_head, cfg.d_ff, cfg.vocab)
    if width != (16, 2048, 32, 8, 64, 8192, 128256):
        raise AssertionError(f"llama3.2-1b config {width}")
    api = build_model(cfg, dtype=torch.float32)
    if api.device.type != "cuda":
        raise AssertionError(f"model on {api.device}")
    t0 = time.perf_counter()
    params = api.init(torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{LM_PATH}: {n_params} parameters (fp32, "
          f"{n_params * 4 / 1e9:.3f} GB) drawn in "
          f"{time.perf_counter() - t0:.2f} s; {width[0]} layers x "
          f"{width[1]}, {width[2]}/{width[3]} heads of {width[4]}, d_ff "
          f"{width[5]}, vocab {width[6]}")
    prompts = []
    for i, (b, s, _) in enumerate(LM_REQUESTS):
        prompt = make_batch(cfg, b, s, device=dev,
                            generator=torch.Generator().manual_seed(
                                seed + 1 + i))
        prompt.pop("labels")
        prompts.append(prompt)
    fkernel.launches = 0
    outs = []
    for prompt, (b, s, g) in zip(prompts, LM_REQUESTS):
        before = fkernel.launches
        out = generate(api, params, prompt, g)
        toks = out["tokens"]
        if fkernel.launches - before != cfg.n_layers:
            raise AssertionError(f"request {b} x {s}: "
                                 f"{fkernel.launches - before} launches")
        if tuple(toks.shape) != (b, g) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab_padded:
            raise AssertionError(f"request {b} x {s}: tokens "
                                 f"{tuple(toks.shape)}")
        outs.append(out)
        print(f"{LM_PATH} request batch {b} prompt {s} gen {g}: "
              f"{cfg.n_layers} launches, tokens {tuple(toks.shape)}, "
              f"prefill_s {out['prefill_s']:.6f}, decode_tok_per_s "
              f"{out['decode_tok_per_s']:.3f}")
    launches = fkernel.launches
    if launches != cfg.n_layers * len(LM_REQUESTS):
        raise AssertionError(f"{LM_PATH}: {launches} launches")

    (b, s, g), prompt = LM_REQUESTS[0], prompts[0]
    chunked = build_model(cfg, dtype=torch.float32, attn_impl="chunked")
    logits, _ = api.prefill(params, prompt, s + g)
    want, _ = chunked.prefill(params, prompt, s + g)
    if tuple(logits.shape) != (b, 1, cfg.vocab_padded):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    err, scale = compare("prefill logits, flash vs chunked", logits, want,
                         rel=1e-3)
    ref_toks = generate(chunked, params, prompt, g)["tokens"]
    same = (outs[0]["tokens"] == ref_toks).int().cumprod(dim=1).sum(dim=1)
    print(f"{LM_PATH} request 1 prefill logits: max|flash-chunked| "
          f"{err:.3e} (max|chunked| {scale:.3e}, band 1e-3 x "
          f"max|chunked|); leading greedy tokens equal to the chunked "
          f"path's, per row: {same.tolist()} of {g}")

    # ---- 7. times on the first request's shape ---------------------------
    case = (b, cfg.n_heads, cfg.n_kv_heads, s, s, cfg.d_head, True)
    q, k, v = qkv(*case[:-1])
    k_ms = time_ms(torch, lambda: fkernel.flash_attention_cuda_call(
        q, k, v, causal=True))
    p_ms = time_ms(torch, lambda: flash_attention_plain_call(
        q, k, v, causal=True))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)

    compare("scaled_dot_product_attention vs plain", sdpa(),
            flash_attention_plain_call(q, k, v, causal=True), rel=1e-3)
    l_ms = time_ms(torch, sdpa)
    flop, nbytes, bound, bound_by = flash_cost(*case)
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = time_ms(torch, lambda: api.prefill(params, prompt, s + g))
    _, caches = api.prefill(params, prompt, s + g)
    tok = logits[:, -1].argmax(-1)[:, None]
    decode_ms = time_ms(torch, lambda: api.decode_step(params, tok, caches,
                                                       s))
    n = cfg.n_layers
    print(f"time flash attention {case[:-1]} causal fp32: kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, scaled_dot_product_attention "
          f"{l_ms:.4f} ms; {flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB, "
          f"bound {bound:.4f} ms ({bound_by}), kernel at "
          f"{bound / k_ms * 100:.2f}% of bound")
    print(f"time {LM_PATH} request 1 (batch {b}, prompt {s}): prefill "
          f"{prefill_ms:.3f} ms (CUDA events, median of 5), of which "
          f"{n} kernel calls {n * k_ms:.3f} ms = "
          f"{n * k_ms / prefill_ms * 100:.2f}%; decode step "
          f"{decode_ms:.3f} ms, {b / decode_ms * 1e3:.2f} tokens/s")
    print(f"peak device memory during the timed prefill and decode "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    trace_breakdown(torch, f"{LM_PATH} prefill",
                    lambda: api.prefill(params, prompt, s + g))
    trace_breakdown(torch, f"{LM_PATH} decode step",
                    lambda: api.decode_step(params, tok, caches, s))
    # times: one prefill of the first request, 16 calls
    return {"name": "flash_attention", "path": LM_PATH, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:111",
            "launches": launches, "max_abs_err": full_err, "ms": n * k_ms,
            "plain_ms": n * p_ms, "bound_ms": n * bound,
            "bound_by": bound_by, "library_ms": n * l_ms}


def mamba_serving(torch, seed, compare) -> dict:
    """Phases 8-10: the SSD-scan kernel against its plain version,
    Mamba2-1.3B served at full width through ``generate``, and times.
    Returns the kernel's record for the ``kernels`` line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain_call
    from repro_torch.launch.serve import generate
    from repro_torch.models import mamba
    from repro_torch.models.api import build_model, make_batch

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)

    def scan_inputs(bsz, t, h, g, p, n, dtype=torch.float32):
        x = torch.randn((bsz, t, h, p), generator=gen)
        a = -torch.nn.functional.softplus(torch.randn((bsz, t, h),
                                                      generator=gen))
        b = torch.randn((bsz, t, g, n), generator=gen) * 0.5
        c = torch.randn((bsz, t, g, n), generator=gen) * 0.5
        return [v.to(dev, dtype) for v in (x, a, b, c)]

    def close_scaled(name, got, want, atol):
        """The reference test's band, atol * max(max|plain|, 1)."""
        scale = max(float(want.float().abs().max()), 1.0)
        err, _ = compare(name, got.float() / scale, want.float() / scale,
                         0.0, atol)
        return err * scale

    # ---- 8. SSD-scan kernel vs plain, on the card -------------------------
    worst = 0.0
    for case in SSD_CASES:
        x, a, b, c = scan_inputs(*case[:-1])
        got, _ = skernel.ssd_scan_cuda_call(x, a, b, c)
        want, _ = ssd_scan_plain_call(x, a, b, c, chunk=case[-1])
        worst = max(worst, close_scaled(f"ssd {case}", got, want, 2e-5))
    x, a, b, c = scan_inputs(*SSD_BF16_CASE[:-1], dtype=torch.bfloat16)
    got, _ = skernel.ssd_scan_cuda_call(x, a, b, c)
    want, _ = ssd_scan_plain_call(x, a, b, c, chunk=SSD_BF16_CASE[-1])
    close_scaled(f"ssd bf16 {SSD_BF16_CASE}", got, want, 5e-2)
    bsz, t, h, g, p, n, chunk = SSD_STATE_CASE
    x, a, b, c = scan_inputs(bsz, t, h, g, p, n)
    s0 = torch.randn((bsz, h, n, p), generator=gen).to(dev)
    got, got_s = skernel.ssd_scan_cuda_call(x, a, b, c, state0=s0,
                                            return_state=True)
    want, want_s = ssd_scan_plain_call(x, a, b, c, chunk=chunk, state0=s0,
                                       return_state=True)
    worst = max(worst,
                close_scaled(f"ssd state in {SSD_STATE_CASE} y", got, want,
                             2e-5),
                close_scaled(f"ssd state in {SSD_STATE_CASE} state", got_s,
                             want_s, 2e-5))
    print(f"ssd kernel vs plain: {len(SSD_CASES) + 1} fp32 cases (one with "
          f"state in and out) within 2e-5 x max(|plain|, 1) (worst "
          f"max|kernel-plain| {worst:.3e}), 1 bf16 case within 5e-2")
    cfg = get_config("mamba2-1.3b")
    full_err = 0.0
    for shape in SSD_FULL_WIDTH:
        bsz, t, h, g, p, n = shape
        x, a, b, c = scan_inputs(*shape)
        s0 = torch.zeros((bsz, h, n, p), device=dev)
        got, got_s = skernel.ssd_scan_cuda_call(x, a, b, c, state0=s0,
                                                return_state=True)
        want, want_s = ssd_scan_plain_call(x, a, b, c, chunk=cfg.ssm.chunk,
                                           state0=s0, return_state=True)
        err, scale = compare(f"ssd full width {shape} y", got, want,
                             rel=1e-3)
        s_err, s_scale = compare(f"ssd full width {shape} state", got_s,
                                 want_s, rel=1e-3)
        full_err = max(full_err, err, s_err)
        print(f"ssd full width x {(bsz, t, h, p)} b/c {(bsz, t, g, n)}: "
              f"max|kernel-plain| y {err:.3e} (max|plain| {scale:.3e}), "
              f"state {s_err:.3e} (max|plain| {s_scale:.3e}); band 1e-3 x "
              f"max|plain|")
    torch.cuda.synchronize()

    # ---- 9. main path: Mamba2-1.3B served at full width -------------------
    ssm = cfg.ssm
    d = cfg.d_model
    width = (cfg.n_layers, d, ssm.d_inner(d), ssm.n_ssm_heads(d),
             ssm.head_dim, ssm.d_state, ssm.n_groups, cfg.vocab)
    if width != (48, 2048, 4096, 64, 64, 128, 1, 50280):
        raise AssertionError(f"mamba2-1.3b config {width}")
    api = build_model(cfg, dtype=torch.float32)
    if api.device.type != "cuda":
        raise AssertionError(f"model on {api.device}")
    t0 = time.perf_counter()
    params = api.init(torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.parameters())
    print(f"{MAMBA_PATH}: {n_params} parameters (fp32, "
          f"{n_params * 4 / 1e9:.3f} GB; the config's count without norm "
          f"and conv-bias vectors {cfg.param_count()[0]}) drawn in "
          f"{time.perf_counter() - t0:.2f} s; {width[0]} layers x "
          f"{width[1]}, d_inner {width[2]}, {width[3]} SSD heads of "
          f"{width[4]}, d_state {width[5]}, {width[6]} group, vocab "
          f"{width[7]}")
    prompts = []
    for i, (b, s, _) in enumerate(LM_REQUESTS):
        prompt = make_batch(cfg, b, s, device=dev,
                            generator=torch.Generator().manual_seed(
                                seed + 1 + i))
        prompt.pop("labels")
        prompts.append(prompt)
    flash_before = fkernel.launches
    skernel.launches = 0
    outs = []
    for prompt, (b, s, g) in zip(prompts, LM_REQUESTS):
        before = skernel.launches
        out = generate(api, params, prompt, g)
        toks = out["tokens"]
        if skernel.launches - before != cfg.n_layers:
            raise AssertionError(f"request {b} x {s}: "
                                 f"{skernel.launches - before} launches")
        if tuple(toks.shape) != (b, g) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab_padded:
            raise AssertionError(f"request {b} x {s}: tokens "
                                 f"{tuple(toks.shape)}")
        outs.append(out)
        print(f"{MAMBA_PATH} request batch {b} prompt {s} gen {g}: "
              f"{cfg.n_layers} launches, tokens {tuple(toks.shape)}, "
              f"prefill_s {out['prefill_s']:.6f}, decode_tok_per_s "
              f"{out['decode_tok_per_s']:.3f}")
    launches = skernel.launches
    if launches != cfg.n_layers * len(LM_REQUESTS):
        raise AssertionError(f"{MAMBA_PATH}: {launches} launches")
    if fkernel.launches != flash_before:
        raise AssertionError(f"{MAMBA_PATH}: the flash kernel launched "
                             f"{fkernel.launches - flash_before} times")

    (b, s, g), prompt = LM_REQUESTS[0], prompts[0]
    chunked = build_model(cfg, dtype=torch.float32, ssd_impl="chunked")
    logits, caches = api.prefill(params, prompt, s + g)
    want, want_caches = chunked.prefill(params, prompt, s + g)
    if tuple(logits.shape) != (b, 1, cfg.vocab_padded):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    err, scale = compare("prefill logits, kernel vs chunked", logits, want,
                         rel=1e-3)
    state_err = 0.0
    for l, (got_c, want_c) in enumerate(zip(caches, want_caches)):
        if got_c.state.dtype != torch.float32:
            raise AssertionError(f"layer {l} state {got_c.state.dtype}")
        e, _ = compare(f"layer {l} SSM state, kernel vs chunked",
                       got_c.state, want_c.state, rel=1e-3)
        compare(f"layer {l} conv window, kernel vs chunked", got_c.conv,
                want_c.conv, rel=1e-3)
        state_err = max(state_err, e)
    tok = logits[:, -1].argmax(-1)[:, None]
    before = skernel.launches
    api.decode_step(params, tok, caches, s)
    if skernel.launches != before:
        raise AssertionError("a decode step launched the SSD-scan kernel")
    ref_toks = generate(chunked, params, prompt, g)["tokens"]
    same = (outs[0]["tokens"] == ref_toks).int().cumprod(dim=1).sum(dim=1)
    print(f"{MAMBA_PATH} request 1 prefill: logits max|kernel-chunked| "
          f"{err:.3e} (max|chunked| {scale:.3e}), worst layer state "
          f"{state_err:.3e}; band 1e-3 x max|chunked| per tensor, all "
          f"{cfg.n_layers} layers' states and conv windows held; decode "
          f"launches none; "
          f"leading greedy tokens equal to the chunked path's, per row: "
          f"{same.tolist()} of {g}")
    del caches, want_caches, chunked

    # ---- 10. times on the first request's shape --------------------------
    shape = (b, s, ssm.n_ssm_heads(d), ssm.n_groups, ssm.head_dim,
             ssm.d_state)
    x, a, bb, cc = scan_inputs(*shape)
    s0 = torch.zeros((b, shape[2], ssm.d_state, ssm.head_dim), device=dev)
    k_ms = time_ms(torch, lambda: skernel.ssd_scan_cuda_call(
        x, a, bb, cc, state0=s0, return_state=True))
    p_ms = time_ms(torch, lambda: ssd_scan_plain_call(
        x, a, bb, cc, chunk=ssm.chunk, state0=s0, return_state=True))
    s0_g = s0.reshape(b, ssm.n_groups, -1, ssm.d_state, ssm.head_dim)
    c_ms = time_ms(torch, lambda: mamba.ssd_chunked(
        x, a, bb, cc, n_groups=ssm.n_groups, chunk=ssm.chunk, state0=s0_g))
    flop, nbytes, bound, bound_by = ssd_cost(*shape, state_in=True)
    del x, a, bb, cc
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = time_ms(torch, lambda: api.prefill(params, prompt, s + g))
    _, caches = api.prefill(params, prompt, s + g)
    decode_ms = time_ms(torch, lambda: api.decode_step(params, tok, caches,
                                                       s))
    n = cfg.n_layers
    print(f"time ssd scan x {(b, s, shape[2], shape[4])} b/c "
          f"{(b, s, shape[3], shape[5])} fp32 with state in and out: kernel "
          f"{k_ms:.4f} ms, plain (chunk {ssm.chunk}) {p_ms:.4f} ms, chunked "
          f"twin (chunk {ssm.chunk}) {c_ms:.4f} ms; {flop / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.3f} MB, bound {bound:.4f} ms ({bound_by}), "
          f"kernel at {bound / k_ms * 100:.2f}% of bound")
    print(f"time {MAMBA_PATH} request 1 (batch {b}, prompt {s}): prefill "
          f"{prefill_ms:.3f} ms (CUDA events, median of 5), of which "
          f"{n} kernel calls {n * k_ms:.3f} ms = "
          f"{n * k_ms / prefill_ms * 100:.2f}%; decode step "
          f"{decode_ms:.3f} ms, {b / decode_ms * 1e3:.2f} tokens/s")
    print(f"peak device memory during the timed prefill and decode "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    trace_breakdown(torch, f"{MAMBA_PATH} prefill",
                    lambda: api.prefill(params, prompt, s + g))
    trace_breakdown(torch, f"{MAMBA_PATH} decode step",
                    lambda: api.decode_step(params, tok, caches, s))
    # times: one prefill of the first request, 48 calls; no single
    # PyTorch call computes the scan, so there is no library time
    return {"name": "ssd_scan", "path": MAMBA_PATH, "route": "cuda",
            "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:79",
            "launches": launches, "max_abs_err": full_err, "ms": n * k_ms,
            "plain_ms": n * p_ms, "bound_ms": n * bound,
            "bound_by": bound_by, "library_ms": None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script measures "
              "the port on a GPU", file=sys.stderr)
        return 2

    from repro_torch import convert, occam
    from repro_torch.core import closure
    from repro_torch.core.graph import chain
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_span import kernel
    from repro_torch.kernels.fused_span.ops import (crossing_source_keys,
                                                    span_plain_call)
    from repro_torch.models import cnn, zoo
    from repro_torch.occam import registry
    from repro_torch.runtime import span_engine

    # ---- 1. device and build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(libs)}")
    for path in libs.values():
        log = path.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  ptxas {path.stem}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def compare(name, got, want, rtol=None, atol=None, rel=None):
        """max|got - want|, after holding it to rtol/atol or, with ``rel``,
        to rel * max|want|; returns (err, max|want| or None)."""
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        err = float((got - want).abs().max())
        if rel is not None:
            scale = float(want.abs().max())
            if err > rel * scale:
                raise AssertionError(f"{name}: max|err| {err:.3e} > "
                                     f"{rel} x max|plain| {scale:.3e}")
            return err, scale
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name}: {m}")
        return err, None

    # ---- 2. kernel vs plain, on the card ---------------------------------
    small = [(name, chain(name, specs, in_h=hw, in_w=hw, in_ch=ch), 0, None)
             for name, specs, hw, ch in SMALL_CASES]
    res_net = chain("res-src-spill", [(C, 3, 1, 1, 4)] * 3
                    + [(C, 3, 2, 1, 8), (C, 3, 1, 1, 8)], in_h=10, in_w=10,
                    in_ch=3, residual_edges=((0, 2), (1, 4), (2, 5)))
    # span (1, 4): (0, 2) crosses in from memory, (1, 4) reads ring 0,
    # (2, 5) leaves the span, so map 2 spills
    small.append(("res-src-spill", res_net, 1, 4))
    n_small, small_err = 0, 0.0
    for name, net, a, b in small:
        b = net.n_layers if b is None else b
        params = convert.params_from_numpy(he_params(net, rng), dev)
        xs0 = torch.from_numpy(rng.standard_normal(
            (2,) + net.map_shape(0), np.float32)).to(dev)
        maps = cnn.reference_forward(params, xs0, net, collect=True)
        spill = span_engine.span_spills(
            net, [c for c in (a, b) if 0 < c < net.n_layers], a, b)
        srcs = {s: maps[s] for s in crossing_source_keys(net, a, b)}
        for out_rows in (1, 2):
            got, got_sp = kernel.span_cuda_call(
                maps[a], params[a:b], net, a, b, out_rows=out_rows,
                srcs=srcs, spill=spill)
            want, want_sp = span_plain_call(
                maps[a], params[a:b], net, a, b, out_rows=out_rows,
                srcs=srcs, spill=spill)
            err, _ = compare(f"{name} t={out_rows}", got, want, 1e-4, 1e-4)
            small_err = max(small_err, err)
            for m in spill:
                err, _ = compare(f"{name} spill {m}", got_sp[m], want_sp[m],
                                 1e-4, 1e-4)
                small_err = max(small_err, err)
            n_small += 1
        if name == "conv-pool-s2":
            p16 = [{k: v.to(torch.bfloat16) for k, v in p.items()}
                   for p in params]
            x16 = maps[a].to(torch.bfloat16)
            got, _ = kernel.span_cuda_call(x16, p16, net, a, b)
            want, _ = span_plain_call(x16, p16, net, a, b)
            compare(f"{name} bf16", got, want, 5e-2, 5e-2)
            n_small += 1
    torch.cuda.synchronize()
    print(f"kernel vs plain: {n_small} small cases within fp32 1e-4 "
          f"(bf16 5e-2); worst fp32 max|kernel-plain| {small_err:.3e}")

    resnet, alexnet = zoo.resnet18(), zoo.alexnet()
    res_params_np = he_params(resnet, rng)
    alex_params_np = he_params(alexnet, rng)
    res_params = convert.params_from_numpy(res_params_np, dev)
    alex_params = convert.params_from_numpy(alex_params_np, dev)
    xs_res = rng.standard_normal((8, 224, 224, 3), np.float32)
    xs_alex = rng.standard_normal((4, 227, 227, 3), np.float32)
    res_maps = cnn.reference_forward(
        res_params, convert.array_from_numpy(xs_res, dev), resnet,
        collect=True)
    alex_maps = cnn.reference_forward(
        alex_params, convert.array_from_numpy(xs_alex, dev), alexnet,
        collect=True)
    res_plan = occam.plan(resnet, 3_145_728)
    if res_plan.boundaries != [12, 15, 16, 17]:
        raise AssertionError(f"resnet18 cuts {res_plan.boundaries}")
    spans = [("resnet18", resnet, res_params, res_maps, r.start, r.end,
              res_plan.boundaries) for r in res_plan.routes]
    spans.append(("alexnet", alexnet, alex_params, alex_maps, 0, 8, []))
    # one record per main path: its own launches, errors and times
    paths = {name: dict(launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                        bound_ms=0.0, library_ms=0.0, t_ops=0.0, t_mem=0.0)
             for name in ("resnet18", "alexnet")}
    span_args = []
    for net_name, net, params, maps, a, b, cuts in spans:
        spill = span_engine.span_spills(net, cuts, a, b)
        src_keys = crossing_source_keys(net, a, b)
        kw = dict(srcs={s: maps[s] for s in src_keys}, spill=spill)
        got, got_sp = kernel.span_cuda_call(maps[a], params[a:b], net, a, b,
                                            **kw)
        want, want_sp = span_plain_call(maps[a], params[a:b], net, a, b,
                                        **kw)
        err, scale = compare(f"{net_name} span ({a}, {b})", got, want,
                             rel=1e-3)
        rec = paths[net_name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        for m in spill:
            sp_err, _ = compare(f"{net_name} span ({a}, {b}) spill {m}",
                                got_sp[m], want_sp[m], rel=1e-3)
            rec["max_abs_err"] = max(rec["max_abs_err"], sp_err)
        sched = closure.span_schedule(net, a, b, spill=spill)
        print(f"{net_name} span ({a}, {b}) batch {maps[a].shape[0]}: "
              f"max|kernel-plain| {err:.3e} (max|plain| {scale:.3e}, "
              f"band 1e-3 x max|plain|); in_rows {sched.in_rows}, "
              f"{sched.n_steps} steps, rings "
              f"{sched.scratch_elems() * 4 / 1e6:.3f} MB/image; "
              f"spill {list(spill)}, srcs {list(src_keys)}")
        span_args.append((net_name, net, params, maps, a, b, kw))
    torch.cuda.synchronize()

    # ---- 3. main paths: counts set to 0 just before each, read just after
    dep = res_plan.place().compile()
    routes = [r.route for r in dep.routes]
    if routes != ["pallas"] * 5:
        raise AssertionError(f"resnet18 routes {routes}")
    kernel.launches = 0
    for n in (8, 1, 5):
        before = kernel.launches
        y = dep.run(res_params, xs_res[:n])
        torch.cuda.synchronize()
        if kernel.launches - before != 5:
            raise AssertionError(f"request of {n}: "
                                 f"{kernel.launches - before} launches")
        if tuple(y.shape) != (n, 7, 7, 512):
            raise AssertionError(f"output shape {tuple(y.shape)}")
        err, scale = compare(f"resnet18 request of {n}", y, res_maps[-1][:n],
                             rel=1e-3)
        print(f"resnet18 request of {n}: 5 launches, output "
              f"{tuple(y.shape)}, max|run-oracle| {err:.3e} "
              f"(max|oracle| {scale:.3e})")
    paths["resnet18"]["launches"] = kernel.launches
    rep = dep.report()
    if not rep.matches_prediction:
        raise AssertionError(f"resnet18 traffic {rep}")
    print(f"resnet18 report: {rep.images} images, measured "
          f"{rep.measured_per_image:.0f} elems/image == predicted "
          f"{rep.offchip_elems:.0f}: matches_prediction True")
    alex_dep = occam.load_plan(
        str(ROOT / "examples" / "alexnet.plan.json")).place().compile()
    kernel.launches = 0
    y = alex_dep.run(alex_params, xs_alex)
    torch.cuda.synchronize()
    paths["alexnet"]["launches"] = kernel.launches
    if kernel.launches != 1 or [r.route for r in
                                alex_dep.routes] != ["pallas"]:
        raise AssertionError("alexnet plan did not run on the kernel")
    err, scale = compare("alexnet plan", y, alex_maps[-1], rel=1e-3)
    rep = alex_dep.report()
    if not rep.matches_prediction:
        raise AssertionError(f"alexnet traffic {rep}")
    print(f"alexnet plan, 4 images: 1 launch, output {tuple(y.shape)}, "
          f"max|run-oracle| {err:.3e} (max|oracle| {scale:.3e}), "
          f"matches_prediction True")

    # ---- 4. times -----------------------------------------------------------
    oracle = registry.get_engine(span_engine.ROUTE_ORACLE)
    for net_name, net, params, maps, a, b, kw in span_args:
        xs = maps[a]
        batch = xs.shape[0]
        stored = {a: xs, **kw["srcs"]}
        k_ms = time_ms(torch, lambda: kernel.span_cuda_call(
            xs, params[a:b], net, a, b, **kw))
        p_ms = time_ms(torch, lambda: span_plain_call(
            xs, params[a:b], net, a, b, **kw))
        o_ms = time_ms(torch, lambda: oracle.run(params, net, a, b, stored,
                                                 kw["spill"]))
        macs, nbytes, bound, bound_by = span_cost(
            net, a, b, batch, kw["spill"], tuple(kw["srcs"]))
        print(f"time {net_name} span ({a}, {b}) batch {batch}: kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, cuDNN oracle "
              f"{o_ms:.3f} ms; {macs / 1e9:.3f} GMAC in range, "
              f"{nbytes / 1e6:.3f} MB, bound {bound:.4f} ms ({bound_by}), "
              f"kernel at {bound / k_ms * 100:.2f}% of bound")
        rec = paths[net_name]
        rec["ms"] += k_ms
        rec["plain_ms"] += p_ms
        rec["library_ms"] += o_ms
        rec["bound_ms"] += bound
        rec["t_ops"] += 2 * macs / FP32_TFLOPS * 1e3
        rec["t_mem"] += nbytes / HBM_BYTES_PER_S * 1e3
    xs8 = convert.array_from_numpy(xs_res, dev)
    dep.run(res_params, xs8)
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        dep.run(res_params, xs8)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    run_ms = statistics.median(runs)
    res = paths["resnet18"]
    print(f"resnet18 Deployment.run batch 8: {run_ms:.3f} ms median of 5 "
          f"(host clock), {8 / run_ms * 1e3:.2f} images/s; kernel sum "
          f"{res['ms']:.3f} ms, bound sum {res['bound_ms']:.4f} ms")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB")

    flash_rec = lm_serving(torch, args.seed, compare)
    gc.collect()  # the Llama path's tensors go before Mamba's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ssd_rec = mamba_serving(torch, args.seed, compare)

    # fused-span times: one batch-8 run of ResNet-18's five spans, one
    # batch-4 run of AlexNet's span; launches: each path's run in phase 3
    print(json.dumps({"kernels": [{
        "name": "fused_span",
        "path": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/fused_span/csrc/fused_span.cu",
        "replaces": "src/repro/kernels/fused_span/kernel.py:210",
        "launches": rec["launches"],
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": "operations" if rec["t_ops"] >= rec["t_mem"] else "bytes",
        "library_ms": rec["library_ms"],
    } for name, rec in paths.items()] + [flash_rec, ssd_rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
