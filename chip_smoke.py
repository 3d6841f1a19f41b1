#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Occam (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the script with a non-zero exit code:

1. Device and build: the GPU's name and power limit, the torch and CUDA
   versions, the CUDA kernels built from ``src/repro_torch/kernels/**/
   csrc/*.cu`` into ``build/`` (seconds printed). TF32 is turned off for
   cuDNN and for matmuls, so every fp32 comparison is full fp32.
2. Kernel vs plain: the fused-span kernel against its plain PyTorch
   version on the card — small spans (k in {1,3,5,7,11}, stride in
   {1,2,4}, pools, residual adds from a ring and from memory with
   option-A channel padding, spills, rows that give every CTA of a
   16-CTA cluster a tile, K over several staging chunks) at out_rows 1
   and 2 in fp32 (rtol = atol = 1e-4) and one in bf16 (5e-2); then the five
   spans of ResNet-18 and AlexNet's span (0, 8) at full width, held to
   max|kernel - plain| <= 1e-3 * max|plain|: deep fp32 sums (fan-in up to
   4,608) taken in another order. The small fp32 cases run once more with
   ``kernel.CLUSTER_SIZES`` pinned to 8 CTAs a cluster.
3. Main path: ``plan(resnet18(), 3_145_728).place().compile()`` serving
   requests of 8, 1 and 5 images at 224x224 (He-scaled random weights from
   ``--seed``), every span on the kernel, outputs against the layer-by-
   layer cuDNN oracle and ``report().matches_prediction``; then
   ``examples/alexnet.plan.json`` on 4 images at 227x227. The kernel's
   launch count is set to 0 just before each of the two paths and read
   just after it.
4. Times: CUDA events, median of 5 after a warm-up, per span for the
   kernel, its plain version and the cuDNN oracle, with the span's bound
   (multiply-adds of the taps inside the input, bytes moved once), and
   the kernel's launch shape (clusters x CTAs, threads, dynamic shared
   memory, clusters resident at once, ptxas registers and spills of the
   fp32 instantiation); ResNet-18's spans at batch 8 must run on at
   least 128 CTAs. Whole-``run`` time at batch 8.
4b. Dtype policies at full width: ResNet-18 planned at 3,145,728 elements
   under ``dtype_policy="int8"`` (cuts [12, 15, 16, 17]) and ``"bf16"``
   ([12, 16]: one span of 4 convs, 256 -> 512 channels), every span on
   the kernel (its fp32 instantiation: the boundary maps are fake-
   quantized in fp32 buffers); one ``Deployment.run`` at batch 8 each
   (paths ``resnet18-int8`` and ``resnet18-bf16``, counted), traffic
   byte-exact (551,936 and 652,288 bytes per image), every output element
   within one step of the boundary dtype (the int8 scale; the bf16
   spacing at its magnitude) plus 1e-3 * max|oracle| of
   ``compile("oracle")`` of the same plan (cuDNN layer by layer, the same
   casts at the same boundaries), each span's kernel against its plain
   version on the policy's boundary maps (1e-3 * max|plain|), and the
   spans' times as in phase 4.
4c. Serving sessions: ``serve(params, round_batch=8)`` on the fp32 and the
   int8 deployments (paths ``resnet18-session`` and
   ``resnet18-int8-session``), 17 images submitted as 8, 1, 5 and 3: three
   rounds replayed from one CUDA graph, results in submit order and equal
   bit for bit to ``Deployment.run``, launches = spans x (1 warm-up + 3
   replays), ``report().matches_prediction`` over 17 images; a replayed
   round timed (CUDA events, median of 5) beside ``run`` at batch 8.
4d. Planning frontier and calibration: ``occam.autoplan(resnet18(),
   Fleet(chips=1, vmem_elems=3,145,728, macs_per_s=33.5e12,
   hbm_elems_per_s=3.35e12 / 4, dtype_policy=("fp32", "int8", "bf16")))``
   (six single-device candidates; JSON round trip). Path
   ``resnet18-frontier``: each candidate deployed on the card and run at
   batch 8 (launches counted), traffic exact, fp32 outputs within
   1e-3 * max|oracle| of the cuDNN oracle, every kernel span against its
   plain version on the oracle's boundary maps (1e-3 * max|plain|; int8
   and bf16 casts within one boundary step, as in 4b), and the seven span
   shapes no earlier phase ran timed as in phase 4. Path
   ``resnet18-calibrate``: ``Deployment.profile(params, iters=5)`` on
   ``best("throughput")`` (spans, MACs and payloads those of the stage
   plan, launches = kernel stages x 6), ``occam.calibrate``,
   ``Frontier.rescore`` (winners before and after; the rescored frontier
   and a calibrated plan saved and loaded), the calibrated period within
   10x of the served time per image at round_batch 1 (host clock; the
   round_batch 8 and analytic ratios printed), and ``Session.scale`` down
   to ``for_rate``'s candidate and back to the cached deployment with one
   capture; then the profiled spans at microbatch 1 against their plain
   versions, timed.
4e. The STAP pipeline (path ``resnet18-stap``), every mesh position on
   ``cuda:0``: ``place(replicas=(4, 1, 1, 1, 1), microbatch=2)`` (a 5 x 4
   mesh of 20 positions) ``.compile(device="cuda:0").run`` of 32 images
   (16 microbatches, 4 rounds of width 4, 8 ticks; launches counted:
   exactly 5 x 16 = 80), held within 1e-3 * max|oracle| of the cuDNN
   oracle, its largest difference from the single-device ``run`` of the
   same images printed, ``report()`` matching the prediction (200,704
   link elements an image, payload width 150,528); the same replicas at
   ``packing="sum"`` (8 positions) serving 17 images as 8, 1, 5 and 3 at
   round_batch 8, equal bit for bit to ``run``'s, one tick build; the
   int8 pipeline (ring state and payloads ``torch.int8``, traffic
   byte-exact, each boundary held as in 4b; the whole run printed);
   ``profile`` (its boundary hop > 0) and ``calibrate``; then the
   pipeline ``run``, a full ring tick, the hop and the single-device
   ``run`` of the same 32 images timed, and the path's spans over the
   run's 16 microbatches of 2 held against their plain versions and
   timed with them and the cuDNN oracle.
4f. The async serving engine: 64 images at 224x224 as 13 requests
   (8, 1, 5, 3, 8, 2, 7, 8, 1, 6, 8, 4, 3) from three tenants in turn,
   sent as numpy under one ``asyncio.run``. Path ``resnet18-async``:
   ``frontier.serve(params, objective="throughput", device="cuda",
   round_batch=8, max_wait_ms=2.0, max_pending=64, audit="error")`` on
   phase 4d's frontier: every ticket equal bit for bit to
   ``Deployment.run``, ``compile_count`` equal to a bare session's on the
   same mix (both 1), launches = spans x (captures + rounds dispatched,
   from ``describe()``), ``packs_overlapped`` >= 1,
   ``matches_prediction``. Path ``resnet18-stap-async``: ``AsyncEngine``
   over phase 4e's sum-packed ring deployment on the same mix: 0.0 from
   the single-device run, bit-equal to a bare ring session with its
   ``compile_count``, launches = stages x live slots. Then one damped
   autoscale switch (``windows=3``, three ``autoscale_step`` calls at a
   rate for which ``for_rate`` picks another candidate, three more that
   must not switch) with a ticket split across it and the DP disabled;
   ``occam.audit`` of the frontier, every placement and both deployments
   and ``occam.lint_serve()``, zero findings; and each engine's images/s
   on the mix beside its bare session's (five runs each), with the
   host-delivery p50/p99 of ``MetricsRing`` and the time the burst's
   13 submits take before the first round (host clock,
   ``torch.cuda.synchronize()`` before it is read: a ticket resolves
   before the device has finished its round), then one run of each
   under ``torch.profiler`` (host operations, the device's idle share).
   Each path's record times its spans on one round's work (a round of 8;
   a ring slot of 2) as in phase 4.

Then the LM serving path, Llama-3.2-1B at its full published width
(16 layers x d_model 2048, 32/8 heads of 64, d_ff 8192, vocab 128,256;
fp32, random weights from ``--seed``):

5. Flash kernel vs plain, on the card: the reference's test grid (GQA,
   ragged, cross lengths, decode rows, D = 16..128), one Sq > Skv causal
   case, cases that wrap the kernel's two-stage K/V ring several times and
   end on a ragged tile, and one Sq that is not a multiple of a warp's 16
   rows, in fp32 (rtol = atol = 2e-5); two bf16 cases (5e-2); and the
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
   ``scaled_dot_product_attention`` (CUDA events around one call, median
   of 5 after a warm-up, as for every kernel) beside the kernel's bound at
   the rate of the units it runs on (3xTF32 products on the tensor cores)
   and, for comparison with earlier rows, the fp32 CUDA-core bound; beside
   them, the mean of 16 kernel calls back to back, as a prefill's 16
   layers call it; the launch shape (CTAs, threads, dynamic shared
   memory, CTAs resident per SM, at least 2 at d = 64 fp32, 16- or 4-byte
   copies) and the ptxas registers and spills of the d = 64 fp32
   instantiation; the whole prefill and one decode step; peak device
   memory. Then ``torch.profiler`` records one more prefill and one
   decode step: the device's busy time against the host clock, and the
   kernels that take the most device time.

Then the Mamba2 serving path, Mamba2-1.3B at its full published width
(48 layers x d_model 2048, d_inner 4096, 64 SSD heads of 64, d_state 128,
1 group, vocab 50,280; fp32, random weights from ``--seed``), after the
Llama path's tensors are freed and the peak-memory counter reset:

8. SSD-scan kernel vs plain, on the card: the reference's test grid
   (slow cases included) within 2e-5 x max(|plain|, 1) in fp32 and its
   bf16 case within 5e-2, one case with a nonzero state in and the state
   out, and the slice's full-width shapes, x (4, 1024, 64, 64) against
   b/c (4, 1024, 1, 128) and a ragged (1, 200, ...) prompt, y and final
   state held to max|kernel - plain| <= 1e-3 * max|plain|. The scan's
   first kernel, each chunk's C B^T once per group, is also held on its
   own against its plain version on the same cases and bands. Since the
   plain version shares the kernels' C B^T per group, the scan's y is
   also held against ``ssd_ref``, the sequential recurrence on B and C
   gathered to the heads, on the fp32 grid (same band) and at full width
   (1e-3 * max|ref|).
9. Main path ``mamba2-1.3b-serve``: ``build_model`` on the GPU, then the
   same three requests through ``launch.serve.generate``, one kernel
   launch per layer in each prefill (144 in all; decode adds none; the
   flash kernel is not launched); the first request's prefill logits and
   every layer's SSM state and conv window against the
   ``ssd_impl="chunked"`` prefill within 1e-3 * max|chunked|.
10. Times on the first request's shape: the scan call (both kernels),
   its plain version and the chunked twin (CUDA events around one call,
   median of 5 after a warm-up, as for every kernel) beside the kernel's
   bound, counted from the recurrence (4 N P FLOP per token and head),
   and the C B^T pre-pass alone; beside them, the mean of 20 scan calls
   back to back, as they follow each other on the model's path; the
   launch shape (CTAs, threads, dynamic shared memory, CTAs resident per
   SM, at least 2 for the scan) and the ptxas registers and spills of
   both kernels' fp32 instantiations; the whole prefill and one decode
   step; peak device memory; a ``torch.profiler`` breakdown of one
   prefill and one decode step.

The line before the last is the kernels' JSON summary, one record per
path with that path's launches, errors and times; the last line is
``{"ok": true, "device": {...}}``. Without a visible GPU, or outside a
checkout of the repository, the script fails before printing a result.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FP32_TFLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
TF32_TFLOPS = 495e12    # H100 SXM TF32 on the tensor cores, dense
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
    # the cluster's split: all 16 CTAs get a tile, W_out and C_out not
    # multiples of it; K over three chunks; ResNet's and AlexNet's stems
    ("wide-40-72", [(C, 3, 1, 1, 72), (P, 2, 2, 0, 0)], 30, 40),
    ("deep-k-96", [(C, 3, 1, 1, 96), (C, 3, 1, 1, 24)], 8, 3),
    ("stem-7x7-s2", [(C, 7, 2, 3, 16), (P, 3, 2, 1, 0)], 32, 3),
    ("stem-11x11-s4", [(C, 11, 4, 0, 16), (P, 3, 2, 0, 0)], 39, 3),
]
# stride-2 option-A shortcut padding channels 8 -> 16, (name, span):
# from a ring, then from device memory
OPT_A = ([(C, 3, 1, 1, 8), (C, 3, 2, 1, 16), (C, 3, 1, 1, 16)], 12, 3,
         ((1, 3),), [("opt-a-ring", 0, 3), ("opt-a-memory", 2, 3)])

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
    # the two-stage K/V ring wrapped several times, ending on a ragged
    # tile; an Sq that is not a multiple of a warp's 16 rows
    (1, 8, 2, 300, 300, 64, True),
    (1, 4, 1, 130, 257, 128, False),
    (2, 4, 2, 37, 37, 32, True),
]
FLASH_BF16_CASES = [(1, 4, 2, 64, 64, 64, True), (1, 2, 1, 1, 96, 32, False)]
# Llama-3.2-1B's attention at the slice's prefill shapes
FLASH_FULL_WIDTH = [(4, 32, 8, 1024, 1024, 64, True),
                    (1, 32, 8, 200, 200, 64, True)]
# (batch, prompt length, tokens to generate) of the three requests
LM_REQUESTS = [(4, 1024, 32), (1, 200, 16), (4, 32, 16)]
LM_PATH = "llama3.2-1b-serve"
# ResNet-18's capacity (elements), and under each policy at that capacity
# (policy, cuts, bytes moved per image) as the planner predicts them
RES_CAPACITY = 3_145_728
POLICY_CASES = [("int8", [12, 15, 16, 17], 551_936),
                ("bf16", [12, 16], 652_288)]
# a session's submits: 17 images, rounds of 8, 7 masked lanes in the last
SESSION_SUBMITS = (8, 1, 5, 3)
# phase 4d's one-H100 fleet, at the data sheet's rates of the card the
# port is measured on (nvidia-smi: NVIDIA H100 80GB HBM3, 700.00 W): fp32
# 67 TFLOP/s on the CUDA cores = 33.5e12 multiply-adds/s, and HBM 3.35 TB/s
# in fp32 elements
FRONTIER_FLEET = dict(chips=1, vmem_elems=RES_CAPACITY, macs_per_s=33.5e12,
                      hbm_elems_per_s=HBM_BYTES_PER_S / 4,
                      dtype_policy=("fp32", "int8", "bf16"))
# the kernel spans of the frontier's candidates that no earlier phase ran
FRONTIER_NEW_SPANS = {(0, 8), (8, 14), (14, 15), (8, 12), (12, 14),
                      (14, 16), (0, 14)}
# phase 4e: ResNet-18's five stages with the (0, 12) stage replicated 4
# times (1.160e9 / 4 MACs against 2.890e8: balanced within 0.4%), two
# images a slot, 32 images streamed: 16 microbatches through 5 stages
STAP_REPLICAS = (4, 1, 1, 1, 1)
STAP_MICROBATCH = 2
STAP_IMAGES = 32
STAP_PATH = "resnet18-stap"
# phase 4f: 64 images at 224x224 as 13 requests from three tenants in turn
ASYNC_SUBMITS = (8, 1, 5, 3, 8, 2, 7, 8, 1, 6, 8, 4, 3)
ASYNC_TENANTS = 3
ASYNC_PATH = "resnet18-async"
STAP_ASYNC_PATH = "resnet18-stap-async"

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
    """(FLOP, bytes, bound ms, bound_by, fp32 CUDA-core bound ms) of one
    flash-attention call. FLOP count 4 * d per (query, key) pair the mask
    lets through (2 * d for q . k, 2 * d for p * v); bytes count q and o
    once and k and v once per kv head. The bound is at the rate of the
    units the kernel runs its products on: the TF32 tensor cores, with
    three products per multiply-add in fp32 (3xTF32: big x big, big x
    small, small x big) and one in bf16 or fp16 (one TF32 pass). The last
    value is the same FLOP on the fp32 CUDA cores (67 TFLOP/s, the bound
    of the kernel before it used the tensor cores), for comparison."""
    offset = max(sk - sq, 0)
    pairs = (sum(min(r + offset + 1, sk) for r in range(sq)) if causal
             else sq * sk)
    flop = 4 * d * pairs * b * hq
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * itemsize
    products = 3 if itemsize == 4 else 1
    t_ops = products * flop / TF32_TFLOPS * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return flop, nbytes, max(t_ops, t_mem), \
        "operations" if t_ops >= t_mem else "bytes", \
        max(flop / FP32_TFLOPS * 1e3, t_mem)


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


def fp32_ptxas(log, mangled):
    """'N registers, S bytes spill stores' of a kernel's fp32
    instantiation, named by a piece of its mangled name (the template's
    name, then ``If`` for float and any further template arguments), from
    the nvcc -Xptxas=-v log."""
    lines = log.read_text().splitlines() if log.exists() else []
    for i, line in enumerate(lines):
        if "Function properties for" in line and mangled in line:
            props = " ".join(lines[i + 1:i + 3])
            regs = re.search(r"Used (\d+) registers", props)
            spill = re.search(r"(\d+) bytes spill stores", props)
            if regs and spill:
                return f"{regs[1]} registers, {spill[1]} bytes spill stores"
    return "not in the build log"


def time_ms(torch, fn, reps=5, calls=1):
    """Median over ``reps`` samples, after a warm-up, of the time of
    ``calls`` back-to-back calls of ``fn`` divided by ``calls``, from CUDA
    events on the current stream. With one call a sample also holds the
    host's work before the first launch; with many, that work overlaps
    the device's work on the calls before it, as on a model's path."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
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


def host_trace(torch, name, fn, top=10):
    """Profile one call of ``fn`` (it synchronizes at its end): print the
    host-clock time, the device's busy time and idle share, and the
    ``top`` host operations by their own host time (CUDA runtime calls
    included), with their counts."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if str(e.device_type).endswith("CUDA")) / 1e3
    idle = max(0.0, 1 - busy_ms / wall_ms) * 100
    print(f"trace {name}: host clock {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle {idle:.2f}%; host operations by own "
          f"host time:")
    host = [e for e in events if e.self_cpu_time_total > 0]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms x{e.count:<6d} "
              f"{e.key[:80]}")


def new_record() -> dict:
    """A fused-span path's record: launches, kernel-vs-plain error and the
    sums of its spans' times and bounds (t_ops / t_mem decide bound_by)."""
    return dict(launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                bound_ms=0.0, library_ms=0.0, t_ops=0.0, t_mem=0.0)


def quant_step(torch, policy, got, want):
    """One quantization step of the policy's boundary dtype at each
    element: the int8 scale, or the bfloat16 spacing at the larger of the
    two magnitudes (2^-8 of the power of two at or below it)."""
    if policy.boundary == "int8":
        return torch.full_like(want, policy.scale)
    mag = torch.maximum(got.abs(), want.abs())
    return torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)


def hold_spans(torch, kernel, span_plain_call, compare, label, net, plan,
               params, xs, rec, check=lambda a, b: True, time_it=None):
    """Walk ``plan``'s spans on the oracle's own boundary maps, under the
    plan's dtype policy (fp32: no casts). For each kernel-routed span that
    ``check(a, b)`` selects: the kernel against its plain version before
    the cast (1e-3 x max|plain|, into ``rec["max_abs_err"]``), and under a
    quantizing policy the cast output against the oracle's within one step
    of the boundary dtype + 1e-3 x max|oracle| (the two sums round apart);
    then ``time_it(a, b, qparams, x, kw)`` if given. Spans routed to the
    oracle only feed the walk."""
    from repro_torch.kernels.fused_span.ops import crossing_source_keys
    from repro_torch.occam import registry
    from repro_torch.occam.quant import casting
    from repro_torch.runtime import span_engine

    oracle = registry.get_engine(span_engine.ROUTE_ORACLE)
    pol = plan.quant
    quantized = pol is not None and not pol.is_default
    qparams = casting.quantize_params(params, pol) if quantized else params

    def fq(t):
        return casting.fake_quant(t, pol.boundary, pol.scale) \
            if quantized else t

    stored = {0: fq(xs)}
    for r in plan.routes:
        a, b = r.start, r.end
        spill = span_engine.span_spills(net, plan.boundaries, a, b)
        kw = dict(srcs={s: stored[s]
                        for s in crossing_source_keys(net, a, b)},
                  spill=spill)
        x = stored[a]
        o_out, o_sp = oracle.run(qparams, net, a, b, stored, spill)
        if r.route == span_engine.ROUTE_KERNEL and check(a, b):
            got, got_sp = kernel.span_cuda_call(x, qparams[a:b], net, a, b,
                                                **kw)
            plain, plain_sp = span_plain_call(x, qparams[a:b], net, a, b,
                                              **kw)
            err, pscale = compare(f"{label} span ({a}, {b})", got, plain,
                                  rel=1e-3)
            for m in spill:
                e, _ = compare(f"{label} span ({a}, {b}) spill {m}",
                               got_sp[m], plain_sp[m], rel=1e-3)
                err = max(err, e)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            cast = ""
            if quantized:
                gap, differ = 0.0, 0.0
                for name, k_map, o_map in [(b, got, o_out)] + [
                        (m, got_sp[m], o_sp[m]) for m in spill]:
                    k_q, o_q = fq(k_map), fq(o_map)
                    d = (k_q - o_q).abs()
                    band = quant_step(torch, pol, k_q, o_q) \
                        + 1e-3 * float(o_q.abs().max())
                    if bool((d > band).any()):
                        raise AssertionError(
                            f"{label} span ({a}, {b}) map {name}: "
                            f"{int((d > band).sum())} elements past one "
                            f"{pol.boundary} step + 1e-3 x max|oracle|")
                    gap = max(gap, float(d.max()))
                    differ = max(differ, float((d > 0).float().mean()))
                cast = (f"; cast output against the oracle's on the same "
                        f"input: max gap {gap:.6e}, {differ * 100:.4f}% of "
                        f"elements differ, all within one {pol.boundary} "
                        f"step + 1e-3 x max|oracle|")
            print(f"{label} span ({a}, {b}): "
                  f"{net.span_weight_elems(a, b)} weight elements, "
                  f"max|kernel-plain| {err:.3e} (max|plain| {pscale:.3e}, "
                  f"band 1e-3 x max|plain|){cast}; spill {list(spill)}, "
                  f"srcs {sorted(kw['srcs'])}")
            if time_it is not None:
                time_it(a, b, qparams, x, kw)
        stored[b] = fq(o_out)
        stored.update({m: fq(v) for m, v in o_sp.items()})


def policy_paths(torch, occam, kernel, span_plain_call, compare, time_span,
                 paths, resnet, res_params, xs8) -> dict:
    """Phase 4b: ResNet-18 planned under the int8 and bf16 policies at full
    width, batch 8: cuts and routes, one counted ``Deployment.run`` each
    (paths ``resnet18-int8`` / ``resnet18-bf16``), byte-exact traffic, the
    output against the oracle deployment of the same plan, each span's
    kernel against its plain version on the policy's boundary maps, and
    the spans' times. Returns the policy deployments."""
    deps = {}
    for policy, cuts, per_image_bytes in POLICY_CASES:
        pol = occam.resolve_policy(policy)
        plan = occam.plan(resnet, RES_CAPACITY, dtype_policy=policy)
        routes = [r.route for r in plan.routes]
        if plan.boundaries != cuts or routes != ["pallas"] * plan.n_spans:
            raise AssertionError(f"resnet18 {policy}: cuts "
                                 f"{plan.boundaries}, routes {routes}")
        dep = deps[policy] = plan.place().compile()
        rec = paths[f"resnet18-{policy}"] = new_record()
        kernel.launches = 0
        y = dep.run(res_params, xs8)
        torch.cuda.synchronize()
        rec["launches"] = kernel.launches
        if kernel.launches != plan.n_spans:
            raise AssertionError(f"resnet18 {policy}: {kernel.launches} "
                                 f"launches")
        rep = dep.report()
        measured = rep.measured_bytes / rep.images
        if not (rep.matches_prediction and rep.matches_prediction_bytes) \
                or measured != per_image_bytes:
            raise AssertionError(f"resnet18 {policy} traffic {rep}")
        want = plan.place().compile("oracle").run(res_params, xs8)
        if not bool(torch.isfinite(y).all()) or y.shape != want.shape:
            raise AssertionError(f"resnet18 {policy} output")
        diff = (y - want).abs()
        scale = float(want.abs().max())
        step = quant_step(torch, pol, y, want)
        steps = diff / step
        beyond = float((diff > step + 1e-3 * scale).float().mean())
        print(f"resnet18 {policy}: cuts {plan.boundaries}, "
              f"{plan.n_spans} launches at batch 8, output "
              f"{tuple(y.shape)}; whole run against the oracle deployment: "
              f"max|run-oracle| {float(diff.max()):.6e} (max|oracle| "
              f"{scale:.6e}, 1e-3 x max|oracle| {1e-3 * scale:.6e}), "
              f"largest gap {float(steps.max()):.2f} {pol.boundary} "
              f"steps, elements that differ "
              f"{float((diff > 0).float().mean()) * 100:.4f}%, more than "
              f"one step + 1e-3 x max|oracle| "
              f"{beyond * 100:.4f}%; "
              f"measured {measured:.0f} bytes/image == predicted "
              f"{rep.offchip_bytes:.0f}: matches_prediction and "
              f"matches_prediction_bytes True")
        # span by span on the oracle's own boundary maps, then times
        hold_spans(torch, kernel, span_plain_call, compare,
                   f"resnet18 {policy}", resnet, plan, res_params, xs8, rec,
                   time_it=lambda a, b, qp, x, kw, rec=rec, policy=policy:
                   time_span(f"resnet18-{policy}", resnet, qp, x, a, b, kw,
                             rec))
        print(f"resnet18 {policy} spans at batch 8: kernel sum "
              f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, cuDNN "
              f"oracle {rec['library_ms']:.3f} ms, bound sum "
              f"{rec['bound_ms']:.4f} ms")
    return deps


def sessions(torch, kernel, compare, paths, fp32_dep, int8_dep, res_params,
             xs8, rng, run_ms) -> None:
    """Phase 4c: ``Deployment.serve(params, round_batch=8)`` on the fp32
    and the int8 ResNet-18 deployments (paths ``resnet18-session`` and
    ``resnet18-int8-session``): 17 images submitted as 8, 1, 5 and 3, so 3
    rounds, the last with 7 masked lanes. Results in submit order, equal
    bit for bit to ``Deployment.run`` on the same images, one CUDA-graph
    capture, the captured launches counted per replay, traffic matching
    the prediction; then a replayed round timed beside ``run``."""
    import numpy as np

    xs17 = torch.from_numpy(rng.standard_normal(
        (17,) + tuple(xs8.shape[1:]), np.float32)).to(xs8.device)
    offs = np.cumsum((0,) + SESSION_SUBMITS)
    reqs = [xs17[a:b] for a, b in zip(offs[:-1], offs[1:])]
    for label, dep, base in (("fp32", fp32_dep, "resnet18"),
                             ("int8", int8_dep, "resnet18-int8")):
        path = f"{base}-session"
        rec = paths[path] = new_record()
        spans = dep.plan.n_spans
        kernel.launches = 0
        sess = dep.serve(res_params, round_batch=8)
        tickets = [sess.submit(x) for x in reqs]
        res = sess.results()
        sess.sync()
        rec["launches"] = kernel.launches
        rounds = sess.serving_stats().rounds_served
        # the warm-up call before the capture launches once; every replay
        # adds the launches the capture recorded
        if (sess.compile_count, rounds, sess._step.launches_per_replay,
                kernel.launches) != (1, 3, spans, spans * (1 + rounds)):
            raise AssertionError(
                f"{path}: {sess.compile_count} captures, {rounds} rounds, "
                f"{sess._step.launches_per_replay} launches a replay, "
                f"{kernel.launches} launches")
        if [t.uid for t, _ in res] != [t.uid for t in tickets] or \
                [int(y.shape[0]) for _, y in res] != list(SESSION_SUBMITS):
            raise AssertionError(f"{path}: results out of submit order")
        for (t, y), x in zip(res, reqs):
            if not torch.equal(y, dep.run(res_params, x)):
                raise AssertionError(f"{path}: ticket {t.uid} differs from "
                                     f"Deployment.run")
        rep = sess.report()
        if rep.images != 17 or not rep.matches_prediction or \
                rep.matches_prediction_bytes is False:
            raise AssertionError(f"{path} traffic {rep}")
        run_ev_ms = time_ms(torch, lambda: dep.run(res_params, xs8))
        round_ms = time_ms(torch, lambda: sess._step(sess.params, xs8))
        timing = rep.timing
        print(f"{path}: {rounds} rounds of 8 (7 masked lanes in the last), "
              f"1 CUDA-graph capture, {sess._step.launches_per_replay} "
              f"launches a replay, {rec['launches']} launches (warm-up + "
              f"replays); results in "
              f"submit order, each equal bit for bit to Deployment.run; "
              f"report over {rep.images} images: matches_prediction True, "
              f"measured {rep.measured_bytes / rep.images:.0f} bytes/image"
              f" (matches_prediction_bytes {rep.matches_prediction_bytes})"
              f"; tick timer {timing['tick_count']} ticks, mean "
              f"{timing['tick_mean_s'] * 1e3:.3f} ms (host clock around "
              f"each replay call)")
        print(f"time {path}: a replayed round of 8 (copy in, replay, clone "
              f"out) {round_ms:.3f} ms (CUDA events, median of 5), "
              f"{8 / round_ms * 1e3:.2f} images/s; Deployment.run batch 8 "
              f"{run_ev_ms:.3f} ms (CUDA events, median of 5; phase 4's "
              f"host clock, fp32: {run_ms:.3f} ms)")
        spans_rec = paths[base]
        rec.update(max_abs_err=spans_rec["max_abs_err"], ms=round_ms,
                   **{k: spans_rec[k] for k in ("plain_ms", "bound_ms",
                                                "library_ms", "t_ops",
                                                "t_mem")})
        sess.close()


def frontier_phase(torch, occam, kernel, span_plain_call, compare,
                   time_span, paths, resnet, res_params, xs8, res_maps):
    """Phase 4d: the planning frontier and measured-cost calibration on
    ResNet-18 at full width. ``autoplan`` under a one-H100 fleet; every
    candidate deployed on the card and run at batch 8 (path
    ``resnet18-frontier``, counted), traffic exact, fp32 outputs against
    the oracle, every kernel span against its plain version on the
    oracle's boundary maps (quantized ones within one boundary step), the
    spans no earlier phase ran timed; then (path ``resnet18-calibrate``,
    counted) ``Deployment.profile``, ``occam.calibrate``, the calibrated
    period against served time, and ``Session.scale`` over the
    frontier."""
    from repro_torch.runtime.stap_pipeline import (model_stage_times,
                                                   plan_span_stages)

    out_dir = ROOT / "build" / "frontier"
    out_dir.mkdir(parents=True, exist_ok=True)
    fleet = occam.Fleet(**FRONTIER_FLEET)
    t0 = time.perf_counter()
    frontier = occam.autoplan(resnet, fleet, batch=1)
    plan_s = time.perf_counter() - t0
    print(f"frontier: autoplan(resnet18, {fleet.to_dict()}) in "
          f"{plan_s:.3f} s (host clock); stats {frontier.stats}")
    if occam.frontier_from_json(frontier.to_json()).to_dict() != \
            frontier.to_dict():
        raise AssertionError("frontier JSON round trip")

    def pallas_spans(cand):
        return [(r.start, r.end) for r in cand.plan.routes
                if r.route == "pallas"]

    for i, c in enumerate(frontier):
        print(f"  candidate {i}: {c.kind}, policy {c.plan.quant.boundary}, "
              f"cuts {c.plan.boundaries}, capacity {c.plan.capacity_elems}, "
              f"routes {[r.route for r in c.plan.routes]}, period "
              f"{c.period!r} s, traffic {c.traffic:.0f} elems "
              f"({c.traffic_bytes:.0f} bytes) per image")
    if any(c.kind != occam.SINGLE for c in frontier):
        raise AssertionError("a one-chip fleet gave a pipeline candidate")
    fast = frontier.best("throughput")
    r_low = 1e-3 * min(c.throughput for c in frontier)
    r_high = 10 * max(c.throughput for c in frontier)
    low = frontier.for_rate(r_low)
    want_picks = (([8, 14, 15, 16, 17], "float32"), ([14, 16], "bfloat16"))
    if ((fast.plan.boundaries, fast.plan.quant.boundary),
            (low.plan.boundaries, low.plan.quant.boundary)) != want_picks:
        raise AssertionError(f"frontier picks {fast.plan.boundaries} / "
                             f"{low.plan.boundaries}")

    # -- every candidate on the kernel: the counted runs ------------------
    rec = paths["resnet18-frontier"] = new_record()
    deps = [c.deploy(device="cuda") for c in frontier]
    kernel.launches = 0
    ys = [dep.run(res_params, xs8) for dep in deps]
    torch.cuda.synchronize()
    rec["launches"] = kernel.launches
    want = sum(len(pallas_spans(c)) for c in frontier)
    if kernel.launches != want:
        raise AssertionError(f"frontier runs: {kernel.launches} launches, "
                             f"not {want}")
    timed = set()
    for i, (c, dep, y) in enumerate(zip(frontier, deps, ys)):
        pol = c.plan.quant
        label = f"frontier {i} ({pol.boundary} {c.plan.boundaries})"
        rep = dep.report()
        if not rep.matches_prediction or (
                not pol.is_default and not rep.matches_prediction_bytes):
            raise AssertionError(f"{label} traffic {rep}")
        if not bool(torch.isfinite(y).all()) or \
                tuple(y.shape) != (xs8.shape[0], 7, 7, 512):
            raise AssertionError(f"{label} output")
        whole = ""
        if pol.is_default:
            err, scale = compare(f"{label} run", y, res_maps[-1], rel=1e-3)
            whole = (f"; max|run-oracle| {err:.3e} (max|oracle| "
                     f"{scale:.3e})")
        print(f"{label}: {len(pallas_spans(c))} kernel launches at batch 8, "
              f"measured {rep.measured_per_image:.0f} elems "
              f"({rep.measured_bytes / rep.images:.0f} bytes)/image == "
              f"predicted: matches_prediction True{whole}")

        def time_new(a, b, qp, x, kw, label=label):
            if (a, b) in FRONTIER_NEW_SPANS and (a, b) not in timed:
                timed.add((a, b))
                time_span("resnet18-frontier", resnet, qp, x, a, b, kw, rec)

        hold_spans(torch, kernel, span_plain_call, compare, label, resnet,
                   c.plan, res_params, xs8, rec, time_it=time_new)
    if timed != FRONTIER_NEW_SPANS:
        raise AssertionError(f"new spans timed: {sorted(timed)}")
    print(f"resnet18-frontier: {rec['launches']} launches over the six "
          f"candidates' runs; the {len(timed)} new spans at batch 8: kernel "
          f"sum {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, cuDNN "
          f"oracle {rec['library_ms']:.3f} ms, bound sum "
          f"{rec['bound_ms']:.4f} ms")

    # -- profile and calibrate ------------------------------------------
    crec = paths["resnet18-calibrate"] = new_record()
    dep = fast.deploy(device="cuda")
    plan = dep.plan
    stages = plan_span_stages(plan.net, plan.partition, routes=dep.routes)
    n_kernel = len(pallas_spans(fast))
    kernel.launches = 0
    prof = dep.profile(res_params, iters=5)
    torch.cuda.synchronize()
    prof_launches = kernel.launches
    if prof_launches != n_kernel * 6:
        raise AssertionError(f"profile: {prof_launches} launches, not "
                             f"{n_kernel} x 6")
    if (prof.spans != tuple(st.span for st in stages)
            or prof.stage_macs != model_stage_times(plan.net, stages)
            or prof.payload_elems != tuple(st.out_spec.elems
                                           for st in stages[:-1])
            or not all(s > 0 for s in prof.stage_seconds)):
        raise AssertionError(f"profile {prof}")
    cm = occam.calibrate(dep, res_params, rounds=5)
    print(f"profile of frontier.best('throughput') (microbatch "
          f"{prof.microbatch}, mean of 5 calls between CUDA events after a "
          f"warm-up): " + ", ".join(
              f"{s} {sec * 1e3:.4f} ms" for s, sec in
              zip(prof.spans, prof.stage_seconds))
          + f"; sum {sum(prof.stage_seconds) * 1e3:.4f} ms; "
          f"{prof_launches} launches ({n_kernel} stages x (1 + 5))")
    print(f"calibrate: macs_per_s {cm.macs_per_s!r}, stage_overhead_s "
          f"{cm.stage_overhead_s!r}, residual {cm.residual!r}, "
          f"compute_overhead_factor {cm.compute_overhead_factor!r} against "
          f"the fleet's {fleet.macs_per_s!r}")

    # -- rescore and persist ---------------------------------------------
    rescored = frontier.rescore(cm)

    def pick(f, objective):
        c = f.best(objective)
        return f"{c.plan.quant.boundary} {c.plan.boundaries} " \
               f"(period {c.period * 1e3:.4f} ms)"

    for objective in occam.OBJECTIVES:
        print(f"best('{objective}'): analytic {pick(frontier, objective)}; "
              f"calibrated {pick(rescored, objective)}")
    if any(c.plan.calibration != cm for c in rescored):
        raise AssertionError("a rescored plan lacks the calibration")
    rescored.save(str(out_dir / "resnet18.frontier.json"))
    if occam.load_frontier(str(out_dir / "resnet18.frontier.json")
                           ).to_dict() != rescored.to_dict():
        raise AssertionError("rescored frontier save/load")
    cal_plan = plan.with_calibration(cm)
    cal_plan.save(str(out_dir / "resnet18.plan.json"))
    loaded = occam.load_plan(str(out_dir / "resnet18.plan.json"))
    if loaded.to_dict() != cal_plan.to_dict() or loaded.calibration != cm:
        raise AssertionError("calibrated plan save/load")
    print(f"rescored frontier: {len(rescored)} candidates, each plan "
          f"carrying the calibration; save/load_frontier and the "
          f"calibrated plan's save/load_plan round-trip to equal dicts")

    # -- calibrated period against the machine ---------------------------
    best = rescored.best("throughput")
    analytic = next(c for c in frontier
                    if c.plan.boundaries == best.plan.boundaries
                    and c.plan.quant == best.plan.quant)
    bdep = best.deploy(device="cuda")
    measured = {}
    for rb in (prof.microbatch, 8):
        with bdep.serve(res_params, round_batch=rb) as s:
            s.submit(xs8[:rb])          # warm-up round (captures at rb)
            s.results()
            s.sync()
            t0 = time.perf_counter()
            s.submit(xs8)
            s.results()
            s.sync()
            measured[rb] = (time.perf_counter() - t0) / xs8.shape[0]
    m1 = measured[prof.microbatch]
    if not m1 / 10 <= best.period <= 10 * m1:
        raise AssertionError(f"calibrated period {best.period} s is not "
                             f"within 10x of the measured {m1} s/image")
    print(f"calibrated period of the rescored winner "
          f"({best.plan.quant.boundary} {best.plan.boundaries}) "
          f"{best.period * 1e3:.4f} ms; served (host clock around submit -> "
          f"results -> sync, 8 images, after a warm-up round): "
          + ", ".join(f"round_batch={rb} {m * 1e3:.4f} ms/image, "
                      f"calibrated/measured {best.period / m:.4f}"
                      for rb, m in measured.items())
          + f"; analytic period {analytic.period * 1e3:.6f} ms, "
          f"analytic/measured at round_batch={prof.microbatch} "
          f"{analytic.period / m1:.6f}")

    # -- autoscale over the analytic frontier ----------------------------
    dep = fast.deploy(device="cuda")
    sess = dep.serve(res_params, round_batch=8)
    sess.submit(xs8)
    low_sess = sess.scale(arrival_rate=r_low)
    if low_sess is sess or \
            low_sess.deployment is not low.deploy(device="cuda"):
        raise AssertionError("scale(r_low) did not hand over to "
                             "for_rate(r_low)'s deployment")
    (t_old, y_old), = sess.results()
    xs_new = torch.flip(xs8, [0])
    low_sess.submit(xs_new)
    (_t, y_new), = low_sess.results()
    high_sess = low_sess.scale(arrival_rate=r_high)
    for s in (sess, low_sess, high_sess):
        s.close()
    torch.cuda.synchronize()
    crec["launches"] = kernel.launches
    # checks after the count is read: runs made to compare do not count
    if high_sess.deployment is not dep or high_sess.compile_count != 1 \
            or dep._steps[8].builds != 1:
        raise AssertionError("scale(r_high) did not return to the cached "
                             "deployment with one capture")
    if t_old.images != xs8.shape[0] or \
            not torch.equal(y_old, dep.run(res_params, xs8)):
        raise AssertionError("the old session's results")
    if not torch.equal(y_new, low_sess.deployment.run(res_params, xs_new)):
        raise AssertionError("the scaled session differs from run")
    print(f"scale: fp32 {fast.plan.boundaries} session, 8 images, then "
          f"scale(arrival_rate={r_low!r}) -> bf16 {low.plan.boundaries} "
          f"(for_rate's pick; old results collected, new results equal "
          f"to Deployment.run bit for bit), then scale(arrival_rate="
          f"{r_high!r}) -> the same fp32 Deployment object, compile_count "
          f"{high_sess.compile_count}; resnet18-calibrate "
          f"{crec['launches']} launches (profile, calibrate, sessions)")

    # the calibrate path's spans at the profile's microbatch: the kernel
    # against its plain version, and times as in phase 4; ms is the
    # profile's own stage sum (CUDA events, mean of 5)
    x1 = xs8[:prof.microbatch]
    scratch = new_record()
    hold_spans(torch, kernel, span_plain_call, compare,
               f"calibrate microbatch {prof.microbatch}", resnet, fast.plan,
               res_params, x1, crec,
               time_it=lambda a, b, qp, x, kw: time_span(
                   "resnet18-calibrate", resnet, qp, x, a, b, kw, scratch))
    crec.update({k: scratch[k] for k in ("plain_ms", "bound_ms",
                                         "library_ms", "t_ops", "t_mem")})
    crec["ms"] = sum(prof.stage_seconds) * 1e3
    print(f"resnet18-calibrate spans at batch {prof.microbatch}: profile "
          f"sum {crec['ms']:.4f} ms (one-call medians {scratch['ms']:.4f}),"
          f" plain {crec['plain_ms']:.3f} ms, cuDNN oracle "
          f"{crec['library_ms']:.3f} ms, bound sum {crec['bound_ms']:.4f} "
          f"ms")
    return frontier


def stap_phase(torch, occam, kernel, span_plain_call, compare, time_span,
               paths, resnet, res_params, rng, smi):
    """Phase 4e (path ``resnet18-stap``): ResNet-18's STAP pipeline with
    every mesh position on ``cuda:0``. ``run`` of 32 images through the
    rectangular 5 x 4 mesh (counted: 5 kernel stages x 16 microbatches),
    held against the cuDNN oracle and the single-device ``run``; the
    sum-packed ring served 17 images as 8, 1, 5 and 3; the int8 pipeline;
    ``profile`` (the hop) and ``calibrate``; then times."""
    import numpy as np

    from repro_torch.models import cnn

    dev = torch.device("cuda", 0)
    xs = torch.from_numpy(rng.standard_normal(
        (STAP_IMAGES, 224, 224, 3), np.float32)).to(dev)
    want = cnn.reference_forward(res_params, xs, resnet)
    plan = occam.plan(resnet, RES_CAPACITY)
    single = plan.place().compile(device=dev)
    y_single = single.run(res_params, xs)
    kw = dict(replicas=STAP_REPLICAS, microbatch=STAP_MICROBATCH)
    dep = plan.place(**kw).compile(device="cuda:0")
    if dep.mesh.shape != {"stage": 5, "replica": 4} or \
            {str(d) for d in dep.mesh.flat} != {"cuda:0"}:
        raise AssertionError(f"stap mesh {dep.mesh}")

    # -- the counted run ------------------------------------------------
    rec = paths[STAP_PATH] = new_record()
    kernel.launches = 0
    y = dep.run(res_params, xs)
    torch.cuda.synchronize()
    rec["launches"] = kernel.launches
    n_mb = STAP_IMAGES // STAP_MICROBATCH
    if kernel.launches != plan.n_spans * n_mb:
        raise AssertionError(f"stap run: {kernel.launches} launches, not "
                             f"{plan.n_spans} x {n_mb}")
    err, scale = compare("stap run", y, want, rel=1e-3)
    vs_single = float((y - y_single).abs().max())
    pr = dep.pipeline(STAP_IMAGES).report()
    rep = dep.report()
    if (pr["link_elems_per_image"], pr["payload_width_padded"]) != \
            (200_704, 150_528) or not rep.matches_prediction:
        raise AssertionError(f"stap report {pr} {rep}")
    print(f"stap run: {STAP_IMAGES} images, replicas {STAP_REPLICAS}, "
          f"mesh 5 x 4 on cuda:0, {pr['n_microbatches']} microbatches of "
          f"{STAP_MICROBATCH}, round width {pr['round_width']}, "
          f"{pr['n_rounds']} rounds, {pr['n_ticks']} ticks; "
          f"{rec['launches']} launches; max|run-oracle| {err:.3e} "
          f"(max|oracle| {scale:.3e}); max|run - single-device run| "
          f"{vs_single!r}; link {pr['link_elems_per_image']} elems/image, "
          f"payload width {pr['payload_width_padded']}, conveyors "
          f"{pr['conveyor_elems_per_image']} in, "
          f"{pr['out_conveyor_elems_per_image']} out (elems/image); "
          f"matches_prediction True")

    # -- a sum-packed ring session ----------------------------------------
    sdep = plan.place(packing="sum", **kw).compile(device="cuda:0")
    offs = np.cumsum((0,) + SESSION_SUBMITS)
    before = kernel.launches
    sess = sdep.serve(res_params, round_batch=8)
    tickets = [sess.submit(xs[a:b]) for a, b in zip(offs[:-1], offs[1:])]
    res = sess.results()
    torch.cuda.synchronize()
    s_launches = kernel.launches - before
    got = torch.cat([v for _t, v in res])
    srep = sess.report()
    if [t.uid for t, _ in res] != [t.uid for t in tickets] or \
            not torch.equal(got, y[:offs[-1]]) or sess.compile_count != 1 \
            or not srep.matches_prediction or srep.images != offs[-1]:
        raise AssertionError(
            f"stap session: equal {torch.equal(got, y[:offs[-1]])}, "
            f"compile_count {sess.compile_count}, {srep}")
    ring = sdep.ring(STAP_MICROBATCH)
    print(f"stap session: packing sum on {sdep.mesh.shape['chip']} "
          f"positions, round_batch 8 (width {ring.round_width} x "
          f"{STAP_MICROBATCH}), {offs[-1]} images as {SESSION_SUBMITS}: "
          f"{srep.serving.rounds_served} rounds, {ring.timers.count} ticks, "
          f"{s_launches} launches; results in submit order and equal bit "
          f"for bit to the pipeline run's; compile_count 1; "
          f"matches_prediction True")

    # -- the int8 pipeline -----------------------------------------------
    plan8 = occam.plan(resnet, RES_CAPACITY, dtype_policy="int8")
    dep8 = plan8.place(packing="sum", **kw).compile(device="cuda:0")
    y8_single = plan8.place().compile(device=dev).run(res_params, xs[:8])
    with dep8.serve(res_params, round_batch=8) as sess8:
        t8 = sess8.submit(xs[:8])
        state_dtypes = {str(v.dtype) for v in sess8._state}
        (_t, y8), = sess8.results()
        rep8 = sess8.report()
    pay = dep8.ring(STAP_MICROBATCH).pack_round(xs[:8]).dtype
    if t8.images != 8 or state_dtypes != {"torch.int8"} or \
            pay != torch.int8 or not rep8.matches_prediction_bytes:
        raise AssertionError(f"stap int8: state {state_dtypes}, payload "
                             f"{pay}, {rep8}")
    hold_spans(torch, kernel, span_plain_call, compare, "stap int8",
               resnet, plan8, res_params, xs[:STAP_MICROBATCH],
               new_record())
    diff8 = (y8 - y8_single).abs()
    print(f"stap int8: ring state and payloads torch.int8, measured "
          f"{rep8.measured_bytes / rep8.images:.0f} bytes/image == "
          f"predicted: matches_prediction_bytes True; 8 images against "
          f"the single-device int8 run: max difference "
          f"{float(diff8.max())!r}, elements that differ "
          f"{float((diff8 > 0).float().mean()) * 100:.4f}%")

    # -- profile and calibrate ---------------------------------------------
    prof = dep.profile(res_params, iters=3)
    cm = occam.calibrate(dep, res_params, rounds=3)
    if not prof.hop_seconds > 0:
        raise AssertionError(f"stap profile {prof}")
    # the hop's work: a zeroed receive buffer per position of the rect
    # ring, and a read and a write per routed pair of slot 0
    hring = dep.ring(STAP_MICROBATCH)
    n_pos, n_pairs = len(hring.mesh.flat), len(hring.steady.slot_perm(0))
    hop_bytes = (n_pos + 2 * n_pairs) * STAP_MICROBATCH \
        * pr["payload_width_padded"] * 4
    print(f"stap profile (microbatch {prof.microbatch}, mean of 3 between "
          f"CUDA events): " + ", ".join(
              f"{s} {sec * 1e3:.4f} ms" for s, sec in
              zip(prof.spans, prof.stage_seconds))
          + f"; hop {prof.hop_seconds * 1e6:.3f} us (the device's "
          f"time for one slot of {STAP_MICROBATCH} x "
          f"{pr['payload_width_padded']} fp32 over the ring's routing, "
          f"queued ahead of the host: {n_pos} zeroed receive buffers and "
          f"{n_pairs} device-to-device copies in the H100's HBM, "
          f"{hop_bytes / 1e6:.3f} MB, bound "
          f"{hop_bytes / HBM_BYTES_PER_S * 1e6:.3f} us); calibrate: "
          f"macs_per_s "
          f"{cm.macs_per_s!r}, "
          f"stage_overhead_s {cm.stage_overhead_s!r}, link_s_per_elem "
          f"{cm.link_s_per_elem!r}, residual {cm.residual!r}")

    # -- times ----------------------------------------------------------
    def host_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    run_ms = host_ms(lambda: dep.run(res_params, xs))
    single_ms = host_ms(lambda: single.run(res_params, xs))
    state = ring.init_state()
    full = ring.pack_round(xs[:8])
    masks = np.ones((ring.ring_depth, ring.round_width), dtype=bool)
    tick_ms = time_ms(torch, lambda: ring.tick(res_params, state, full,
                                               masks))
    print(f"time stap ({smi}): pipeline run of {STAP_IMAGES} images "
          f"{run_ms:.3f} ms (host clock, median of 3), "
          f"{STAP_IMAGES / run_ms * 1e3:.2f} images/s; single-device run "
          f"of the same images {single_ms:.3f} ms, "
          f"{STAP_IMAGES / single_ms * 1e3:.2f} images/s; a full tick of "
          f"the packed ring (every stage live, 8 images) {tick_ms:.3f} ms "
          f"(CUDA events, median of 5); hop "
          f"{prof.hop_seconds * 1e6:.3f} us")

    # the path's record: each kernel span, its plain version and the
    # cuDNN oracle timed over the run's 16 microbatches of 2, one call per
    # microbatch (the kernel's 80 launches of the counted run), on the
    # oracle's boundary maps of the same 32 images; the bound counts the
    # 32 images' maps and each span's weights once
    from repro_torch.kernels.fused_span.ops import crossing_source_keys
    from repro_torch.occam import registry
    from repro_torch.runtime import span_engine

    oracle = registry.get_engine(span_engine.ROUTE_ORACLE)
    hold_spans(torch, kernel, span_plain_call, compare, "stap fp32",
               resnet, plan, res_params, xs[:STAP_MICROBATCH], rec)

    def span_calls(a, b, spill, cut):
        def kern():
            return [kernel.span_cuda_call(x, res_params[a:b], resnet, a, b,
                                          srcs=s, spill=spill)[0]
                    for x, s in cut]

        def plain():
            return [span_plain_call(x, res_params[a:b], resnet, a, b,
                                    srcs=s, spill=spill)[0]
                    for x, s in cut]

        def lib():
            return [oracle.run(res_params, resnet, a, b, {a: x, **s},
                               spill)[0] for x, s in cut]

        return kern, plain, lib

    stored = {0: xs}
    for r in plan.routes:
        a, b = r.start, r.end
        spill = span_engine.span_spills(resnet, plan.boundaries, a, b)
        keys = crossing_source_keys(resnet, a, b)
        if r.route == span_engine.ROUTE_KERNEL:
            cut = [(stored[a][i:i + STAP_MICROBATCH],
                    {k: stored[k][i:i + STAP_MICROBATCH] for k in keys})
                   for i in range(0, STAP_IMAGES, STAP_MICROBATCH)]
            kern, plain, lib = span_calls(a, b, spill, cut)
            for i, (got, want) in enumerate(zip(kern(), plain())):
                err, _ = compare(f"stap span ({a}, {b}) microbatch {i}",
                                 got, want, rel=1e-3)
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
            k_ms, p_ms, o_ms = (time_ms(torch, f) for f in (kern, plain,
                                                             lib))
            macs, nbytes, bound, bound_by = span_cost(
                resnet, a, b, STAP_IMAGES, spill, tuple(keys))
            rec["ms"] += k_ms
            rec["plain_ms"] += p_ms
            rec["library_ms"] += o_ms
            rec["bound_ms"] += bound
            rec["t_ops"] += 2 * macs / FP32_TFLOPS * 1e3
            rec["t_mem"] += nbytes / HBM_BYTES_PER_S * 1e3
            print(f"time {STAP_PATH} span ({a}, {b}) over {len(cut)} "
                  f"microbatches of {STAP_MICROBATCH} ({smi}): kernel "
                  f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, cuDNN oracle "
                  f"{o_ms:.3f} ms (CUDA events, median of 5); bound "
                  f"{bound:.4f} ms ({bound_by})")
        out, sp = oracle.run(res_params, resnet, a, b, stored, spill)
        stored[b] = out
        stored.update(sp)
    print(f"{STAP_PATH} spans over the run's {n_mb} microbatches: kernel "
          f"sum {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f}, cuDNN "
          f"oracle {rec['library_ms']:.3f}, bound {rec['bound_ms']:.4f}; "
          f"max|kernel-plain| {rec['max_abs_err']:.3e}; the pipeline run "
          f"took {run_ms:.3f} ms")
    return sdep


def async_phase(torch, occam, kernel, span_plain_call, compare, time_span,
                paths, resnet, res_params, rng, smi, frontier, stap_dep):
    """Phase 4f: the async serving engine on the card. Path
    ``resnet18-async``: ``frontier.serve`` (phase 4d's frontier) takes 64
    images as 13 requests from three tenants; path
    ``resnet18-stap-async``: ``AsyncEngine`` over phase 4e's sum-packed
    ring deployment takes the same mix. Each ticket is held bit for bit
    (against ``Deployment.run``, or the single-device run for the ring),
    ``compile_count`` against a bare session's on the same mix, the
    launches against spans x rounds (or stages x live slots); then one
    damped autoscale switch with a ticket in flight and the DP disabled,
    the audit and the serve lint, and the engines' images/s against the
    bare sessions' (host clock, synchronized before it is read)."""
    import asyncio

    import numpy as np

    import repro_torch.core.partition as partition_mod

    dev = torch.device("cuda", 0)
    n_img = sum(ASYNC_SUBMITS)
    xs = rng.standard_normal((n_img, 224, 224, 3), np.float32)
    offs = np.cumsum((0,) + ASYNC_SUBMITS)
    # numpy on the host, as a client sends them: the engine packs rounds
    # into pinned memory and copies each to the card
    reqs = [xs[a:b] for a, b in zip(offs[:-1], offs[1:])]
    serve_kw = dict(round_batch=8, max_wait_ms=2.0, max_pending=64,
                    metrics_window_ms=600_000.0)

    async def drive(eng):
        async with eng:
            t0 = time.perf_counter()
            tickets = [await eng.submit(x, tenant=f"tenant{i % ASYNC_TENANTS}")
                       for i, x in enumerate(reqs)]
            # the burst's admission, before the loop packs a round
            front_door.append(time.perf_counter() - t0)
            outs = await asyncio.gather(*tickets)
            # tickets resolve on host delivery, before the device is done
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            return outs, secs, eng.describe(), eng.session.report()

    front_door = []

    def run_engine(eng):
        """The mix through ``eng`` under one event loop: outputs, host
        seconds from the first submit to the device's last round, the
        engine's description and its session's report."""
        return asyncio.run(asyncio.wait_for(drive(eng), 600))

    def bare(dep):
        """The same mix through a bare session at round_batch 8."""
        sess = dep.serve(res_params, round_batch=8)
        t0 = time.perf_counter()
        for x in reqs:
            sess.submit(x)
        res = sess.results()
        sess.sync()
        secs = time.perf_counter() - t0
        return [y for _t, y in res], secs, sess

    def times(name, make_engine, dep, first):
        """Host seconds of the mix: five engine runs and five bare
        sessions, alternating, after the counted run (the first in the
        process, printed apart: it allocates the pinned buffers); each
        run's p50/p99 host-delivery latency; then one more of each under
        the profiler."""
        eng_runs, bare_s = [], []
        for _ in range(5):
            bare_s.append(bare(dep)[1])
            _o, secs, desc, _r = run_engine(make_engine())
            eng_runs.append((secs, desc))

        def lat(d):
            return (d["metrics"]["latency_p50_s"] * 1e3,
                    d["metrics"]["latency_p99_s"] * 1e3)

        print(f"{name} runs (host clock, ms): the counted engine run "
              f"{first[0] * 1e3:.3f} (p50/p99 %.3f/%.3f); engine "
              % lat(first[1])
              + ", ".join(f"{s * 1e3:.3f}" for s, _d in eng_runs)
              + "; bare " + ", ".join(f"{s * 1e3:.3f}" for s in bare_s)
              + "; the engine runs' 13 submits (admission, before the "
              f"first round), counted run first: "
              + ", ".join(f"{s * 1e3:.3f}" for s in front_door[-6:]))
        host_trace(torch, f"{name} engine", lambda: run_engine(
            make_engine()))
        host_trace(torch, f"{name} bare session", lambda: bare(dep))
        return (statistics.median(s for s, _d in eng_runs),
                statistics.median(bare_s), [lat(d) for _s, d in eng_runs])

    # -- path resnet18-async: Frontier.serve on the card --------------------
    fast = frontier.best("throughput")
    dep = fast.deploy(device="cuda")
    spans = sum(r.route == "pallas" for r in dep.routes)
    step = dep._steps.get(8)
    builds0 = step.builds if step is not None else 0
    rec = paths[ASYNC_PATH] = new_record()
    kernel.launches = 0
    eng = frontier.serve(res_params, objective="throughput", device="cuda",
                         audit="error", **serve_kw)
    outs, secs, desc, rep = run_engine(eng)
    rec["launches"] = kernel.launches
    # checks after the count is read: runs made to compare do not count
    rounds = desc["metrics"]["total_rounds"]
    captures = dep._steps[8].builds - builds0
    if eng.deployment is not dep or rounds != desc["session"][
            "rounds_served"] or rec["launches"] != spans * (captures + rounds):
        raise AssertionError(f"{ASYNC_PATH}: {rec['launches']} launches, "
                             f"{spans} spans, {captures} captures, {rounds} "
                             f"rounds")
    if desc["packs_overlapped"] < 1 or not rep.matches_prediction or \
            rep.images != n_img or not desc["autoscale_armed"]:
        raise AssertionError(f"{ASYNC_PATH}: {desc} {rep}")
    for i, (y, x) in enumerate(zip(outs, reqs)):
        if y.device != dev or not torch.equal(y, dep.run(res_params, x)):
            raise AssertionError(f"{ASYNC_PATH}: ticket {i} differs from "
                                 f"Deployment.run")
    bare_y, _s, bsess = bare(dep)
    if not desc["compile_count"] == bsess.compile_count == 1 or \
            not torch.equal(torch.cat(outs), torch.cat(bare_y)):
        raise AssertionError(f"{ASYNC_PATH}: compile_count "
                             f"{desc['compile_count']} against the bare "
                             f"session's {bsess.compile_count}")
    print(f"{ASYNC_PATH}: frontier.serve -> {fast.plan.quant.boundary} "
          f"{fast.plan.boundaries} on cuda:0, {n_img} images as "
          f"{len(reqs)} requests {ASYNC_SUBMITS} from {ASYNC_TENANTS} "
          f"tenants: {rounds} rounds of 8, packs_overlapped "
          f"{desc['packs_overlapped']}, {rec['launches']} launches = {spans} "
          f"spans x ({captures} captures + {rounds} rounds); every ticket "
          f"equal bit for bit to Deployment.run; compile_count "
          f"{desc['compile_count']} == the bare session's "
          f"{bsess.compile_count}; matches_prediction True over "
          f"{rep.images} images")
    x8 = torch.from_numpy(xs[:8]).to(dev)
    hold_spans(torch, kernel, span_plain_call, compare, ASYNC_PATH, resnet,
               fast.plan, res_params, x8, rec,
               time_it=lambda a, b, qp, x, kw: time_span(
                   ASYNC_PATH, resnet, qp, x, a, b, kw, rec))
    eng_s, bare_s, lat = times(
        ASYNC_PATH,
        lambda: frontier.serve(res_params, objective="throughput",
                               device="cuda", audit="off", **serve_kw),
        dep, (secs, desc))
    print(f"time {ASYNC_PATH} ({smi}): the {n_img}-image mix, first submit "
          f"to the device's last round (host clock, synchronized, median "
          f"of 5): engine {eng_s * 1e3:.3f} ms, {n_img / eng_s:.2f} "
          f"images/s, {eng_s * 1e3 / rounds:.3f} ms a round; bare session "
          f"{bare_s * 1e3:.3f} ms, {n_img / bare_s:.2f} images/s, "
          f"{bare_s * 1e3 / rounds:.3f} ms a round; engine/bare "
          f"{eng_s / bare_s:.4f}; host-delivery latency p50/p99 per run "
          + ", ".join(f"{p50:.3f}/{p99:.3f} ms" for p50, p99 in lat)
          + f"; one round's spans (CUDA events, one call each): kernel "
          f"{rec['ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms")

    # -- path resnet18-stap-async: the engine over a ring session ------------
    sdep = stap_dep
    plan = sdep.plan
    ring = sdep.ring(STAP_MICROBATCH)
    trace0 = ring.trace_count
    srec = paths[STAP_ASYNC_PATH] = new_record()
    kernel.launches = 0
    seng = occam.AsyncEngine(sdep, res_params, **serve_kw)
    s_outs, s_secs, s_desc, s_rep = run_engine(seng)
    srec["launches"] = kernel.launches
    s_rounds = s_desc["session"]["rounds_served"]
    stages = sum(r.route == "pallas" for r in sdep.routes)
    # every round full (64 = 8 x 8): round_batch / microbatch live slots
    # a round, each through every stage
    live = n_img // s_desc["session"]["microbatch"]
    if s_rounds != n_img // 8 or srec["launches"] != stages * live \
            or not s_rep.matches_prediction or s_rep.images != n_img:
        raise AssertionError(f"{STAP_ASYNC_PATH}: {s_rounds} rounds, "
                             f"{srec['launches']} launches, {s_rep}")
    single = plan.place().compile(device=dev)
    vs_single = max(float((y - single.run(res_params, x)).abs().max())
                    for y, x in zip(s_outs, reqs))
    b_y, _s, sbsess = bare(sdep)
    if vs_single != 0.0 or not torch.equal(torch.cat(s_outs),
                                           torch.cat(b_y)):
        raise AssertionError(f"{STAP_ASYNC_PATH}: max|engine - single| "
                             f"{vs_single!r}")
    if not s_desc["compile_count"] == sbsess.compile_count == 1 or \
            ring.trace_count != trace0:
        raise AssertionError(f"{STAP_ASYNC_PATH}: compile_count "
                             f"{s_desc['compile_count']} against "
                             f"{sbsess.compile_count}")
    print(f"{STAP_ASYNC_PATH}: AsyncEngine over the sum-packed ring "
          f"(replicas {STAP_REPLICAS}, microbatch {STAP_MICROBATCH}, "
          f"{sdep.mesh.shape['chip']} positions on cuda:0), the same mix: "
          f"{s_rounds} rounds, packs_overlapped "
          f"{s_desc['packs_overlapped']}, {srec['launches']} launches = "
          f"{stages} stages x {live} live slots; max|engine - "
          f"single-device run| {vs_single!r}; equal bit for bit to a bare "
          f"ring session; compile_count {s_desc['compile_count']} == the "
          f"bare session's {sbsess.compile_count}; matches_prediction True")
    hold_spans(torch, kernel, span_plain_call, compare, STAP_ASYNC_PATH,
               resnet, plan, res_params, x8[:STAP_MICROBATCH], srec,
               time_it=lambda a, b, qp, x, kw: time_span(
                   STAP_ASYNC_PATH, resnet, qp, x, a, b, kw, srec))
    s_eng_s, s_bare_s, s_lat = times(
        STAP_ASYNC_PATH,
        lambda: occam.AsyncEngine(sdep, res_params, **serve_kw), sdep,
        (s_secs, s_desc))
    print(f"time {STAP_ASYNC_PATH} ({smi}): the {n_img}-image mix (host "
          f"clock, synchronized, median of 5): engine {s_eng_s * 1e3:.3f} "
          f"ms, {n_img / s_eng_s:.2f} images/s; bare ring session "
          f"{s_bare_s * 1e3:.3f} ms, {n_img / s_bare_s:.2f} images/s; "
          f"engine/bare {s_eng_s / s_bare_s:.4f}; host-delivery latency "
          f"p50/p99 per run "
          + ", ".join(f"{p50:.3f}/{p99:.3f} ms" for p50, p99 in s_lat)
          + f"; one slot of {STAP_MICROBATCH} through the stages (CUDA "
          f"events, one call each): kernel {srec['ms']:.3f} ms, bound "
          f"{srec['bound_ms']:.4f} ms")

    # -- one damped autoscale switch, with a ticket in flight ----------------
    rate = 0.7 * fast.throughput
    target = frontier.for_rate(rate)
    if target is fast:
        raise AssertionError("no candidate below the band to switch to")
    # rounds of 4, a size no earlier phase captured: the engine captures
    # one graph as it opens and the switch another, mid-serving
    cached = target._deployments.get(("auto", torch.device("cuda")))
    had_step = cached is not None and 4 in cached._steps

    def no_dp(*_a, **_k):
        raise AssertionError("the DP ran during an autoscale switch")

    async def switch(aeng):
        async with aeng:
            t1 = await aeng.submit(xs[:11], tenant="tenant0")
            for _ in range(10_000):
                await asyncio.sleep(0)
                if aeng.queue.depth == 3:
                    break
            else:
                raise AssertionError("the first round never dispatched")
            hits = [aeng.autoscale_step(rate=rate) for _ in range(3)]
            more = [aeng.autoscale_step(rate=rate) for _ in range(3)]
            t2 = await aeng.submit(xs[11:16], tenant="tenant1")
            await aeng.drain()
            y1, y2 = await t1, await t2
            torch.cuda.synchronize()
            return hits, more, y1, y2, aeng.describe()

    saved = partition_mod.optimal_partition
    partition_mod.optimal_partition = no_dp
    try:
        # partials wait for drain here (no SLO), so the split is certain:
        # 8 lanes of the first ticket on the old deployment (two rounds of
        # 4), 3 on the new
        aeng = frontier.serve(res_params, objective="throughput",
                              device="cuda", audit="error", round_batch=4,
                              max_pending=64, metrics_window_ms=600_000.0)
        aeng.autoscale(frontier, windows=3)
        hits, more, y1, y2, adesc = asyncio.run(asyncio.wait_for(
            switch(aeng), 600))
    finally:
        partition_mod.optimal_partition = saved
    tdep = target.deploy(device="cuda")
    if hits != [False, False, True] or any(more) or adesc["switches"] != 1 \
            or adesc["reconcile_calls"] != 1 or aeng.deployment is not tdep \
            or adesc["compile_count"] != 1:
        raise AssertionError(f"autoscale: hits {hits}, then {more}, {adesc}")
    x11 = torch.from_numpy(xs[:16]).to(dev)
    if not (torch.equal(y1[:8], dep.run(res_params, x11[:8]))
            and torch.equal(y1[8:], tdep.run(res_params, x11[8:11]))
            and torch.equal(y2, tdep.run(res_params, x11[11:16]))):
        raise AssertionError("autoscale: a ticket differs from the runs of "
                             "the deployments its rounds went to")
    print(f"autoscale on the card: windows=3, autoscale_step(rate="
          f"{rate!r}) x 6 -> {hits + more} (one switch, one reconcile), "
          f"{fast.plan.quant.boundary} {fast.plan.boundaries} -> "
          f"{target.plan.quant.boundary} {target.plan.boundaries} "
          f"(for_rate's pick, the candidate's cached deployment, "
          f"its graph at round_batch 4 captured "
          f"{'before' if had_step else 'at the switch'}; "
          f"the DP disabled throughout); the in-flight ticket of 11 "
          f"resolved across the switch (8 lanes from the old deployment in "
          f"two rounds of 4, 3 from the new, each equal bit for bit to that "
          f"deployment's "
          f"run), compile_count {adesc['compile_count']}")

    # -- the static audit and the serve lint ---------------------------------
    reports = [occam.audit(frontier)]
    reports += [occam.audit(c.placement()) for c in frontier]
    reports += [occam.audit(dep), occam.audit(sdep), occam.lint_serve()]
    bad = [r.summary() for r in reports if r.findings]
    if bad:
        raise AssertionError(f"audit findings: {bad}")
    print(f"audit: the frontier ({len(frontier)} candidates), each "
          f"candidate's placement, the two deployments and the serve lint "
          f"({reports[-1].subject}): {len(reports)} reports, 0 findings")


def lm_serving(torch, seed, compare, flash_log) -> dict:
    """Phases 5-7: the flash kernel against its plain version, Llama-3.2-1B
    served at full width through ``generate``, and times. ``flash_log`` is
    the kernel's nvcc log. Returns the kernel's record for the ``kernels``
    line."""
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

    def flash():
        return fkernel.flash_attention_cuda_call(q, k, v, causal=True)

    k_ms = time_ms(torch, flash)
    k16_ms = time_ms(torch, flash, calls=16)
    shape_k = dict(fkernel.last_launch)
    p_ms = time_ms(torch, lambda: flash_attention_plain_call(
        q, k, v, causal=True))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)

    compare("scaled_dot_product_attention vs plain", sdpa(),
            flash_attention_plain_call(q, k, v, causal=True), rel=1e-3)
    l_ms = time_ms(torch, sdpa)
    flop, nbytes, bound, bound_by, fp32_bound = flash_cost(*case)
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = time_ms(torch, lambda: api.prefill(params, prompt, s + g))
    _, caches = api.prefill(params, prompt, s + g)
    tok = logits[:, -1].argmax(-1)[:, None]
    decode_ms = time_ms(torch, lambda: api.decode_step(params, tok, caches,
                                                       s))
    n = cfg.n_layers
    print(f"time flash attention {case[:-1]} causal fp32: kernel "
          f"{k_ms:.4f} ms (one call; mean of 16 calls back to back, as in "
          f"a prefill: {k16_ms:.4f} ms), plain {p_ms:.4f} ms, "
          f"scaled_dot_product_attention {l_ms:.4f} ms; "
          f"{flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB, bound "
          f"{bound:.4f} ms ({bound_by}, 3xTF32 at 495 TFLOP/s), kernel at "
          f"{bound / k_ms * 100:.2f}% of bound; fp32 CUDA-core bound "
          f"{fp32_bound:.4f} ms, kernel at {fp32_bound / k_ms * 100:.2f}%")
    if shape_k["ctas_per_sm"] < 2:
        raise AssertionError(f"flash kernel holds {shape_k['ctas_per_sm']} "
                             f"CTA per SM at d = {cfg.d_head} fp32")
    print(f"  launch flash attention: {shape_k['ctas']} CTAs x "
          f"{shape_k['threads']} threads, {shape_k['smem']} bytes of dynamic "
          f"shared memory, {shape_k['ctas_per_sm']} CTAs resident per SM, "
          f"K/V by {16 if shape_k['copies16'] else 4}-byte cp.async; ptxas "
          f"fp32 at d = 64: {fp32_ptxas(flash_log, 'flash_kernelIfLi64E')}")
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


def mamba_serving(torch, seed, compare, ssd_log) -> dict:
    """Phases 8-10: the SSD-scan kernels against their plain versions,
    Mamba2-1.3B served at full width through ``generate``, and times.
    ``ssd_log`` is the kernels' nvcc log. Returns the scan's record for
    the ``kernels`` line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_cb_plain,
                                                  ssd_ref,
                                                  ssd_scan_plain_call)
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

    def oracle(x, a, b, c):
        """ssd_ref, the sequential recurrence, with B and C gathered to
        the heads: it shares no C B^T grouping with the kernels."""
        bsz, t, h, p = x.shape
        rep = h // b.shape[2]
        heads = [v.repeat_interleave(rep, dim=2) for v in (b, c)]
        flat = [v.transpose(1, 2).reshape(bsz * h, t, -1)
                for v in [x] + heads]
        af = a.transpose(1, 2).reshape(bsz * h, t)
        y = ssd_ref(flat[0], af, flat[1], flat[2])
        return y.reshape(bsz, h, t, p).transpose(1, 2)

    def check_cb(name, b, c, atol):
        """The C B^T pre-pass against its plain version at its chunk."""
        got = skernel.ssd_chunk_cb_cuda_call(b, c)
        want = ssd_chunk_cb_plain(b, c, chunk=skernel.CHUNK)
        if got.shape != want.shape:
            raise AssertionError(f"{name}: C B^T {tuple(got.shape)}")
        return close_scaled(f"{name} C B^T", got, want, atol)

    # ---- 8. SSD-scan kernel vs plain, on the card -------------------------
    worst = cb_worst = ref_worst = 0.0
    for case in SSD_CASES:
        x, a, b, c = scan_inputs(*case[:-1])
        got, _ = skernel.ssd_scan_cuda_call(x, a, b, c)
        want, _ = ssd_scan_plain_call(x, a, b, c, chunk=case[-1])
        worst = max(worst, close_scaled(f"ssd {case}", got, want, 2e-5))
        ref_worst = max(ref_worst, close_scaled(
            f"ssd {case} vs ssd_ref", got, oracle(x, a, b, c), 2e-5))
        cb_worst = max(cb_worst, check_cb(f"ssd {case}", b, c, 2e-5))
    x, a, b, c = scan_inputs(*SSD_BF16_CASE[:-1], dtype=torch.bfloat16)
    got, _ = skernel.ssd_scan_cuda_call(x, a, b, c)
    want, _ = ssd_scan_plain_call(x, a, b, c, chunk=SSD_BF16_CASE[-1])
    close_scaled(f"ssd bf16 {SSD_BF16_CASE}", got, want, 5e-2)
    check_cb(f"ssd bf16 {SSD_BF16_CASE}", b, c, 5e-2)
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
          f"max|kernel-plain| {worst:.3e}), 1 bf16 case within 5e-2; C B^T "
          f"pre-pass on the same {len(SSD_CASES)} fp32 cases within 2e-5 x "
          f"max(|plain|, 1) (worst {cb_worst:.3e}) and the bf16 case; "
          f"kernel y vs ssd_ref on the {len(SSD_CASES)} fp32 cases within "
          f"2e-5 x max(|ref|, 1) (worst {ref_worst:.3e})")
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
        cb_err, _ = compare(f"ssd full width {shape} C B^T",
                            skernel.ssd_chunk_cb_cuda_call(b, c),
                            ssd_chunk_cb_plain(b, c, chunk=skernel.CHUNK),
                            rel=1e-3)
        err, scale = compare(f"ssd full width {shape} y", got, want,
                             rel=1e-3)
        s_err, s_scale = compare(f"ssd full width {shape} state", got_s,
                                 want_s, rel=1e-3)
        r_err, r_scale = compare(f"ssd full width {shape} y vs ssd_ref",
                                 got, oracle(x, a, b, c), rel=1e-3)
        full_err = max(full_err, err, s_err)
        print(f"ssd full width x {(bsz, t, h, p)} b/c {(bsz, t, g, n)}: "
              f"max|kernel-plain| y {err:.3e} (max|plain| {scale:.3e}), "
              f"state {s_err:.3e} (max|plain| {s_scale:.3e}), C B^T "
              f"{cb_err:.3e}; max|kernel-ssd_ref| y {r_err:.3e} (max|ref| "
              f"{r_scale:.3e}); band 1e-3 x max|plain| and max|ref|")
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
    def scan():
        return skernel.ssd_scan_cuda_call(x, a, bb, cc, state0=s0,
                                          return_state=True)

    k_ms = time_ms(torch, scan)
    k20_ms = time_ms(torch, scan, calls=20)
    shape_k = dict(skernel.last_launch)
    cb_ms = time_ms(torch, lambda: skernel.ssd_chunk_cb_cuda_call(bb, cc))
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
          f"{k_ms:.4f} ms (one call; mean of 20 calls back to back, as on "
          f"the model's path: {k20_ms:.4f} ms), "
          f"plain (chunk {ssm.chunk}) {p_ms:.4f} ms, chunked "
          f"twin (chunk {ssm.chunk}) {c_ms:.4f} ms; {flop / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.3f} MB, bound {bound:.4f} ms ({bound_by}), "
          f"kernel at {bound / k_ms * 100:.2f}% of bound")
    if shape_k["ctas_per_sm"] < 2:
        raise AssertionError(f"SSD scan holds {shape_k['ctas_per_sm']} CTA "
                             f"per SM at N = {ssm.d_state}")
    print(f"  launch ssd scan: C B^T pre-pass {shape_k['cb_ctas']} CTAs x "
          f"{shape_k['threads']} threads, {cb_ms:.4f} ms alone; scan "
          f"{shape_k['ctas']} CTAs x {shape_k['threads']} threads, "
          f"{shape_k['smem']} bytes of dynamic shared memory, "
          f"{shape_k['ctas_per_sm']} CTAs resident per SM, rows staged by "
          f"{'cp.async' if shape_k['async_copies'] else 'registers'}; "
          f"ptxas fp32 scan "
          f"at N = 128: {fp32_ptxas(ssd_log, 'ssd_kernelIfLi128E')}; "
          f"pre-pass: {fp32_ptxas(ssd_log, 'ssd_chunk_cbIfE')}")
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
    specs, hw, ch, edges, opt_spans = OPT_A
    opt_net = chain("opt-a", specs, in_h=hw, in_w=hw, in_ch=ch,
                    residual_edges=edges)
    small += [(name, opt_net, a, b) for name, a, b in opt_spans]
    n_small, small_err = 0, 0.0
    fp32_cases = []
    for name, net, a, b in small:
        b = net.n_layers if b is None else b
        params = convert.params_from_numpy(he_params(net, rng), dev)
        xs0 = torch.from_numpy(rng.standard_normal(
            (2,) + net.map_shape(0), np.float32)).to(dev)
        maps = cnn.reference_forward(params, xs0, net, collect=True)
        spill = span_engine.span_spills(
            net, [c for c in (a, b) if 0 < c < net.n_layers], a, b)
        srcs = {s: maps[s] for s in crossing_source_keys(net, a, b)}
        fp32_cases.append((name, net, a, b, params, maps, spill, srcs))
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
    # the fp32 cases once more with the cluster pinned to 8 CTAs, the
    # geometry the H100 otherwise never takes (it places 16)
    kernel.CLUSTER_SIZES = (8,)
    n8, err8 = 0, 0.0
    for name, net, a, b, params, maps, spill, srcs in fp32_cases:
        for out_rows in (1, 2):
            got, got_sp = kernel.span_cuda_call(
                maps[a], params[a:b], net, a, b, out_rows=out_rows,
                srcs=srcs, spill=spill)
            if kernel.last_launch["cluster"] != 8:
                raise AssertionError(f"{name}: a cluster of "
                                     f"{kernel.last_launch['cluster']}")
            want, want_sp = span_plain_call(
                maps[a], params[a:b], net, a, b, out_rows=out_rows,
                srcs=srcs, spill=spill)
            err, _ = compare(f"{name} t={out_rows} cluster 8", got, want,
                             1e-4, 1e-4)
            err8 = max(err8, err)
            for m in spill:
                err, _ = compare(f"{name} spill {m} cluster 8", got_sp[m],
                                 want_sp[m], 1e-4, 1e-4)
                err8 = max(err8, err)
            n8 += 1
    kernel.CLUSTER_SIZES = (16, 8)
    torch.cuda.synchronize()
    print(f"kernel vs plain at a pinned cluster of 8 CTAs: {n8} small fp32 "
          f"cases within 1e-4; worst max|kernel-plain| {err8:.3e}")

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
    res_plan = occam.plan(resnet, RES_CAPACITY)
    if res_plan.boundaries != [12, 15, 16, 17]:
        raise AssertionError(f"resnet18 cuts {res_plan.boundaries}")
    spans = [("resnet18", resnet, res_params, res_maps, r.start, r.end,
              res_plan.boundaries) for r in res_plan.routes]
    spans.append(("alexnet", alexnet, alex_params, alex_maps, 0, 8, []))
    # one record per main path: its own launches, errors and times
    paths = {name: new_record() for name in ("resnet18", "alexnet")}
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
    span_ptxas = fp32_ptxas(libs["fused_span"].with_suffix(".log"),
                            "fused_span_kernelIfE")

    def time_span(net_name, net, params, xs, a, b, kw, rec):
        """Phase 4's times of one span launch, its plain version and the
        cuDNN oracle (CUDA events, median of 5), its bound and launch
        shape, added into the path's record ``rec``."""
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
        shape = kernel.last_launch
        if net.name == "resnet18" and batch == 8 and shape["ctas"] < 128:
            raise AssertionError(f"resnet18 span ({a}, {b}) at batch 8 "
                                 f"launched {shape['ctas']} CTAs")
        print(f"time {net_name} span ({a}, {b}) batch {batch}: kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, cuDNN oracle "
              f"{o_ms:.3f} ms; {macs / 1e9:.3f} GMAC in range, "
              f"{nbytes / 1e6:.3f} MB, bound {bound:.4f} ms ({bound_by}), "
              f"kernel at {bound / k_ms * 100:.2f}% of bound")
        print(f"  launch {net_name} span ({a}, {b}): {shape['clusters']} "
              f"clusters x {shape['cluster']} CTAs = {shape['ctas']} CTAs, "
              f"{shape['threads']} threads per CTA, {shape['smem']} bytes of "
              f"dynamic shared memory, {shape['resident_clusters']} "
              f"clusters resident at once; ptxas fp32: {span_ptxas}")
        rec["ms"] += k_ms
        rec["plain_ms"] += p_ms
        rec["library_ms"] += o_ms
        rec["bound_ms"] += bound
        rec["t_ops"] += 2 * macs / FP32_TFLOPS * 1e3
        rec["t_mem"] += nbytes / HBM_BYTES_PER_S * 1e3

    for net_name, net, params, maps, a, b, kw in span_args:
        time_span(net_name, net, params, maps[a], a, b, kw, paths[net_name])
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

    pol_deps = policy_paths(torch, occam, kernel, span_plain_call, compare,
                            time_span, paths, resnet, res_params, xs8)
    sessions(torch, kernel, compare, paths, dep, pol_deps["int8"],
             res_params, xs8, rng, run_ms)
    frontier = frontier_phase(torch, occam, kernel, span_plain_call,
                              compare, time_span, paths, resnet, res_params,
                              xs8, res_maps)
    stap_dep = stap_phase(torch, occam, kernel, span_plain_call, compare,
                          time_span, paths, resnet, res_params, rng, smi)
    async_phase(torch, occam, kernel, span_plain_call, compare, time_span,
                paths, resnet, res_params, rng, smi, frontier, stap_dep)

    flash_rec = lm_serving(torch, args.seed, compare,
                           libs["flash_attention"].with_suffix(".log"))
    gc.collect()  # the Llama path's tensors go before Mamba's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ssd_rec = mamba_serving(torch, args.seed, compare,
                            libs["ssd_scan"].with_suffix(".log"))

    # fused-span times: one batch-8 run of ResNet-18's five spans, one
    # batch-4 run of AlexNet's span, one batch-8 run of each policy plan's
    # spans; a session's ms is one replayed round of 8 (its other times are
    # its deployment's spans'); the frontier's: its seven new spans at
    # batch 8; the calibration's: the profile's stage sum at microbatch 1
    # beside those spans' other times; the STAP pipeline's: its spans,
    # each timed over the run's 16 microbatches of 2 (its 80 launches);
    # the async engine's: one round's spans at batch 8, and the ring
    # engine's: one slot's spans at microbatch 2, each span one call;
    # launches: each path's counted run
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
