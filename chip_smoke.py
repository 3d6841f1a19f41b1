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

Then, after the Mamba path's tensors are freed and the peak-memory
counter reset, the MoE and encoder-decoder serving paths, each at its
full published width (fp32, random weights from ``--seed``):

11. Flash kernel vs plain at the new paths' prefill shapes, held to
   max|kernel - plain| <= 1e-3 * max|plain|: OLMoE's q/k/v
   (4, 16, 1024, 128) causal and a ragged (1, 16, 200, 128) prompt;
   SeamlessM4T's encoder (4, 16, 1024, 64) non-causal and its
   cross-attention, q (4, 16, 1024, 64) against the encoder's k/v
   (4, 16, 1024, 64), non-causal.
12. Path ``olmoe-1b-7b-serve``: OLMoE-1B-7B (16 layers x 2048, 16/16
   heads of 128, an MoE FFN of 64 experts top-8 of 1024 in every layer,
   vocab 50,304; the parameter count asserted) through ``build_model`` and
   ``generate``, the same three requests, exactly 16 flash launches per
   prefill (48; decode adds none); the first request's prefill logits
   against the ``attn_impl="chunked"`` prefill within 1e-3 * max|chunked|,
   with the count of (token, layer) routing decisions that differ between
   the two (``moe._route`` wrapped here); then times as in phase 7 (the
   kernel at d = 128, its plain version, ``scaled_dot_product_attention``,
   the bound, the launch shape), the prefill, a decode step, peak memory,
   and a profile of one prefill and one decode step that also sums the
   device time of the experts' dispatch operators (``index_select``,
   ``index_add_``, ``scatter_``, ...) against their batched GEMMs.
13. Path ``seamless-m4t-large-v2-serve``: the SeamlessM4T-Large v2 text
   backbone (24 encoder + 24 decoder layers x 1024, 16/16 heads of 64,
   d_ff 8192, vocab 256,206 padded to 256,208) after OLMoE's tensors are
   freed, the same requests with ``enc_embeds`` of the prompt's length:
   exactly 72 flash launches per prefill (24 non-causal encoder, 24
   causal decoder, 24 non-causal cross-attention; 216 in all); logits
   and times as in phase 12, each kind of flash call timed.

14. Train steps on the card against the CPU port: for each family's smoke
   config (llama3.2-1b, olmoe-1b-7b, mamba2-1.3b, the Jamba hybrid,
   qwen2-vl-2b with M-RoPE, the SeamlessM4T encoder-decoder), the same
   parameters and a 4 x 64 batch on both devices (fp32, TF32 off), one
   ``make_train_step`` at one and at two microbatches: loss, aux losses,
   grad_norm and each parameter's Adam moments (the step's gradients)
   within 1e-4 x max|cpu|, every updated parameter within 1e-4 x
   max|cpu| over the model, and for the MoE configs the routing
   decisions that differ counted.
15. Path ``llama3.2-1b-train``: ``train("llama3.2-1b", smoke=False,
   steps=6, batch=4, seq=1024, microbatches=2, ckpt_every=3)`` at full
   width (1,235,814,400 parameters asserted) under deterministic
   algorithms, with its async checkpoints (free disk printed first); a
   second ``train`` resumed from the step-3 checkpoint gives steps 4-6
   the same losses and the same final parameters (bit for bit, or within
   1e-5 x max naming the operation that has no deterministic CUDA path);
   every loss finite, the first within 0.5 of ln(128,256); then the
   trained parameters serve a 4 x 1024 prefill through ``generate`` on
   the flash kernel: exactly 16 launches on the path (training runs the
   chunked twin), each call held against plain on its own inputs, the
   logits within 1e-3 x max|chunked| of the chunked prefill's. Then one
   step at two microbatches against one at one from the step-6
   checkpoint (1e-4 x max), the step time (median of steps 2-6) and
   tokens/s beside the step's FLOP bound at 67 TFLOP/s, peak memory, the
   checkpoint's bytes and its copy, write and restore seconds, step time
   and peak memory with per-layer checkpointing on and off, a profile of
   one step, and the flash call's times. The script sets
   ``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts, which deterministic
   cuBLAS needs.

Execution across mesh positions, every position on the one GPU:

16. Path ``llama3.2-1b-pipeline`` (after training's tensors are freed):
   ``runtime.pipeline.plan_stages`` on Llama-3.2-1B's 16 layers (243.3 MB
   of fp32 weights each, 4.19 MB of K/V a microbatch, 2 x params x 1024
   FLOP plus the causal attention, 8.39 MB boundaries, 1.0e9 B a stage,
   67 TFLOP/s, 3 extra chips) must give stages (0,4), (4,8), (8,12),
   (12,16) and replicas (2, 2, 2, 1). Eight microbatches of 1 x 1024
   embedded tokens run through ``pipeline_forward``, each stage four
   ``DecoderLayer``s through ``_sublayer_apply`` on the flash kernel:
   without a plan on a 4-position stage mesh (11 ticks) and with the STAP
   plan on its (4, 2) mesh. Each run: exactly 128 flash launches (16
   layers x 8 microbatches), held bit for bit against ``decoder_stack``
   run microbatch by microbatch (else within 1e-5 x max, the difference
   printed), its hops counted (calls, bytes copied, bytes of zeroed
   receive buffers); the last microbatch's final-norm + tied-head logits
   against ``decoder_prefill`` of its tokens (1e-3 x max). Then one
   stage's flash call on its captured inputs against plain, timed beside
   plain, ``scaled_dot_product_attention`` and its bound; both runs'
   host-clock ms beside the 8 microbatches run one after another (six
   samples each, taken in turns), the run's FLOP bound at 67 TFLOP/s,
   one tick's hop (CUDA events), peak memory, and a profile of each of
   the three (device idle share).
17. Path ``olmoe-1b-7b-ep`` (run right after phase 12, on its model):
   request 1's prefill inside ``use_shardings(ShardCtx(mesh))``, ``mesh``
   a (1, 4) ("data", "model") ``DeviceMesh``: the MoE layers take
   ``impl="ep_shard_map"``, each model position 16 of the 64 experts as
   views of the weights (checked by storage offset), exactly 16 flash
   launches; the logits against the same prefill without a context
   (1e-3 x max|local|), the routing decisions that differ counted and
   the four positions' routings equal; the prefill's ms against
   ``"local"``'s, the partial sums' adds read from a trace of the EP
   prefill (their count and device ms), a profile; the flash call
   timed as in phase 12. Then ``optim.compression.allreduce_compressed``
   over the 4 positions of a ("data",) mesh on the GPU, on the gradients
   of the Llama smoke config's loss on four data shards of one batch:
   int8 payloads and int32 sums equal to the CPU port's, means and
   residuals within 1e-6 of the magnitudes they come from (the mean's
   max; the gradient's, since a residual x - q s cancels), the EF mean
   within its element-wise bound of the plain fp32 mean,
   sum (|q_p| |mean(s) - s_p| + s_p / 2) / n, with the tensors within one
   EF step (max|g| / 127) counted.

Dry run and the example twins (after the pipeline's tensors are freed):

18. Paths ``llama3.2-1b-dryrun-{train,prefill,decode}``: the dry run's
   cells of Llama-3.2-1B at full width in bf16 (``build_model``'s
   default) on a (1, 1) ("data", "model") ``DeviceMesh`` of the card:
   train 4 x 1024 (two microbatches), prefill 4 x 1024, decode at batch
   4 against a 2048-token cache. Each cell's ``meta`` record
   (``launch.dryrun.cell_record``), then the same cell drawn on the card
   from ``--seed`` (``launch.specs.build_cell(generator=...)``): its
   arguments' bytes (numel x element size) must equal the record's
   ``arguments_bytes``, its donated arguments' its ``alias_bytes``, and
   ``FlopCounterMode`` over one call its ``flops_global``, exactly; the
   increase of ``max_memory_allocated`` over one call printed beside the
   estimate (output + temp - alias; a miss is printed, not failed); the
   call timed (CUDA events, median of 5 after a warm-up) with its
   TFLOP/s beside the bf16 peak. The prefill once more with
   ``attn_impl="flash"``: exactly 16 flash launches, logits within
   5e-2 x max|chunked| (bf16), and one flash call on its captured q/k/v
   timed beside plain, ``scaled_dot_product_attention`` and its bound.
   Then ``run_cell`` for every applicable shape of llama3.2-1b,
   olmoe-1b-7b and mamba2-1.3b on the single-pod mesh of ``meta``
   positions: every cell must build. That sweep runs on the CPU after
   phase 19, so it overlaps no timed phase, one process a cell, all
   started together; its seconds are printed.
19. Path ``examples``: each example twin's ``main`` in-process
   (``quickstart``, ``occam_cnn_pipeline``, ``serve_pipeline``,
   ``async_serve`` with its mesh positions on ``cuda:0``,
   ``train_tiny_lm --steps 20`` with a restart from its step-10
   checkpoint), each one's own checks holding and its seconds printed,
   each kernel's launch counter read before and after: ``quickstart``
   and ``async_serve`` must launch the fused span, ``serve_pipeline``
   flash and the SSD scan. The first call of each kernel is captured,
   held against its plain version and timed as in phases 4, 7 and 10.

The benchmark twins (after phase 19, before phase 18's sweep):

20. Path ``benchmarks``: the harness ``repro_torch.benchmarks.run
   --device cuda:0`` (its ``name,us_per_call,derived`` lines printed as
   it goes) and the smoke pass, in-process, every twin at the
   reference's own configs: the paper's tables, ``vgg_mini`` at 32x32
   through the oracle, the interpreted loop, the scan engine and the
   kernel route, ``vgg_stap`` at 64x64 with 16 images through the STAP
   pipeline, its serving session and the async engine, autoplan, and
   the 16x16 quant and calibrate nets; the fused span's launches counted
   per twin. It fails on an output outside 1e-3 x max|oracle|, a
   ``matches_prediction`` (bytes too under int8) that is false, a twin
   whose spans route to the kernel and that launched it no time, a build
   count other than 1, a document that fails its schema gate, or a twin
   that raises. The speed ratios (scan and kernel over interpreted,
   measured over predicted, calibrated over measured) are printed, not
   gated. Then ``vgg_mini``'s three spans at batch 1: kernel against
   plain (1e-4), timed as in phase 4. After the sweep (which writes its
   records to ``results/torch_dryrun``), the roofline twin reads them:
   every cell's compute term and model FLOPs, its memory and collective
   terms ``None`` with the records' reasons.

The line before the last is the kernels' JSON summary, one record per
path with that path's launches, errors and times; the last line is
``{"ok": true, "device": {...}}``. Without a visible GPU, or outside a
checkout of the repository, the script fails before printing a result.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FP32_TFLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
TF32_TFLOPS = 495e12    # H100 SXM TF32 on the tensor cores, dense
BF16_TFLOPS = 989e12    # H100 SXM bf16 and fp16 on the tensor cores, dense
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
# phases 11-13: OLMoE-1B-7B and the SeamlessM4T-Large v2 text backbone,
# each path's flash-attention calls at its prefill shapes,
# (B, Hq, Hkv, Sq, Skv, D, causal)
OLMOE_PATH = "olmoe-1b-7b-serve"
SEAMLESS_PATH = "seamless-m4t-large-v2-serve"
# every shape the three ``LM_REQUESTS``' prefills give the kernel; a path's
# counted run fails if it makes a call at a shape not listed here
FLASH_NEW_SHAPES = {
    OLMOE_PATH: [(b, 16, 16, s, s, 128, True) for b, s, _ in LM_REQUESTS],
    # non-causal: the encoder's self-attention and the cross-attention (q
    # from the decoder's s tokens, k/v from the encoder's s frames, the
    # same shape); causal: the decoder's self-attention
    SEAMLESS_PATH: [(b, 16, 16, s, s, 64, causal)
                    for b, s, _ in LM_REQUESTS for causal in (False, True)],
}
# each path's flash calls in one prefill of the first request, by kind:
# (kind, shape, calls)
OLMOE_CALLS = [("causal", (4, 16, 16, 1024, 1024, 128, True), 16)]
SEAMLESS_CALLS = [("encoder", (4, 16, 16, 1024, 1024, 64, False), 24),
                  ("decoder", (4, 16, 16, 1024, 1024, 64, True), 24),
                  ("cross", (4, 16, 16, 1024, 1024, 64, False), 24)]
# the modules' parameter counts: the config's count (which leaves out the
# RMSNorm vectors) plus the norms
OLMOE_PARAMS = 6_919_028_736 + 16 * 2 * 2048 + 2048
SEAMLESS_PARAMS = 2_034_663_424 + 24 * 2 * 1024 + 24 * 3 * 1024 + 2 * 1024
# profiler operators that move tokens to and from the experts' slots
DISPATCH_OPS = ("aten::index_select", "aten::index_add_", "aten::scatter_",
                "aten::gather", "aten::topk", "aten::cumsum")
# phase 14: one train step of each family's smoke config on the card
# against the CPU port, at one and two microbatches
TRAIN_SMOKE_ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "mamba2-1.3b",
                     "jamba-1.5-large-398b", "qwen2-vl-2b",
                     "seamless-m4t-large-v2")
# phase 15: Llama-3.2-1B trained at full width through ``train``; its
# module's parameter count (the config's, which leaves out the RMSNorm
# vectors, plus the norms: 16 layers x 2 + the final one, of 2048)
TRAIN_PATH = "llama3.2-1b-train"
TRAIN_PARAMS = 1_235_814_400
TRAIN_KW = dict(smoke=False, steps=6, batch=4, seq=1024, microbatches=2,
                ckpt_every=3)
# phase 16: Llama-3.2-1B pipelined over 4 stages of 4 layers; a layer's
# parameters (attention 4 x 2048 x 2048 less the GQA K/V's 3/4, FFN
# 3 x 2048 x 8192, two norms), one microbatch's K and V (1 x 1024, 8 KV
# heads of 64, fp32) and the boundary map (1 x 1024 x 2048, fp32)
PIPE_PATH = "llama3.2-1b-pipeline"
PIPE_WIDTH = (16, 2048, 32, 8, 64, 8192, 128256)
PIPE_LAYER_PARAMS = 60_821_504
PIPE_LAYER_ACT = 4_194_304
PIPE_BOUNDARY = 8_388_608
PIPE_CAPACITY = 1.0e9
PIPE_EXTRA_CHIPS = 3
PIPE_MICROBATCHES = 8
PIPE_SEQ = 1024
PIPE_SPANS = ((0, 4), (4, 8), (8, 12), (12, 16))
PIPE_REPLICAS = (2, 2, 2, 1)
# phase 17: OLMoE-1B-7B's request 1 with its experts over 4 model
# positions, and the compressed all-reduce over 4 data positions
EP_PATH = "olmoe-1b-7b-ep"
EP_MESH = (1, 4)
# phase 18: Llama-3.2-1B's dry-run cells, (kind, seq, batch); the sweep's
# architectures
DRYRUN_PATH = "llama3.2-1b-dryrun"
DRYRUN_CELLS = (("train", 1024, 4), ("prefill", 1024, 4),
                ("decode", 2048, 4))
DRYRUN_SWEEP_ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "mamba2-1.3b")
SWEEP_CODE = """\
import sys, time
from repro_torch.launch import dryrun
t0 = time.perf_counter()
rec = dryrun.run_cell(sys.argv[1], sys.argv[2], False, sys.argv[3])
print(dryrun.fmt(rec), f"[{time.perf_counter() - t0:.1f} s]", flush=True)
"""
EXAMPLES_PATH = "examples"
# phase 20: the benchmark twins; the twins whose spans run on the kernel
BENCH_PATH = "benchmarks"
BENCH_ON_KERNEL = ("occam_span_engine", "occam_stap", "occam_serve",
                   "occam_async", "occam_calibrate", "occam_quant", "smoke")


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
    once and k and v once per kv head. In fp32 the bound is at the TF32
    tensor cores' rate with three products per multiply-add (3xTF32: big
    x big, big x small, small x big); in bf16 or fp16 it is at the card's
    peak for the type, the bf16/fp16 tensor rate, whatever units the
    kernel runs its products on. The last value is the same FLOP on the
    fp32 CUDA cores (67 TFLOP/s, the bound of the kernel before it used
    the tensor cores), for comparison."""
    offset = max(sk - sq, 0)
    pairs = (sum(min(r + offset + 1, sk) for r in range(sq)) if causal
             else sq * sk)
    flop = 4 * d * pairs * b * hq
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * itemsize
    t_ops = (3 * flop / TF32_TFLOPS if itemsize == 4
             else flop / BF16_TFLOPS) * 1e3
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


def trace_breakdown(torch, name, fn, top=8, ops=None):
    """Profile one call of ``fn`` (after a warm-up): print the host-clock
    time, the device's busy time and idle share, and the ``top`` kernels
    by device time. With ``ops`` (operator names), also the device time of
    the kernels those operators launched against ``aten::bmm``'s (the
    experts' batched GEMMs) and ``aten::mm``'s, and the ``top`` operators
    by the device time of the kernels they launched."""
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
    if ops is None:
        return
    launched = {e.key: e.self_device_time_total / 1e3
                for e in prof.key_averages()
                if not str(e.device_type).endswith("CUDA")
                and e.self_device_time_total > 0}
    groups = [("dispatch " + "/".join(o.split("::")[1] for o in ops),
               sum(launched.get(o, 0.0) for o in ops)),
              ("expert GEMMs (aten::bmm)", launched.get("aten::bmm", 0.0)),
              ("dense GEMMs (aten::mm)", launched.get("aten::mm", 0.0))]
    print("  by operator: " + "; ".join(
        f"{label} {ms:.3f} ms = {ms / busy_ms * 100:.2f}%"
        for label, ms in groups))
    for key, ms in sorted(launched.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:9.3f} ms {ms / busy_ms * 100:6.2f}% {key[:80]}")


def op_device_ms(torch, fn, op, shapes):
    """Profile one call of ``fn`` (after a warm-up), recording shapes:
    the number of calls of the operator ``op`` whose leading inputs have
    ``shapes``, and the device ms of the kernels those calls launched."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.key == op and [list(x) for x in
                                e.input_shapes[:len(shapes)]] == shapes]
    return (sum(e.count for e in hits),
            sum(e.self_device_time_total for e in hits) / 1e3)


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


def flash_new_shapes(torch, seed, compare) -> dict:
    """Phase 11: the flash kernel against its plain version at the new
    paths' full-width prefill shapes. Returns each path's worst error."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_plain_call)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 11)
    worst = {}
    for path, cases in FLASH_NEW_SHAPES.items():
        worst[path] = 0.0
        for case in cases:
            b, hq, hkv, sq, sk, d, causal = case
            q, k, v = [torch.randn(shape, generator=gen).to(dev)
                       for shape in ((b, hq, sq, d), (b, hkv, sk, d),
                                     (b, hkv, sk, d))]
            got = fkernel.flash_attention_cuda_call(q, k, v, causal=causal)
            want = flash_attention_plain_call(q, k, v, causal=causal)
            err, scale = compare(f"flash {path} {case}", got, want,
                                 rel=1e-3)
            worst[path] = max(worst[path], err)
            print(f"flash {path} q {(b, hq, sq, d)} k/v {(b, hkv, sk, d)} "
                  f"{'causal' if causal else 'non-causal'}: "
                  f"max|kernel-plain| {err:.3e} (max|plain| {scale:.3e}, "
                  f"band 1e-3 x max|plain|)")
    torch.cuda.synchronize()
    return worst


def routed_serving(torch, seed, compare, path, arch, width, n_params_want,
                   calls, flash_err) -> dict:
    """Phases 12 and 13: ``arch`` served at full width through
    ``generate`` (the three ``LM_REQUESTS``; an encoder-decoder's prompt
    holds ``enc_embeds`` of the prompt's length), the flash launches
    counted per prefill (``calls``: (kind, shape, calls) of one prefill)
    and every shape the kernel ran at found in ``FLASH_NEW_SHAPES``,
    request 1's prefill logits against the chunked prefill (with the MoE
    routing decisions of both counted), then times: each kind of flash
    call (kernel, plain, ``scaled_dot_product_attention``, bound, launch
    shape; the kernel held against plain on the timed inputs), the prefill, a decode step, peak memory and a profile of one
    prefill and one decode step. Returns the path's flash record and
    ``(api, params, prompts)`` for a later phase on the same model."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_plain_call)
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe
    from repro_torch.models.api import build_model, make_batch

    dev = torch.device("cuda")
    cfg = get_config(arch)
    got_width = (cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.n_heads,
                 cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab,
                 None if cfg.moe is None else
                 (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert))
    if got_width != width:
        raise AssertionError(f"{arch} config {got_width}")
    per_prefill = sum(n for _, _, n in calls)
    api = build_model(cfg, dtype=torch.float32)
    if api.device.type != "cuda":
        raise AssertionError(f"model on {api.device}")
    t0 = time.perf_counter()
    params = api.init(torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.parameters())
    if n_params != n_params_want:
        raise AssertionError(f"{arch}: {n_params} parameters")
    print(f"{path}: {n_params} parameters (fp32, {n_params * 4 / 1e9:.3f} "
          f"GB; the config's count without the norm vectors "
          f"{cfg.param_count()[0]}) drawn in {time.perf_counter() - t0:.2f} "
          f"s; {cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers x "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, experts {width[-1]}, vocab "
          f"{cfg.vocab} (padded {cfg.vocab_padded})")
    prompts = []
    for i, (b, s, _) in enumerate(LM_REQUESTS):
        prompt = make_batch(cfg, b, s, device=dev,
                            generator=torch.Generator().manual_seed(
                                seed + 1 + i))
        prompt.pop("labels")
        prompts.append(prompt)
    ran = set()  # (B, Hq, Hkv, Sq, Skv, D, causal) of every kernel call
    cuda_call = fops.flash_attention_cuda_call

    def recording_call(q, k, v, *, causal=True, **kw):
        ran.add((*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                 q.shape[3], causal))
        return cuda_call(q, k, v, causal=causal, **kw)

    fops.flash_attention_cuda_call = recording_call
    fkernel.launches = 0
    outs = []
    try:
        for prompt, (b, s, g) in zip(prompts, LM_REQUESTS):
            before = fkernel.launches
            out = generate(api, params, prompt, g)
            toks = out["tokens"]
            if fkernel.launches - before != per_prefill:
                raise AssertionError(f"{path} request {b} x {s}: "
                                     f"{fkernel.launches - before} launches")
            if tuple(toks.shape) != (b, g) or int(toks.min()) < 0 \
                    or int(toks.max()) >= cfg.vocab_padded:
                raise AssertionError(f"{path} request {b} x {s}: tokens "
                                     f"{tuple(toks.shape)}")
            outs.append(out)
            print(f"{path} request batch {b} prompt {s} gen {g}: "
                  f"{per_prefill} launches, tokens {tuple(toks.shape)}, "
                  f"prefill_s {out['prefill_s']:.6f}, decode_tok_per_s "
                  f"{out['decode_tok_per_s']:.3f}")
    finally:
        fops.flash_attention_cuda_call = cuda_call
    launches = fkernel.launches
    if launches != per_prefill * len(LM_REQUESTS):
        raise AssertionError(f"{path}: {launches} launches")
    unchecked = ran - set(FLASH_NEW_SHAPES[path])
    if unchecked:
        raise AssertionError(f"{path}: kernel calls at shapes phase 11 did "
                             f"not hold against plain: {sorted(unchecked)}")
    print(f"{path}: the kernel ran at {len(ran)} shapes (B, Hq, Hkv, Sq, "
          f"Skv, D, causal) {sorted(ran)}, each held against plain in "
          f"phase 11")

    (b, s, g), prompt = LM_REQUESTS[0], prompts[0]
    chunked = build_model(cfg, dtype=torch.float32, attn_impl="chunked")
    routed = []  # each MoE layer's top-k sets, flash prefill then chunked
    route = moe._route

    def recording_route(x, router, e, k):
        out = route(x, router, e, k)
        routed.append(out[1].sort(dim=-1).values)
        return out

    moe._route = recording_route
    try:
        logits, _ = api.prefill(params, prompt, s + g)
        want, _ = chunked.prefill(params, prompt, s + g)
    finally:
        moe._route = route
    if tuple(logits.shape) != (b, 1, cfg.vocab_padded):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    half = len(routed) // 2
    flips = sum(int((x != y).any(dim=-1).sum())
                for x, y in zip(routed[:half], routed[half:]))
    decisions = sum(int(x.shape[0]) for x in routed[:half])
    routing = (f"; routing decisions (token, MoE layer) that differ: "
               f"{flips} of {decisions}" if routed else "")
    err, scale = compare(f"{path} prefill logits, flash vs chunked", logits,
                         want, rel=1e-3)
    ref_toks = generate(chunked, params, prompt, g)["tokens"]
    same = (outs[0]["tokens"] == ref_toks).int().cumprod(dim=1).sum(dim=1)
    print(f"{path} request 1 prefill logits: max|flash-chunked| {err:.3e} "
          f"(max|chunked| {scale:.3e}, band 1e-3 x max|chunked|){routing}; "
          f"leading greedy tokens equal to the chunked path's, per row: "
          f"{same.tolist()} of {g}")
    del routed, chunked

    gen = torch.Generator().manual_seed(seed + 12)
    rec = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               t_ops=0.0, t_mem=0.0)
    for kind, case, n in calls:
        bq, hq, hkv, sq, sk, d, causal = case
        q, k, v = [torch.randn(shape, generator=gen).to(dev)
                   for shape in ((bq, hq, sq, d), (bq, hkv, sk, d),
                                 (bq, hkv, sk, d))]
        k_ms = time_ms(torch, lambda: fkernel.flash_attention_cuda_call(
            q, k, v, causal=causal))
        k_n_ms = time_ms(torch, lambda: fkernel.flash_attention_cuda_call(
            q, k, v, causal=causal), calls=n)
        shape_k = dict(fkernel.last_launch)
        p_ms = time_ms(torch, lambda: flash_attention_plain_call(
            q, k, v, causal=causal))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)

        plain = flash_attention_plain_call(q, k, v, causal=causal)
        k_err, _ = compare(f"{path} {kind}: kernel vs plain",
                           fkernel.flash_attention_cuda_call(
                               q, k, v, causal=causal), plain, rel=1e-3)
        flash_err = max(flash_err, k_err)
        compare(f"{path} {kind}: scaled_dot_product_attention vs plain",
                sdpa(), plain, rel=1e-3)
        del plain
        l_ms = time_ms(torch, sdpa)
        flop, nbytes, bound, bound_by, fp32_bound = flash_cost(*case)
        if shape_k["ctas_per_sm"] < 1:
            raise AssertionError(f"{path} {kind}: no CTA fits an SM")
        print(f"time {path} flash {kind} {case[:-1]} "
              f"{'causal' if causal else 'non-causal'} fp32: kernel "
              f"{k_ms:.4f} ms (one call; mean of {n} calls back to back, "
              f"as in a prefill: {k_n_ms:.4f} ms), plain {p_ms:.4f} ms, "
              f"scaled_dot_product_attention {l_ms:.4f} ms; "
              f"{flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB, bound "
              f"{bound:.4f} ms ({bound_by}, 3xTF32 at 495 TFLOP/s), kernel "
              f"at {bound / k_ms * 100:.2f}% of bound; fp32 CUDA-core bound "
              f"{fp32_bound:.4f} ms")
        print(f"  launch flash {kind}: {shape_k['ctas']} CTAs x "
              f"{shape_k['threads']} threads, {shape_k['smem']} bytes of "
              f"dynamic shared memory, {shape_k['ctas_per_sm']} CTAs "
              f"resident per SM, K/V by "
              f"{16 if shape_k['copies16'] else 4}-byte cp.async")
        rec["ms"] += n * k_ms
        rec["plain_ms"] += n * p_ms
        rec["library_ms"] += n * l_ms
        rec["bound_ms"] += n * bound
        rec["t_ops"] += n * 3 * flop / TF32_TFLOPS * 1e3
        rec["t_mem"] += n * nbytes / HBM_BYTES_PER_S * 1e3
        del q, k, v
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = time_ms(torch, lambda: api.prefill(params, prompt, s + g))
    _, caches = api.prefill(params, prompt, s + g)
    tok = logits[:, -1].argmax(-1)[:, None]
    decode_ms = time_ms(torch, lambda: api.decode_step(params, tok, caches,
                                                       s))
    print(f"time {path} request 1 (batch {b}, prompt {s}): prefill "
          f"{prefill_ms:.3f} ms (CUDA events, median of 5), of which "
          f"{per_prefill} kernel calls {rec['ms']:.3f} ms = "
          f"{rec['ms'] / prefill_ms * 100:.2f}%; decode step "
          f"{decode_ms:.3f} ms, {b / decode_ms * 1e3:.2f} tokens/s")
    print(f"peak device memory during the timed prefill and decode "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    ops = DISPATCH_OPS if cfg.moe is not None else None
    trace_breakdown(torch, f"{path} prefill",
                    lambda: api.prefill(params, prompt, s + g), ops=ops)
    trace_breakdown(torch, f"{path} decode step",
                    lambda: api.decode_step(params, tok, caches, s), ops=ops)
    # times: one prefill of the first request, all its flash calls; the
    # model and prompts go back for a later phase on the same weights
    return {"name": "flash_attention", "path": path, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:111",
            "launches": launches, "max_abs_err": flash_err,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": ("operations" if rec["t_ops"] >= rec["t_mem"]
                         else "bytes"),
            "library_ms": rec["library_ms"]}, (api, params, prompts)


def smoke_train_steps(torch, seed, compare) -> None:
    """Phase 14: for each family's smoke config, the same parameters and
    batch (4 x 64) on the card and on the CPU, fp32 with TF32 off, one
    ``make_train_step`` each at one and at two microbatches, AdamW at the
    reference's defaults: the loss, the aux losses, grad_norm and every
    parameter's Adam moments (the step's gradients) within
    1e-4 x max|cpu| each, every updated parameter within 1e-4 x max|cpu|
    over the model. For the MoE configs the (token, layer) routing
    decisions of the step's forward are counted where the two devices
    differ (``moe._route`` wrapped, as phase 12 does)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train_step import make_train_step
    from repro_torch.models import moe
    from repro_torch.models.api import build_model, make_batch
    from repro_torch.optim.adamw import AdamW

    route = moe._route
    for arch in TRAIN_SMOKE_ARCHS:
        cfg = get_smoke(arch)
        apis = {"cpu": build_model(cfg, dtype=torch.float32, device="cpu"),
                "cuda": build_model(cfg, dtype=torch.float32)}
        base = apis["cpu"].init(torch.Generator().manual_seed(seed))
        whole = make_batch(cfg, 4, 64,
                           generator=torch.Generator().manual_seed(seed + 14))
        for mb in (1, 2):
            batch = whole if mb == 1 else {
                k: v.reshape(mb, 4 // mb, *v.shape[1:])
                for k, v in whole.items()}
            micro = [batch] if mb == 1 else [{k: v[i] for k, v in
                                              batch.items()}
                                             for i in range(mb)]
            routed = {"cpu": [], "cuda": []}

            def recording_route(x, router, e, k):
                out = route(x, router, e, k)
                routed[x.device.type].append(
                    out[1].sort(dim=-1).values.cpu())
                return out

            params, states, metrics = {}, {}, {}
            for name, api in apis.items():
                p = copy.deepcopy(base).to(api.device)
                moe._route = recording_route
                try:  # the step's forward once more, to read its routing
                    with torch.no_grad():
                        for b in micro:
                            api.train_loss(p, b)
                finally:
                    moe._route = route
                opt = AdamW()  # the reference's defaults
                states[name] = opt.init(p)
                metrics[name] = make_train_step(api, opt, mb)(
                    p, states[name],
                    {k: v.to(api.device) for k, v in batch.items()})
                params[name] = p
            flips = sum(int((x != y).any(dim=-1).sum())
                        for x, y in zip(routed["cpu"], routed["cuda"]))
            decisions = sum(int(x.shape[0]) for x in routed["cpu"])
            if sorted(metrics["cuda"]) != sorted(metrics["cpu"]):
                raise AssertionError(f"{arch} M={mb}: metrics "
                                     f"{sorted(metrics['cuda'])}")
            for key, want in metrics["cpu"].items():
                compare(f"{arch} M={mb} {key}", metrics["cuda"][key],
                        want.cuda(), rel=1e-4)
            names = [n for n, _ in params["cpu"].named_parameters()]
            # the step's (clipped) gradients, through m = 0.1 g and
            # v = 0.05 g^2: each within 1e-4 x its own max|cpu|
            g_worst = 0.0
            for part in ("m", "v"):
                for name, want, got in zip(names,
                                           getattr(states["cpu"], part),
                                           getattr(states["cuda"], part)):
                    err, scale = compare(f"{arch} M={mb} {part} {name}",
                                         got, want.cuda(), rel=1e-4)
                    g_worst = max(g_worst, err / scale)
            # the updated parameters within 1e-4 x max|cpu| over the
            # model: Adam's first step moves every entry by about lr,
            # whatever its gradient, so an entry whose gradient is within
            # the devices' rounding of 0 may step differently; a band of
            # 1e-4 x its own tensor's max would demand the first step
            # agree to 1e-4 relative of lr there
            want_p = [w.detach() for w in params["cpu"].parameters()]
            scale = max(float(w.abs().max()) for w in want_p)
            p_worst, p_rel = 0.0, 0.0
            for name, want, got in zip(names, want_p,
                                       params["cuda"].parameters()):
                err = float((got.detach().cpu() - want).abs().max())
                if not bool(torch.isfinite(got).all()) \
                        or err > 1e-4 * scale:
                    raise AssertionError(f"{arch} M={mb} {name}: max|err| "
                                         f"{err:.3e} > 1e-4 x {scale:.3e}")
                p_worst = max(p_worst, err)
                p_rel = max(p_rel, err / float(want.abs().max()))
            loss = metrics["cpu"]["loss"]
            print(f"train step {arch} smoke, microbatches {mb}: loss "
                  f"{float(loss):.6f} (|card-cpu| "
                  f"{abs(float(metrics['cuda']['loss']) - float(loss)):.3e}),"
                  f" grad_norm {float(metrics['cpu']['grad_norm']):.6f}; "
                  f"{len(names)} parameters: m and v worst max|card-cpu| / "
                  f"max|cpu| {g_worst:.3e} (band 1e-4 each); updated "
                  f"parameters worst max|card-cpu| {p_worst:.3e} (band 1e-4 "
                  f"x {scale:.4f}), per tensor at most {p_rel:.3e} of its "
                  f"max"
                  + (f"; routing decisions (token, MoE layer) that differ: "
                     f"{flips} of {decisions}" if decisions else ""))
    torch.cuda.synchronize()


def training_phase(torch, seed, compare) -> dict:
    """Phase 15, path ``llama3.2-1b-train``: ``train("llama3.2-1b",
    smoke=False, steps=6, batch=4, seq=1024, microbatches=2, ckpt_every=3)``
    at full width under ``torch.use_deterministic_algorithms`` (warn
    only: an operation without a deterministic CUDA path is named), then a
    second ``train`` resumed from the step-3 checkpoint, then the trained
    parameters served through ``generate`` on the flash kernel. The flash
    count is set to 0 before the first ``train`` and read after
    ``generate``: training runs the chunked twin (no kernel has a
    backward), the prefill 16 launches. Then the checks and times: the
    restart against the uninterrupted run (bit for bit, or within 1e-5 x
    max naming the operation), one step at two microbatches against one
    at one from the step-6 checkpoint (1e-4 x max), the prefill's logits
    against the chunked prefill (1e-3 x max|chunked|), each kernel call
    against plain on its own inputs, step times with per-layer
    checkpointing on and off and their peak memory, a profile of one
    step, and the flash call's times. Returns the path's flash record."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_plain_call)
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import generate
    from repro_torch.launch.train_step import make_train_step
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model, make_batch
    from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule

    dev = torch.device("cuda")
    cfg = get_config("llama3.2-1b")
    width = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.d_head, cfg.d_ff, cfg.vocab, cfg.tie_embeddings)
    if width != (16, 2048, 32, 8, 64, 8192, 128256, True):
        raise AssertionError(f"llama3.2-1b config {width}")
    b, s = TRAIN_KW["batch"], TRAIN_KW["seq"]
    tokens = b * s
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    ckpt_bytes = 3 * TRAIN_PARAMS * 4 + 4  # params, m, v in fp32; count
    free = shutil.disk_usage(ckpt_dir).free
    print(f"{TRAIN_PATH}: free disk under {ckpt_dir}: {free / 1e9:.3f} GB; "
          f"one checkpoint holds {ckpt_bytes / 1e9:.3f} GB (params, m, v in "
          f"fp32), the runs keep two at once")
    if free < 2.2 * ckpt_bytes:
        raise AssertionError(f"{TRAIN_PATH}: {free / 1e9:.3f} GB of disk "
                             f"free, two checkpoints need "
                             f"{2 * ckpt_bytes / 1e9:.3f}")

    # host-clock timers: a step (ending in a synchronize) inside train(),
    # the checkpoint's device -> host copy, its write and its restore
    step_s, snap_s, write_s, restore_s = [], [], [], []
    real_make = train_mod.make_train_step

    def timed_make(api, opt, microbatches=1):
        step = real_make(api, opt, microbatches)

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out

        return timed

    def timing(method, times):
        def timed(self, *args, **kw):
            t0 = time.perf_counter()
            out = method(self, *args, **kw)
            times.append(time.perf_counter() - t0)
            return out

        return timed

    patches = [(train_mod, "make_train_step", timed_make),
               (Checkpointer, "_snapshot",
                timing(Checkpointer._snapshot, snap_s)),
               (Checkpointer, "_write", timing(Checkpointer._write, write_s)),
               (Checkpointer, "restore",
                timing(Checkpointer.restore, restore_s))]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    train_kw = dict(TRAIN_KW, ckpt_dir=str(ckpt_dir), seed=seed,
                    log_every=1)
    fkernel.launches = 0
    skernel.launches = 0
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params_a, losses_a = train_mod.train("llama3.2-1b", **train_kw)
            train_a_s = time.perf_counter() - t0
            peak_train = torch.cuda.max_memory_allocated()
            steps_a = list(step_s)
            ckpt_files = sum(f.stat().st_size
                             for f in (ckpt_dir / "step_3").iterdir())
            # a run killed after its step-3 checkpoint: step 6's never
            # committed, so the restart resumes from step 3
            shutil.rmtree(ckpt_dir / "step_6")
            t0 = time.perf_counter()
            params_b, losses_b = train_mod.train("llama3.2-1b", **train_kw)
            train_b_s = time.perf_counter() - t0
        nondet = sorted({str(w.message).split(" does not have")[0]
                         for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    n_params = sum(p.numel() for p in params_a.parameters())
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"{TRAIN_PATH}: {n_params} parameters")
    if fkernel.launches or skernel.launches:
        raise AssertionError(f"{TRAIN_PATH}: training launched flash "
                             f"{fkernel.launches}, SSD {skernel.launches}")
    ln_v = math.log(cfg.vocab)
    if len(losses_a) != 6 or not all(map(math.isfinite, losses_a)) \
            or abs(losses_a[0] - ln_v) > 0.5:
        raise AssertionError(f"{TRAIN_PATH} losses {losses_a} (ln V "
                             f"{ln_v:.4f})")
    step_ms = statistics.median(steps_a[1:]) * 1e3
    print(f"{TRAIN_PATH}: {n_params} parameters (fp32, "
          f"{n_params * 4 / 1e9:.3f} GB), {b} x {s} tokens a step in "
          f"{TRAIN_KW['microbatches']} microbatches; losses "
          f"{[round(x, 6) for x in losses_a]} (ln V = {ln_v:.4f}); "
          f"train() {train_a_s:.3f} s for 6 steps and 2 checkpoints")
    print(f"time {TRAIN_PATH} step: {step_ms:.3f} ms (host clock after "
          f"synchronize, median of steps 2-6; step 1 "
          f"{steps_a[0] * 1e3:.3f} ms), {tokens / step_ms * 1e3:.1f} "
          f"tokens/s; peak device memory {peak_train / 1e9:.3f} GB")
    # the work a step must do: 6 N T for the matmul parameters (the tied
    # embedding counts once, as the LM head) and the causal attention,
    # forward and backward; per-layer recomputation and the recomputed LM
    # head add to what runs, not to the bound
    n_norm = (2 * cfg.n_layers + 1) * cfg.d_model
    attn = 3 * cfg.n_layers * b * cfg.n_heads * 2 * cfg.d_head * s * (s + 1)
    flop = 6 * (n_params - n_norm) * tokens + attn
    remat = (2 * (n_params - n_norm - cfg.vocab_padded * cfg.d_model)
             * tokens + attn / 3)
    print(f"  bound {TRAIN_PATH} step: {flop / 1e12:.3f} TFLOP (6 N T "
          f"{6 * (n_params - n_norm) * tokens / 1e12:.3f}, causal attention "
          f"{attn / 1e12:.3f}) at 67 TFLOP/s fp32: "
          f"{flop / FP32_TFLOPS * 1e3:.3f} ms, the step at "
          f"{flop / FP32_TFLOPS * 1e3 / step_ms * 100:.2f}%; the per-layer "
          f"recomputation adds {remat / 1e12:.3f} TFLOP that run")
    print(f"  checkpoint {TRAIN_PATH}: {ckpt_files} bytes on disk a step; "
          f"device -> host copy (blocking in save_async) "
          f"{[round(x, 3) for x in snap_s]} s; write + md5 (in the "
          f"background) {[round(x, 3) for x in write_s]} s; restore "
          f"(read + md5 + host -> device) {[round(x, 3) for x in restore_s]}"
          f" s; the restarted train() {train_b_s:.3f} s")
    if losses_b == losses_a[3:] and all(
            torch.equal(x, y) for x, y in zip(params_a.parameters(),
                                              params_b.parameters())):
        print(f"{TRAIN_PATH} restart from step 3: losses of steps 4-6 and "
              f"the final parameters bit-equal to the uninterrupted run's "
              f"(deterministic algorithms; operations without a "
              f"deterministic CUDA path: {nondet or 'none'})")
    else:
        print(f"{TRAIN_PATH} restart from step 3: not bit-equal; operations "
              f"without a deterministic CUDA path: {nondet or 'none'}; held "
              f"within 1e-5 x max")
        worst = max(abs(x - y) / abs(y)
                    for x, y in zip(losses_b, losses_a[3:]))
        if len(losses_b) != 3 or worst > 1e-5:
            raise AssertionError(f"restart losses {losses_b} against "
                                 f"{losses_a[3:]}")
        perr = max(compare(f"restart {name}", y.detach(), x.detach(),
                           rel=1e-5)[0]
                   for (name, x), y in zip(params_a.named_parameters(),
                                           params_b.parameters()))
        print(f"  restart losses within {worst:.3e} (relative), parameters "
              f"within max|err| {perr:.3e}")
    del params_a
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the trained weights served: the end of the counted path -------
    api = build_model(cfg, dtype=torch.float32)
    prompt = make_batch(cfg, b, s, device=dev,
                        generator=torch.Generator().manual_seed(seed + 15))
    prompt.pop("labels")
    calls = []
    cuda_call = fops.flash_attention_cuda_call

    def recording_call(q, k, v, *, causal=True, **kw):
        out = cuda_call(q, k, v, causal=causal, **kw)
        calls.append((q, k, v, causal, out))
        return out

    fops.flash_attention_cuda_call = recording_call
    try:
        out = generate(api, params_b, prompt, 8)
    finally:
        fops.flash_attention_cuda_call = cuda_call
    launches = fkernel.launches
    if launches != cfg.n_layers or skernel.launches:
        raise AssertionError(f"{TRAIN_PATH}: {launches} flash launches "
                             f"(want {cfg.n_layers}), SSD "
                             f"{skernel.launches}")
    toks = out["tokens"]
    if tuple(toks.shape) != (b, 8) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_padded:
        raise AssertionError(f"{TRAIN_PATH} tokens {tuple(toks.shape)}")
    flash_err, flash_rel = 0.0, 0.0
    for q, k, v, causal, got in calls:
        err, scale = compare(f"{TRAIN_PATH} flash call vs plain", got,
                             flash_attention_plain_call(q, k, v,
                                                        causal=causal),
                             rel=1e-3)
        flash_err, flash_rel = max(flash_err, err), max(flash_rel,
                                                        err / scale)
    chunked = build_model(cfg, dtype=torch.float32, attn_impl="chunked")
    logits, _ = api.prefill(params_b, prompt, s + 8)
    want, _ = chunked.prefill(params_b, prompt, s + 8)
    err, scale = compare(f"{TRAIN_PATH} prefill logits, flash vs chunked",
                         logits, want, rel=1e-3)
    print(f"{TRAIN_PATH} served: {launches} flash launches over the "
          f"training and one {b} x {s} prefill (training none), tokens "
          f"{tuple(toks.shape)}; each call within max|kernel-plain| "
          f"{flash_err:.3e}, at most {flash_rel:.3e} of its max|plain|, "
          f"on its own inputs (band 1e-3 x max|plain|); "
          f"prefill logits max|flash-chunked| {err:.3e} (max|chunked| "
          f"{scale:.3e}, band 1e-3 x max|chunked|)")
    q, k, v, causal, _ = calls[0]
    case = (b, cfg.n_heads, cfg.n_kv_heads, s, s, cfg.d_head, causal)
    k_ms = time_ms(torch, lambda: fkernel.flash_attention_cuda_call(
        q, k, v, causal=causal))
    p_ms = time_ms(torch, lambda: flash_attention_plain_call(
        q, k, v, causal=causal))
    l_ms = time_ms(torch, lambda: torch.nn.functional.
                   scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                enable_gqa=True))
    fl, nbytes, bound, bound_by, _ = flash_cost(*case)
    print(f"time {TRAIN_PATH} flash attention {case[:-1]} causal fp32 on "
          f"the trained weights' layer-1 inputs: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, scaled_dot_product_attention {l_ms:.4f} "
          f"ms; bound {bound:.4f} ms ({bound_by}), kernel at "
          f"{bound / k_ms * 100:.2f}% of bound")
    del calls, q, k, v, logits, want, chunked, out

    # ---- one step at two microbatches against one at one, from step 6 --
    total = TRAIN_KW["steps"]
    opt = AdamW(learning_rate=cosine_schedule(3e-3, total // 10, total),
                weight_decay=0.01)
    state1 = opt.init(params_b)
    restored, _ = Checkpointer(str(ckpt_dir)).restore((params_b, state1))
    if restored != total:
        raise AssertionError(f"restored step {restored}")
    params2 = copy.deepcopy(params_b)
    state2 = AdamWState([m.clone() for m in state1.m],
                        [v.clone() for v in state1.v], state1.count.clone())
    raw = SyntheticLM(vocab=cfg.vocab, seq_len=s, global_batch=b,
                      seed=seed).batch_at(total)
    batch = {key: torch.from_numpy(raw[key]).to(dev)
             for key in ("tokens", "labels")}
    batch2 = {key: x.reshape(2, b // 2, s) for key, x in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    m1 = make_train_step(api, opt, 1)(params_b, state1, batch)
    peak_m1 = torch.cuda.max_memory_allocated()
    m2 = make_train_step(api, opt, 2)(params2, state2, batch2)
    mb_err = max(compare(f"microbatches 2 vs 1 {name}", y.detach(),
                         x.detach(), rel=1e-4)[0]
                 / float(x.detach().abs().max())
                 for (name, x), y in zip(params_b.named_parameters(),
                                         params2.parameters()))
    compare("microbatches 2 vs 1 loss", m2["loss"], m1["loss"], rel=1e-4)
    print(f"{TRAIN_PATH} step 7 from the step-6 checkpoint, microbatches 2 "
          f"against 1 on the same batch: loss {float(m2['loss']):.6f} vs "
          f"{float(m1['loss']):.6f}; every parameter within "
          f"max|err| / max|p| {mb_err:.3e} (band 1e-4); peak device memory "
          f"at one microbatch {peak_m1 / 1e9:.3f} GB")
    del params2, state2

    # ---- per-layer checkpointing on and off: step time and peak memory --
    def loss_without_remat(p, bt):
        """``decoder_lm_loss`` of a dense decoder (no aux losses) with
        ``decoder_stack``'s per-layer checkpointing off."""
        x = transformer.embed_tokens(p, bt["tokens"], cfg)
        positions = torch.arange(s, device=dev)[None].expand(x.shape[0], s)
        x, _, _ = transformer.decoder_stack(p, x, cfg, positions,
                                            attn_impl="chunked",
                                            ssd_impl="chunked", remat=False)
        ce = transformer.chunked_cross_entropy(p, x, bt["labels"], cfg)
        return ce, {"ce": ce}

    no_remat = dataclasses.replace(api, train_loss=loss_without_remat)
    timed = {}
    for label, a in (("on", api), ("off", no_remat)):
        step = make_train_step(a, opt, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            metrics = step(params_b, state1, batch2)
            float(metrics["loss"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        timed[label] = (statistics.median(times[1:]),
                        torch.cuda.max_memory_allocated())
    (on_ms, on_peak), (off_ms, off_peak) = timed["on"], timed["off"]
    print(f"time {TRAIN_PATH} step, per-layer checkpointing on / off "
          f"(host clock after synchronize, median of steps 2-3): "
          f"{on_ms:.3f} / {off_ms:.3f} ms, peak device memory "
          f"{on_peak / 1e9:.3f} / {off_peak / 1e9:.3f} GB; the "
          f"recomputation adds {(on_ms - off_ms) / on_ms * 100:.2f}% of "
          f"the step")
    step = make_train_step(api, opt, 2)
    trace_breakdown(torch, f"{TRAIN_PATH} step",
                    lambda: step(params_b, state1, batch2), top=10)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    # times: one call at the prefill's shape, 16 calls a prefill
    n = cfg.n_layers
    return {"name": "flash_attention", "path": TRAIN_PATH, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:111",
            "launches": launches, "max_abs_err": flash_err, "ms": n * k_ms,
            "plain_ms": n * p_ms, "bound_ms": n * bound,
            "bound_by": bound_by, "library_ms": n * l_ms}


def flash_record(torch, compare, path, case, n, launches, err, qkv=None,
                 seed=0, dev="cuda", rel=1e-3):
    """Time one flash call at ``case`` (B, Hq, Hkv, Sq, Skv, D, causal) on
    ``qkv`` (default: random inputs from ``seed``), held against plain
    (``rel`` x max|plain|), beside its plain version,
    ``scaled_dot_product_attention`` and its bound, each counted ``n``
    times (the calls of one unit of the path). Returns the path's flash
    record, its ``max_abs_err`` the larger of ``err`` and this call's."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_plain_call)

    b, hq, hkv, sq, sk, d, causal = case
    if qkv is None:
        gen = torch.Generator().manual_seed(seed)
        qkv = [torch.randn(shape, generator=gen).to(dev)
               for shape in ((b, hq, sq, d), (b, hkv, sk, d),
                             (b, hkv, sk, d))]
    q, k, v = qkv
    plain = flash_attention_plain_call(q, k, v, causal=causal)
    k_err, scale = compare(f"{path} flash call vs plain",
                           fkernel.flash_attention_cuda_call(
                               q, k, v, causal=causal), plain, rel=rel)
    k_ms = time_ms(torch, lambda: fkernel.flash_attention_cuda_call(
        q, k, v, causal=causal))
    p_ms = time_ms(torch, lambda: flash_attention_plain_call(
        q, k, v, causal=causal))
    l_ms = time_ms(torch, lambda: torch.nn.functional.
                   scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                enable_gqa=True))
    flop, nbytes, bound, bound_by, _ = flash_cost(
        *case, itemsize=q.element_size())
    print(f"time {path} flash {case[:-1]} "
          f"{'causal' if causal else 'non-causal'} "
          f"{str(q.dtype).removeprefix('torch.')}: kernel {k_ms:.4f} "
          f"ms, plain {p_ms:.4f} ms, scaled_dot_product_attention "
          f"{l_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); "
          f"max|kernel-plain| {k_err:.3e} (max|plain| {scale:.3e}); "
          f"x {n} calls a unit")
    return {"name": "flash_attention", "path": path, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:111",
            "launches": launches, "max_abs_err": max(err, k_err),
            "ms": n * k_ms, "plain_ms": n * p_ms, "bound_ms": n * bound,
            "bound_by": bound_by, "library_ms": n * l_ms}


def pipeline_phase(torch, seed, compare, dev) -> dict:
    """Phase 16, path ``llama3.2-1b-pipeline``: ``plan_stages`` on
    Llama-3.2-1B's layers (4 stages of 4, replicas (2, 2, 2, 1)), then
    ``pipeline_forward`` of 8 embedded microbatches of 1 x 1024 tokens
    through the 4 stages, each ``DecoderLayer``s run by
    ``_sublayer_apply`` on the flash kernel: without a plan on a 4-position
    stage mesh, and with the STAP plan on its (4, 2) mesh, every position
    on ``dev``. Each run against ``decoder_stack`` microbatch by
    microbatch (bit for bit, else within 1e-5 x max), 128 flash launches
    each (counts set to 0 just before a run, read just after), the last
    microbatch's logits against ``decoder_prefill`` (1e-3 x max); then
    times, ticks, hops, peak memory, idle shares and the FLOP bound.
    Returns the path's flash record."""
    from repro_torch.configs import get_config
    from repro_torch.core.stap import staggered_schedule
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model, make_batch
    from repro_torch.runtime import stap_pipeline as sp
    from repro_torch.runtime.pipeline import pipeline_forward, plan_stages

    cfg = get_config("llama3.2-1b")
    width = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
             cfg.d_head, cfg.d_ff, cfg.vocab)
    if width != PIPE_WIDTH:
        raise AssertionError(f"llama3.2-1b config {width}")
    n_layers, seq, m = cfg.n_layers, PIPE_SEQ, PIPE_MICROBATCHES
    # a layer on one microbatch: 2 FLOP a parameter a token, plus the
    # causal QK^T and PV (half of 2 x 2 x S^2 x heads x d_head)
    layer_flop = 2 * PIPE_LAYER_PARAMS * seq \
        + 4 * seq * seq * cfg.n_heads * cfg.d_head / 2
    plan = plan_stages([PIPE_LAYER_PARAMS * 4] * n_layers,
                       [PIPE_LAYER_ACT] * n_layers,
                       [layer_flop] * n_layers,
                       boundary_act_bytes=PIPE_BOUNDARY,
                       stage_capacity_bytes=PIPE_CAPACITY,
                       chip_flops_per_s=FP32_TFLOPS,
                       extra_chips=PIPE_EXTRA_CHIPS)
    if plan.stage_spans != PIPE_SPANS or \
            plan.stap.replicas != PIPE_REPLICAS:
        raise AssertionError(f"stage plan {plan.stage_spans} replicas "
                             f"{plan.stap.replicas}")
    run_flop = layer_flop * n_layers * m
    bound_ms = run_flop / FP32_TFLOPS * 1e3
    print(f"{PIPE_PATH} plan: stages {plan.stage_spans} under "
          f"{PIPE_CAPACITY:.1e} B a stage ({4 * PIPE_LAYER_PARAMS * 4 / 1e6:.1f}"
          f" MB of weights; 5 layers would be "
          f"{5 * PIPE_LAYER_PARAMS * 4 / 1e6:.1f}), replicas "
          f"{plan.stap.replicas} on {plan.stap.chips} positions, planned "
          f"throughput {plan.stap.throughput:.3f} microbatches/s at 67 "
          f"TFLOP/s, transfers {plan.partition.transfers:.0f} B")
    before_gb = torch.cuda.memory_allocated() / 1e9
    api = build_model(cfg, dtype=torch.float32, device=dev)
    params = api.init(torch.Generator(dev).manual_seed(seed + 16))
    n_layer = sum(p.numel() for p in params.layers[0].parameters())
    if n_layer != PIPE_LAYER_PARAMS:
        raise AssertionError(f"{n_layer} parameters a layer")
    tokens = make_batch(cfg, m, seq, device=dev,
                        generator=torch.Generator().manual_seed(
                            seed + 160))["tokens"]
    positions = torch.arange(seq, device=dev)[None]
    with torch.no_grad():
        xs = transformer.embed_tokens(params, tokens, cfg)[:, None]

    def stage_fn(layers_, x):
        for layer in layers_:
            x, _, _ = transformer._sublayer_apply(
                layer, x, cfg, positions, None, None, "flash", "kernel")
        return x

    stages = [params.layers[a:b] for a, b in plan.stage_spans]
    gpipe_mesh = sp.DeviceMesh(sp._grid([dev] * len(stages),
                                        (len(stages),)), (sp.STAGE_AXIS,))
    stap_mesh = sp.stap_mesh(len(stages), max(plan.stap.replicas),
                             devices=[dev] * (len(stages)
                                              * max(plan.stap.replicas)))
    runs = {
        "gpipe": lambda: pipeline_forward(stage_fn, stages, xs, gpipe_mesh),
        "stap": lambda: pipeline_forward(stage_fn, stages, xs, stap_mesh,
                                         plan=plan.stap)}

    def sequential():
        return torch.stack([transformer.decoder_stack(
            params, xs[i], cfg, positions, attn_impl="flash")[0]
            for i in range(m)])

    hop = sp._hop
    hops = {}

    def counting_hop(ys, perms, devs, shape, dtype):
        """``_hop``, counting its calls, the bytes it copies between
        positions and the bytes of the zeroed receive buffers it makes."""
        sent = sum(1 for w, perm in enumerate(perms) for src, _dst in perm
                   if ys[src][w] is not None)
        size = torch.empty((), dtype=dtype).element_size()
        got = hops.setdefault("n", [0, 0, 0])
        got[0] += 1
        got[1] += sent * math.prod(shape[1:]) * size
        got[2] += len(devs) * math.prod(shape) * size
        return hop(ys, perms, devs, shape, dtype)

    launches = 0
    with torch.no_grad():
        want = sequential()
        torch.cuda.synchronize()
        for name, run in runs.items():
            hops.clear()
            sp._hop = counting_hop
            try:
                fkernel.launches = 0
                out = run()
                torch.cuda.synchronize()
                n_run = fkernel.launches
            finally:
                sp._hop = hop
            if n_run != n_layers * m:
                raise AssertionError(f"{PIPE_PATH} {name}: {n_run} "
                                     f"launches")
            launches += n_run
            if tuple(out.shape) != tuple(xs.shape):
                raise AssertionError(f"{name} output {tuple(out.shape)}")
            n_hops, sent_b, zero_b = hops.get("n", [0, 0, 0])
            if torch.equal(out, want):
                held = "bit-equal to decoder_stack microbatch by microbatch"
            else:
                e, scale = compare(f"{PIPE_PATH} {name} vs decoder_stack",
                                   out, want, rel=1e-5)
                held = (f"NOT bit-equal to decoder_stack: max|diff| "
                        f"{e:.3e} within 1e-5 x max {scale:.3e}")
            sched_ticks = (len(stages) + m - 1 if name == "gpipe" else
                           staggered_schedule(plan.stap, m).n_ticks)
            print(f"{PIPE_PATH} {name}: {n_run} flash launches, output "
                  f"{tuple(out.shape)}, {held}; {sched_ticks} ticks, "
                  f"{n_hops} hops sending {sent_b / 1e6:.3f} MB and "
                  f"zero-filling {zero_b / 1e6:.3f} MB of receive buffers")
        logits = transformer.unembed(params, out[-1][:, -1:], cfg)
        want_logits, _ = api.prefill(params, {"tokens": tokens[-1:]}, seq)
        e, scale = compare(f"{PIPE_PATH} last microbatch logits vs prefill",
                           logits, want_logits, rel=1e-3)
        print(f"{PIPE_PATH} last microbatch logits vs decoder_prefill: "
              f"max|diff| {e:.3e} (max|prefill| {scale:.3e}, band 1e-3 x "
              f"max)")
        # one stage's flash call, captured on its real inputs
        cuda_call = fops.flash_attention_cuda_call
        seen = []

        def capture(q, k, v, *, causal=True, **kw):
            seen.append((q, k, v, causal))
            return cuda_call(q, k, v, causal=causal, **kw)

        fops.flash_attention_cuda_call = capture
        try:
            stage_fn(stages[0][:1], xs[0])
        finally:
            fops.flash_attention_cuda_call = cuda_call
        q, k, v, causal = seen[0]
        case = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                q.shape[3], causal)
        rec = flash_record(torch, compare, PIPE_PATH, case,
                           n_layers * m, launches, 0.0, qkv=(q, k, v))
        # in turns: sequential, gpipe, stap, then the reverse, three times
        torch.cuda.reset_peak_memory_stats()
        timed = {"sequential": sequential, **runs}
        samples = {name: [] for name in timed}
        for fn in timed.values():
            fn()
        for rep in range(6):
            for name in (list(timed) if rep % 2 == 0 else
                         list(reversed(timed))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                timed[name]()
                torch.cuda.synchronize()
                samples[name].append((time.perf_counter() - t0) * 1e3)
        times = {name: statistics.median(v) for name, v in samples.items()}
        seq_ms = times["sequential"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        x_hop = xs[0]
        hop_ms = time_ms(torch, lambda: hop(
            [[x_hop]] * len(stages),
            [[(i, i + 1) for i in range(len(stages) - 1)]],
            gpipe_mesh.flat, (1,) + tuple(x_hop.shape), x_hop.dtype))
        print(f"time {PIPE_PATH}: 8 microbatches one after another "
              f"(decoder_stack) {seq_ms:.3f} ms; gpipe {times['gpipe']:.3f}"
              f" ms ({times['gpipe'] / seq_ms:.4f}x); stap "
              f"{times['stap']:.3f} ms ({times['stap'] / seq_ms:.4f}x) "
              f"(host clock after synchronize, median of 6 taken in "
              f"turns); FLOP "
              f"{run_flop / 1e12:.4f} T, bound {bound_ms:.3f} ms at 67 "
              f"TFLOP/s (sequential at {bound_ms / seq_ms * 100:.2f}%); "
              f"one gpipe tick's hop (3 copies of "
              f"{PIPE_BOUNDARY / 1e6:.3f} MB, 4 zeroed buffers) "
              f"{hop_ms * 1e3:.3f} us (CUDA events, median of 5); peak "
              f"memory {peak:.3f} GB, of which {before_gb:.3f} GB was "
              f"allocated before this phase built its model")
        for name, run in timed.items():
            trace_breakdown(torch, f"{PIPE_PATH} {name}", run, top=5)
    return rec


def ep_phase(torch, seed, compare, dev, api, params, prompts) -> dict:
    """Phase 17, path ``olmoe-1b-7b-ep``: phase 12's OLMoE-1B-7B serves
    request 1's prefill inside ``use_shardings(ShardCtx(mesh))`` with
    ``mesh`` a (1, 4) ("data", "model") ``DeviceMesh`` on ``dev``: each
    model position runs 16 of the 64 experts, as views of the weights.
    Held against the same prefill without a context ("local", 1e-3 x
    max), the routing decisions that differ counted, 16 flash launches;
    times. Then ``allreduce_compressed`` over the 4 positions of a
    ("data",) mesh on ``dev`` on four gradient lists of the Llama smoke
    config (four data shards of one batch): against the CPU port (int8
    payloads and their int32 sums equal, floats within 1e-6 of the
    magnitudes they come from) and the plain fp32 mean (within the
    estimator's element-wise bound; the tensors within one EF step,
    max|g| / 127, counted). Returns the path's flash record."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.models import moe
    from repro_torch.models.api import build_model, make_batch
    from repro_torch.models.sharding import ShardCtx, use_shardings
    from repro_torch.optim import compression
    from repro_torch.runtime import stap_pipeline as sp

    cfg = api.cfg
    (b, s, g), prompt = LM_REQUESTS[0], prompts[0]
    mesh = sp.DeviceMesh(sp._grid([dev] * math.prod(EP_MESH), EP_MESH),
                         ("data", "model"))
    tp = EP_MESH[1]
    e_local = cfg.moe.n_experts // tp
    route, local_moe = moe._route, moe._local_moe
    routed, views = [], []

    def recording_route(x, router, e, k):
        out = route(x, router, e, k)
        routed.append(out[1].sort(dim=-1).values)
        return out

    def recording_local_moe(x2d, router, w1, w3, w2, **kw):
        e0 = kw.get("e_start", 0)
        views.append(all(
            w._base is not None and w.shape[0] == e_local
            and w.data_ptr() - w.untyped_storage().data_ptr()
            == e0 * w.stride(0) * w.element_size() for w in (w1, w3, w2)))
        return local_moe(x2d, router, w1, w3, w2, **kw)

    moe._route, moe._local_moe = recording_route, recording_local_moe
    torch.cuda.reset_peak_memory_stats()
    try:
        with use_shardings(ShardCtx(mesh=mesh)):
            fkernel.launches = 0
            logits, _ = api.prefill(params, prompt, s + g)
            torch.cuda.synchronize()
            launches = fkernel.launches
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_ep = len(routed)
        views_ok = len(views) == cfg.n_layers * tp and all(views)
        want, _ = api.prefill(params, prompt, s + g)
    finally:
        moe._route, moe._local_moe = route, local_moe
    if launches != cfg.n_layers:
        raise AssertionError(f"{EP_PATH}: {launches} launches")
    if n_ep != cfg.n_layers * tp or len(routed) != n_ep + cfg.n_layers:
        raise AssertionError(f"{EP_PATH}: {n_ep} routings under EP")
    if not views_ok:
        raise AssertionError(f"{EP_PATH}: a position's experts were not "
                             f"views at its offset")
    ep_routes, local_routes = routed[:n_ep], routed[n_ep:]
    for layer in range(cfg.n_layers):
        first = ep_routes[layer * tp]
        if not all(torch.equal(first, r)
                   for r in ep_routes[layer * tp:(layer + 1) * tp]):
            raise AssertionError(f"layer {layer}: the model positions "
                                 f"routed differently")
    flips = sum(int((ep_routes[l * tp] != local_routes[l]).any(dim=-1).sum())
                for l in range(cfg.n_layers))
    decisions = sum(int(r.shape[0]) for r in local_routes)
    err, scale = compare(f"{EP_PATH} prefill logits vs local", logits, want,
                         rel=1e-3)
    weights_gb = sum(p.numel() for p in params.parameters()) * 4 / 1e9
    print(f"{EP_PATH} request 1 (batch {b}, prompt {s}) on a "
          f"{EP_MESH} (data, model) mesh, {e_local} experts a position as "
          f"views: {launches} flash launches, logits max|ep-local| "
          f"{err:.3e} (max|local| {scale:.3e}, band 1e-3 x max); routing "
          f"decisions (token, MoE layer) that differ: {flips} of "
          f"{decisions}; the {tp} positions route alike in every layer; "
          f"peak device memory during the EP prefill {peak:.3f} GB "
          f"(OLMoE's weights {weights_gb:.3f} GB)")
    ep_ms = time_ms(torch, lambda: _ep_prefill(api, params, prompt, s + g,
                                               mesh))
    local_ms = time_ms(torch, lambda: api.prefill(params, prompt, s + g))
    n_adds = cfg.n_layers * (tp - 1)
    # the partials are (T, D); no other add of the prefill has 2-d inputs
    # of that shape (the residual adds are (B, S, D))
    part = [b * s, cfg.d_model]
    got_adds, add_ms = op_device_ms(
        torch, lambda: _ep_prefill(api, params, prompt, s + g, mesh),
        "aten::add", [part, part])
    if got_adds != n_adds:
        raise AssertionError(f"{EP_PATH}: {got_adds} partial-sum adds in "
                             f"the trace, {n_adds} expected")
    print(f"time {EP_PATH} prefill: ep {ep_ms:.3f} ms, local "
          f"{local_ms:.3f} ms ({ep_ms / local_ms:.4f}x; CUDA events, median "
          f"of 5); the partial sums: {got_adds} adds of {b * s} x "
          f"{cfg.d_model} fp32 in a traced EP prefill, {add_ms:.4f} ms of "
          f"device time together ({add_ms / got_adds:.4f} ms each)")
    trace_breakdown(torch, f"{EP_PATH} prefill",
                    lambda: _ep_prefill(api, params, prompt, s + g, mesh),
                    top=5)
    rec = flash_record(torch, compare, EP_PATH,
                       (b, cfg.n_heads, cfg.n_kv_heads, s, s, cfg.d_head,
                        True), cfg.n_layers, launches, 0.0, seed=seed + 17,
                       dev=dev)

    # the compressed all-reduce over four data positions
    smoke = get_smoke("llama3.2-1b")
    sapi = build_model(smoke, dtype=torch.float32, device=dev)
    sparams = sapi.init(torch.Generator(dev).manual_seed(seed + 170))
    batch = make_batch(smoke, 16, 64, device=dev,
                       generator=torch.Generator().manual_seed(seed + 171))
    leaves = list(sparams.parameters())
    grads = []
    for shard in range(4):
        part_b = {k: v[4 * shard:4 * (shard + 1)] for k, v in batch.items()}
        loss, _ = sapi.train_loss(sparams, part_b)
        grads.append([gr.detach() for gr in
                      torch.autograd.grad(loss, leaves)])
    data_mesh = sp.DeviceMesh(sp._grid([dev] * 4, (4,)), ("data",))
    cpu = torch.device("cpu")
    cpu_mesh = sp.DeviceMesh(sp._grid([cpu] * 4, (4,)), ("data",))
    cpu_grads = [[gr.to(cpu) for gr in gl] for gl in grads]
    means, states = compression.allreduce_compressed(
        grads, [compression.init_ef(gl) for gl in grads], data_mesh, "data")
    c_means, c_states = compression.allreduce_compressed(
        cpu_grads, [compression.init_ef(gl) for gl in cpu_grads], cpu_mesh,
        "data")
    worst_f, worst_bound, worst_step, in_step = 0.0, 0.0, 0.0, 0
    for leaf in range(len(leaves)):
        packed = [compression.compress(gl[leaf], torch.zeros_like(gl[leaf]))
                  for gl in grads]
        qs = [q for q, _, _ in packed]
        c_qs = [compression.compress(gl[leaf], torch.zeros_like(gl[leaf]))[0]
                for gl in cpu_grads]
        for q, c_q in zip(qs, c_qs):
            if not torch.equal(q.cpu(), c_q):
                raise AssertionError(f"leaf {leaf}: int8 payloads differ")
        total = sum(q.to(torch.int32) for q in qs)
        if not torch.equal(total.cpu(), sum(q.to(torch.int32)
                                            for q in c_qs)):
            raise AssertionError(f"leaf {leaf}: int32 sums differ")
        # floats within 1e-6 of the magnitudes they are computed from:
        # the mean's own max, and the gradient's for the residual
        # x - q * s, which cancels to within s / 2 of 0
        for p in range(4):
            for got, ref, mag in (
                    (means[p][leaf], c_means[p][leaf],
                     float(c_means[p][leaf].abs().max())),
                    (states[p].residual[leaf], c_states[p].residual[leaf],
                     float(cpu_grads[p][leaf].abs().max()))):
                e = float((got.cpu() - ref).abs().max())
                if e > 1e-6 * mag:
                    raise AssertionError(
                        f"allreduce leaf {leaf} position {p}: max|gpu-cpu| "
                        f"{e:.3e} > 1e-6 x {mag:.3e}")
                worst_f = max(worst_f, e / max(mag, 1e-30))
        # g_p = q_p s_p + r_p with |r_p| <= s_p / 2, and the EF mean is
        # sum q_p * mean(s) / n: it differs from the fp32 mean by
        # sum (q_p (mean(s) - s_p) - r_p) / n, so element by element by at
        # most sum (|q_p| |mean(s) - s_p| + s_p / 2) / n; within one EF
        # step, max|g| / 127, only where the positions' scales agree
        plain = sum(gl[leaf] for gl in grads) / 4
        s_bar = sum(sc for _, sc, _ in packed) / 4
        bound = sum(q.float().abs() * (s_bar - sc).abs() + sc / 2
                    for q, sc, _ in packed) / 4
        diff = (means[0][leaf] - plain).abs()
        slack = 1e-6 * float(plain.abs().max()) + 1e-12
        if bool((diff > bound * (1 + 1e-5) + slack).any()):
            raise AssertionError(f"leaf {leaf}: the EF mean outside its "
                                 f"rounding and scale bound")
        worst_bound = max(worst_bound, float((diff / (bound + slack)).max()))
        step = max(float(gl[leaf].abs().max()) for gl in grads) / 127
        e = float(diff.max())
        worst_step = max(worst_step, e / step)
        in_step += e <= step
    print(f"{EP_PATH} allreduce_compressed over {len(leaves)} tensors of "
          f"the llama3.2-1b smoke config's gradients on 4 data positions: "
          f"int8 payloads and int32 sums equal to the CPU port's, means "
          f"and residuals within {worst_f:.3e} x the magnitude they are "
          f"computed from (the mean's max, the gradient's); the EF "
          f"mean against the fp32 mean: within its element-wise bound "
          f"(at most {worst_bound:.4f} of it); {in_step} of {len(leaves)} "
          f"tensors within one EF step (max|g| / 127), the worst at "
          f"{worst_step:.4f} steps")
    return rec


def _ep_prefill(api, params, prompt, s_max, mesh):
    from repro_torch.models.sharding import ShardCtx, use_shardings

    with use_shardings(ShardCtx(mesh=mesh)):
        return api.prefill(params, prompt, s_max)


def dryrun_phase(torch, seed, compare, dev) -> list:
    """Phase 18, paths ``llama3.2-1b-dryrun-{train,prefill,decode}``: each
    cell's ``meta`` record held against the same cell drawn on the card
    (bytes and FLOPs exactly; the peak of one call printed beside the
    estimate), timed; the prefill through flash. Returns the flash record
    of the prefill path."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeCfg, get_config
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import dryrun, specs
    from repro_torch.models.api import build_model
    from repro_torch.runtime.stap_pipeline import DeviceMesh, _grid

    cfg = get_config("llama3.2-1b")
    mesh = DeviceMesh(_grid([dev], (1, 1)), ("data", "model"))
    flash_rec = None
    for kind, seq, batch in DRYRUN_CELLS:
        path = f"{DRYRUN_PATH}-{kind}"
        shape = ShapeCfg(f"{kind}_{batch}x{seq}", seq, batch, kind)
        ctx = specs.make_ctx(mesh, False, shape)
        t0 = time.perf_counter()
        rec = dryrun.cell_record(cfg, shape, ctx)
        t_meta = time.perf_counter() - t0
        mem, cost = rec["memory_per_device"], rec["cost_per_device"]
        gc.collect()
        torch.cuda.empty_cache()
        cell = specs.build_cell(
            cfg, shape, ctx, generator=torch.Generator(dev).manual_seed(seed))
        leaves = [dryrun.flat_leaves(a, torch.Tensor) for a in cell.args]
        nbytes = [sum(t.numel() * t.element_size() for t in ts)
                  for ts in leaves]
        donated = sum(nbytes[i] for i in cell.donate_argnums)
        if (sum(nbytes), donated) != (mem["arguments_bytes"],
                                      mem["alias_bytes"]):
            raise AssertionError(
                f"{path}: arguments {sum(nbytes)} B, donated {donated} B on "
                f"the card; the record says {mem['arguments_bytes']} and "
                f"{mem['alias_bytes']}")
        with FlopCounterMode(display=False) as counter:
            out = cell.fn(*cell.args)
        torch.cuda.synchronize()
        if counter.get_total_flops() != cost["flops_global"]:
            raise AssertionError(f"{path}: {counter.get_total_flops()} FLOP "
                                 f"on the card, {cost['flops_global']} in "
                                 f"the record")
        del out
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = cell.fn(*cell.args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        head = out[0] if kind != "train" else out["loss"]
        if not bool(torch.isfinite(head.float()).all()):
            raise AssertionError(f"{path}: non-finite output")
        if kind != "train" and tuple(head.shape) != (batch, 1,
                                                     cfg.vocab_padded):
            raise AssertionError(f"{path}: logits {tuple(head.shape)}")
        if kind == "prefill":
            chunked_logits = head
        del out, head
        est = mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"]
        ms = time_ms(torch, lambda: cell.fn(*cell.args))
        flops = cost["flops_global"]
        print(f"{path} ({cell.label}): meta record in {t_meta:.1f} s; on "
              f"the card arguments {sum(nbytes)} B == arguments_bytes, "
              f"donated {donated} B == alias_bytes, {flops} FLOP == "
              f"flops_global ({cost['n_dots']} matrix products); peak of "
              f"one call {peak / 1e9:.4f} GB beside the estimate output + "
              f"temp - alias {est / 1e9:.4f} GB "
              f"({peak / max(est, 1):.4f}x; output + temp "
              f"{(mem['output_bytes'] + mem['temp_bytes']) / 1e9:.4f} GB)")
        print(f"time {path}: {ms:.3f} ms (CUDA events, median of 5), "
              f"{flops / ms / 1e9:.2f} TFLOP/s = "
              f"{flops / ms / 1e9 / (BF16_TFLOPS / 1e12) * 100:.2f}% of the "
              f"bf16 peak {BF16_TFLOPS / 1e12:.0f} TFLOP/s")
        if kind != "prefill":
            del cell
            continue
        # the prefill once more through the flash kernel
        api = build_model(cfg, device=dev, attn_impl="flash")
        params, batch_in = cell.args
        calls = []
        cuda_call = fops.flash_attention_cuda_call

        def capture(q, k, v, *, causal=True, **kw):
            if not calls:
                calls.append((q, k, v, causal))
            return cuda_call(q, k, v, causal=causal, **kw)

        fops.flash_attention_cuda_call = capture
        fkernel.launches = 0
        try:
            logits, _ = api.prefill(params, batch_in, seq)
            torch.cuda.synchronize()
        finally:
            fops.flash_attention_cuda_call = cuda_call
        launches = fkernel.launches
        if launches != cfg.n_layers:
            raise AssertionError(f"{path}: {launches} flash launches, want "
                                 f"{cfg.n_layers}")
        err, scale = compare(f"{path} logits, flash vs chunked", logits,
                             chunked_logits, rel=5e-2)
        print(f"{path} through flash: {launches} launches, logits "
              f"max|flash-chunked| {err:.3e} (max|chunked| {scale:.3e}, "
              f"band 5e-2 x max|chunked|, bf16)")
        q, k, v, causal = calls[0]
        case = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                q.shape[3], causal)
        flash_rec = flash_record(torch, compare, path, case, launches,
                                 launches, 0.0, qkv=(q, k, v), rel=5e-2)
        del api, params, batch_in, cell, logits, chunked_logits, calls
    return [flash_rec]


def sweep_phase() -> list:
    """Phase 18's sweep, after the timed phases: ``run_cell`` for every
    applicable shape of ``DRYRUN_SWEEP_ARCHS`` on the single-pod mesh of
    ``meta`` positions, each cell in a CPU process of its own, all started
    together; every cell must build. Its records go to
    ``results/torch_dryrun``; returns the (arch, shape) cells."""
    from repro_torch.configs import applicable_shapes, get_config

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    cells = [(a, shape) for a in DRYRUN_SWEEP_ARCHS
             for shape in applicable_shapes(get_config(a))]
    t0 = time.perf_counter()
    procs = []
    try:
        for cell in cells:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", SWEEP_CODE, *cell,
                 str(ROOT / "results" / "torch_dryrun")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=ROOT))
        for (arch, shape), proc in zip(cells, procs):
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"dry run {arch}/{shape} exited "
                                     f"{proc.returncode}: {err[-2000:]}")
            print(f"  dry run {out.strip()}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
    print(f"dry-run sweep of {DRYRUN_SWEEP_ARCHS} on the single-pod mesh of "
          f"meta positions: {len(cells)} cells built in "
          f"{time.perf_counter() - t0:.1f} s (host clock; one process a "
          f"cell, on {os.cpu_count()} CPU cores)")
    return cells


def examples_phase(torch, compare, time_span) -> list:
    """Phase 19, path ``examples``: each example twin's ``main`` on the
    card, its launches per kernel counted; the first call of each kernel
    captured, held against its plain version and timed. Returns the
    path's fused-span, flash and SSD-scan records."""
    from repro_torch.examples import (async_serve, occam_cnn_pipeline,
                                      quickstart, serve_pipeline,
                                      train_tiny_lm)
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.fused_span import kernel as span_kernel
    from repro_torch.kernels.fused_span import ops as span_ops
    from repro_torch.kernels.ssd_scan import kernel as skernel
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain_call

    first = {}
    wrapped = [(span_ops, "span_cuda_call"),
               (fops, "flash_attention_cuda_call"),
               (sops, "ssd_scan_cuda_call")]
    originals = {name: getattr(mod, name) for mod, name in wrapped}

    def capturing(name):
        def call(*args, **kw):
            first.setdefault(name, (args, kw))
            return originals[name](*args, **kw)
        return call

    counters = (span_kernel, fkernel, skernel)
    runs = [("quickstart", quickstart.main, []),
            ("occam_cnn_pipeline", occam_cnn_pipeline.main, []),
            ("serve_pipeline", serve_pipeline.main, []),
            ("async_serve", async_serve.main, []),
            ("train_tiny_lm", train_tiny_lm.main, ["--steps", "20"])]
    launched = {}
    for mod, name in wrapped:
        setattr(mod, name, capturing(name))
    try:
        for name, main_fn, argv in runs:
            before = [c.launches for c in counters]
            t0 = time.perf_counter()
            out = main_fn(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched[name] = [c.launches - b for c, b in zip(counters,
                                                             before)]
            print(f"{EXAMPLES_PATH} {name} {' '.join(argv)}: "
                  f"{secs:.2f} s (host clock); launches: fused span "
                  f"{launched[name][0]}, flash {launched[name][1]}, SSD "
                  f"scan {launched[name][2]}")
            if name == "serve_pipeline":
                for arch, r in out.items():
                    if not bool((r["tokens"] >= 0).all()) or tuple(
                            r["tokens"].shape) != (4, 16):
                        raise AssertionError(f"{name} {arch} tokens")
            if name == "train_tiny_lm" and not all(
                    math.isfinite(x) for x in out["losses_phase2"]):
                raise AssertionError(f"{name}: a loss is not finite")
    finally:
        for mod, name in wrapped:
            setattr(mod, name, originals[name])
    for name, idx in (("quickstart", 0), ("async_serve", 0),
                      ("serve_pipeline", 1), ("serve_pipeline", 2)):
        if not launched[name][idx]:
            raise AssertionError(f"{EXAMPLES_PATH} {name} launched no "
                                 f"{('fused span', 'flash', 'SSD scan')[idx]}")
    totals = [sum(v[i] for v in launched.values()) for i in range(3)]

    # the fused span's first call (quickstart's), as in phase 4
    (xs, span_params, net, a, b), kw = first["span_cuda_call"]
    kw = dict(kw, srcs=dict(kw.get("srcs") or {}))
    span_rec = new_record()
    span_rec["launches"] = totals[0]
    got, _ = span_kernel.span_cuda_call(xs, span_params, net, a, b, **kw)
    want, _ = span_ops.span_plain_call(xs, span_params, net, a, b, **kw)
    span_rec["max_abs_err"], _ = compare(f"{EXAMPLES_PATH} span ({a}, {b})",
                                         got, want, 1e-4, 1e-4)
    time_span(EXAMPLES_PATH, net, [{}] * a + list(span_params), xs, a, b,
              {k: kw[k] for k in ("srcs", "spill")}, span_rec)

    # flash's first call (serve_pipeline's Llama prefill), as in phase 7
    (q, k, v), kw = first["flash_attention_cuda_call"]
    causal = kw.get("causal", True)
    case = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
            causal)
    flash_rec = flash_record(torch, compare, EXAMPLES_PATH, case, 1,
                             totals[1], 0.0, qkv=(q, k, v))

    # the SSD scan's first call (serve_pipeline's Mamba2 prefill)
    (x, a_, b_, c_), kw = first["ssd_scan_cuda_call"]
    got, _ = skernel.ssd_scan_cuda_call(x, a_, b_, c_, **kw)
    want, _ = ssd_scan_plain_call(x, a_, b_, c_, **kw)
    scale = max(float(want.abs().max()), 1.0)
    ssd_err, _ = compare(f"{EXAMPLES_PATH} ssd scan vs plain", got, want,
                         rtol=0.0, atol=2e-5 * scale)
    k_ms = time_ms(torch, lambda: skernel.ssd_scan_cuda_call(
        x, a_, b_, c_, **kw))
    p_ms = time_ms(torch, lambda: ssd_scan_plain_call(x, a_, b_, c_, **kw))
    bsz, t, h, p_ = x.shape
    flop, nbytes, bound, bound_by = ssd_cost(
        bsz, t, h, b_.shape[2], p_, b_.shape[3],
        kw.get("state0") is not None, itemsize=x.element_size())
    print(f"time {EXAMPLES_PATH} ssd scan x {tuple(x.shape)}: kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms "
          f"({bound_by}); max|kernel-plain| {ssd_err:.3e} (band 2e-5 x "
          f"max(|plain|, 1))")
    ssd_rec = {"name": "ssd_scan", "path": EXAMPLES_PATH, "route": "cuda",
               "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
               "replaces": "src/repro/kernels/ssd_scan/kernel.py:79",
               "launches": totals[2], "max_abs_err": ssd_err, "ms": k_ms,
               "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
               "library_ms": None}
    return [span_rec, flash_rec, ssd_rec]


def benchmarks_phase(torch, compare, time_span, dev) -> dict:
    """Phase 20, path ``benchmarks``: the harness and the smoke pass on
    the card, every document's checks, the fused span's launches per
    twin; then ``vgg_mini``'s spans held against plain and timed. Returns
    the path's fused-span record."""
    from repro_torch.benchmarks import common, run, smoke, tables
    from repro_torch.benchmarks import occam_calibrate, occam_quant
    from repro_torch.core.partition import partition_cnn
    from repro_torch.kernels.fused_span import kernel
    from repro_torch.kernels.fused_span.ops import (crossing_source_keys,
                                                    span_plain_call)
    from repro_torch.models import cnn
    from repro_torch.runtime import span_engine

    t_phase = time.perf_counter()
    launched = {}

    def counted(name, fn):
        def call(*args, **kw):
            before = kernel.launches
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            launched[name] = kernel.launches - before
            return out
        return call

    originals = run.BENCHES
    run.BENCHES = [(name, counted(name, fn), note, on_device)
                   for name, fn, note, on_device in originals]
    kernel.launches = 0
    try:
        derived = run.main(["--device", str(dev)])
        before = kernel.launches
        smoke.main(["--device", str(dev)])
        torch.cuda.synchronize()
        launched["smoke"] = kernel.launches - before
    finally:
        run.BENCHES = originals
    total = kernel.launches
    print(f"{BENCH_PATH}: fused-span launches per twin {launched}; "
          f"{total} in all")
    for name in BENCH_ON_KERNEL:
        if not launched.get(name):
            raise AssertionError(f"{BENCH_PATH} {name}: its spans route to "
                                 f"the kernel and it launched none")

    docs = {name: json.loads((common.RESULTS / f"BENCH_torch_{name}.json")
                             .read_text())
            for name in ("span_engine", "stap", "serve", "async", "quant",
                         "calibrate", "autoplan")}
    for name, doc in docs.items():
        if doc.get("device") == "cpu":
            raise AssertionError(f"{BENCH_PATH} {name}: ran on the CPU")

    def within(name, err, scale):
        if not err <= 1e-3 * scale:
            raise AssertionError(f"{BENCH_PATH} {name}: max|err| {err:.3e} "
                                 f"> 1e-3 x max|oracle| {scale:.3e}")
        return f"{err:.3e}"

    se, res_row = docs["span_engine"]["vgg_mini"], \
        docs["span_engine"]["res_mini"]
    if se["spans_on_cuda_kernel"] != se["spans_total"] or \
            res_row["spans_on_cuda_kernel"] != res_row["spans_total"]:
        raise AssertionError(f"{BENCH_PATH}: span-engine routes {se}")
    errs = [within(f"span engine {k}", se[k], se["max_abs_oracle"])
            for k in ("max_abs_err_interpreted", "max_abs_err_compiled",
                      "max_abs_err_cuda_kernel")]
    within("span engine res_mini kernel", res_row["max_abs_err_cuda_kernel"],
           se["max_abs_oracle"])
    print(f"{BENCH_PATH} occam_span_engine vgg_mini 32x32 (us/image, host "
          f"clock after synchronize): oracle {se['us_oracle_jit']}, "
          f"interpreted {se['us_interpreted']}, compiled (scan) "
          f"{se['us_compiled']}, occam_forward_jit {se['us_whole_net_jit']},"
          f" kernel route {se['us_cuda_kernel']}; derived compiled over "
          f"interpreted {se['speedup_compiled_vs_interpreted']} "
          f"(floor_10x_met {se['floor_10x_met']}), kernel over "
          f"interpreted {se['speedup_cuda_kernel_vs_interpreted']}; "
          f"max|err| vs oracle {errs}; res_mini kernel "
          f"{res_row['us_cuda_kernel']} us; out_rows sweep "
          f"{[(e['out_rows'], e['us_scan'], e['us_cuda_kernel']) for e in docs['span_engine']['out_rows_sweep']]}")

    st = docs["stap"]
    errs = [within(f"stap {k}", st[k], st["max_abs_oracle"])
            for k in ("max_abs_err_pipeline", "max_abs_err_stap",
                      "max_abs_err_single_device")]
    if st["stage_engines"] != ["pallas"] * len(st["stage_engines"]):
        raise AssertionError(f"{BENCH_PATH} stap engines "
                             f"{st['stage_engines']}")
    print(f"{BENCH_PATH} occam_stap vgg_stap 64x64, {st['batch']} images: "
          f"cuts {st['boundaries']}, replicas {st['replicas_stap']}; "
          f"us/image single device {st['us_per_image_single_device']}, "
          f"pipeline {st['us_per_image_pipeline']}, STAP "
          f"{st['us_per_image_stap']}; measured over predicted pipeline "
          f"{st['pipeline_thr_measured_over_predicted']}, STAP "
          f"{st['stap_thr_measured_over_predicted']} (attempts "
          f"{st['attempt_max_deviations']}); host_parallel_scaling "
          f"{st['host_parallel_scaling']}; stage ms solo "
          f"{st['stage_times_solo_ms']}, deployed "
          f"{st['stage_times_deployed_ms']}, kernel over scan "
          f"{st['stage_body_cuda_kernel_over_scan']}; max|err| vs oracle "
          f"{errs}")

    sv, asy = docs["serve"], docs["async"]
    counts = [sv["session_compile_count"], asy["engine_compile_count"],
              *(p["engine_compile_count"] for p in asy["poisson"]),
              docs["calibrate"]["session_compile_count"]]
    if counts != [1] * len(counts):
        raise AssertionError(f"{BENCH_PATH}: build counts {counts}")
    if not (sv["matches_prediction"] and asy["matches_prediction"]):
        raise AssertionError(f"{BENCH_PATH}: serving traffic does not "
                             f"match the prediction")
    print(f"{BENCH_PATH} occam_serve: {sv['images_per_s_measured']} "
          f"images/s against {sv['images_per_s_predicted_deployed']} "
          f"predicted, measured over predicted "
          f"{sv['serve_thr_measured_over_predicted']} (windows "
          f"{sv['window_ratios']}, predicted over measured), round_batch "
          f"{sv['round_batch']}, 1 build, matches_prediction True")
    print(f"{BENCH_PATH} occam_async: {asy['images_per_s_measured']} "
          f"images/s against {asy['images_per_s_predicted_deployed']} "
          f"predicted, measured over predicted "
          f"{asy['async_thr_measured_over_predicted']} (windows "
          f"{asy['window_ratios']}), packs overlapped "
          f"{asy['packs_overlapped']}; Poisson "
          f"{[(p['rate_frac'], p['achieved_images_per_s'], p['latency_p50_ms'], p['latency_p99_ms']) for p in asy['poisson']]}"
          f" (fraction, images/s, p50 ms, p99 ms)")

    qt, cal = docs["quant"], docs["calibrate"]
    occam_quant.validate_doc(qt)
    occam_calibrate.validate_doc(cal)
    if qt["execution"]["payload_bytes_per_elem"] != 1.0:
        raise AssertionError(f"{BENCH_PATH} quant payload "
                             f"{qt['execution']['payload_bytes_per_elem']} "
                             f"bytes an element")
    ex = qt["execution"]
    print(f"{BENCH_PATH} occam_quant: bytes_reduction_int8 "
          f"{qt['bytes_reduction_int8']}, matches_prediction_bytes True, "
          f"link bytes {ex['link_bytes_per_image_fp32']} -> "
          f"{ex['link_bytes_per_image_int8']} an image, max|int8 - fp32| "
          f"{ex['max_abs_err_int8']:.4f} (tolerance {ex['tolerance']})")
    print(f"{BENCH_PATH} occam_calibrate: replicas {cal['replicas']} "
          f"({cal['packing']}), measured {cal['measured_period_us']} us an "
          f"image, analytic {cal['analytic_period_us']}, calibrated "
          f"{cal['calibrated_period_us']} (calibrated over measured "
          f"{cal['calibrated_over_measured']}); miss analytic "
          f"{cal['analytic_miss_factor']}, calibrated "
          f"{cal['calibrated_miss_factor']}; error_improvement "
          f"{cal['error_improvement']}, winner_changed "
          f"{cal['winner_changed']}")
    ap = docs["autoplan"]
    if not ap["all_match_exhaustive"]:
        raise AssertionError(f"{BENCH_PATH}: autoplan diverged")
    print(f"{BENCH_PATH} derived: {derived}")

    # vgg_mini's spans at batch 1: kernel vs plain, timed as in phase 4
    net = tables._vgg_mini(32)
    res = partition_cnn(net, 24 * 1024)
    params = cnn.init_params(common.generator(0), net, device=dev)
    x = common.images((1, 32, 32, 3), 1, dev)
    maps = cnn.reference_forward(params, x, net, collect=True)
    rec = new_record()
    rec["launches"] = total
    for route in span_engine.plan_routes(net, res):
        a, b = route.start, route.end
        spill = span_engine.span_spills(net, res.boundaries, a, b)
        kw = dict(srcs={s: maps[s] for s in crossing_source_keys(net, a, b)},
                  spill=spill)
        got, _ = kernel.span_cuda_call(maps[a], params[a:b], net, a, b, **kw)
        want, _ = span_plain_call(maps[a], params[a:b], net, a, b, **kw)
        err, _ = compare(f"{BENCH_PATH} vgg_mini span ({a}, {b})", got,
                         want, 1e-4, 1e-4)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        time_span(BENCH_PATH, net, params, maps[a], a, b, kw, rec)
    print(f"phase 20 ({BENCH_PATH}): {time.perf_counter() - t_phase:.1f} s "
          f"(host clock)")
    return rec


def roofline_phase(cells) -> None:
    """Phase 20's roofline twin, after the sweep: the records the sweep
    wrote, each cell's compute term and model FLOPs, the missing terms
    ``None`` with their reasons."""
    from repro_torch.benchmarks import roofline

    rows = [r for r in roofline.load_rows(mesh="16x16")
            if (r["arch"], r["shape"]) in cells]
    if len(rows) != len(cells):
        raise AssertionError(f"{BENCH_PATH} roofline: rows for "
                             f"{[(r['arch'], r['shape']) for r in rows]}, "
                             f"cells {cells}")
    for r in rows:
        if not (r["t_compute_s"] > 0 and r["model_flops_per_dev"] > 0) or \
                any(r[k] is not None or not r["reasons"][k]
                    for k in ("t_memory_s", "t_collective_s", "dominant",
                              "roofline_fraction")):
            raise AssertionError(f"{BENCH_PATH} roofline row {r}")
    print(f"{BENCH_PATH} roofline over the sweep's records (16x16, "
          f"{len(rows)} cells; memory and collective terms None: "
          f"{rows[0]['reasons']['roofline_fraction']}):")
    print(roofline.fmt_table(rows))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # phase 15's deterministic cuBLAS needs this before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    gc.collect()  # the Mamba path's tensors go before OLMoE's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_err = flash_new_shapes(torch, args.seed, compare)
    olmoe_rec, olmoe = routed_serving(
        torch, args.seed, compare, OLMOE_PATH, "olmoe-1b-7b",
        (16, 0, 2048, 16, 16, 128, 0, 50304, (64, 8, 1024)), OLMOE_PARAMS,
        OLMOE_CALLS, flash_err[OLMOE_PATH])
    ep_rec = ep_phase(torch, args.seed, compare, dev, *olmoe)
    del olmoe
    gc.collect()  # OLMoE's tensors go before SeamlessM4T's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seamless_rec, _ = routed_serving(
        torch, args.seed, compare, SEAMLESS_PATH, "seamless-m4t-large-v2",
        (24, 24, 1024, 16, 16, 64, 8192, 256206, None), SEAMLESS_PARAMS,
        SEAMLESS_CALLS, flash_err[SEAMLESS_PATH])
    gc.collect()  # SeamlessM4T's tensors go before training's
    torch.cuda.empty_cache()
    smoke_train_steps(torch, args.seed, compare)
    gc.collect()
    torch.cuda.empty_cache()
    train_rec = training_phase(torch, args.seed, compare)
    gc.collect()  # training's tensors go before the pipeline's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe_rec = pipeline_phase(torch, args.seed, compare, dev)
    gc.collect()  # the pipeline's tensors go before the dry run's
    torch.cuda.empty_cache()
    dry_recs = dryrun_phase(torch, args.seed, compare, dev)
    gc.collect()
    torch.cuda.empty_cache()
    span_rec, *example_recs = examples_phase(torch, compare, time_span)
    paths[EXAMPLES_PATH] = span_rec
    gc.collect()
    torch.cuda.empty_cache()
    paths[BENCH_PATH] = benchmarks_phase(torch, compare, time_span, dev)
    cells = sweep_phase()
    roofline_phase(cells)

    # fused-span times: one batch-8 run of ResNet-18's five spans, one
    # batch-4 run of AlexNet's span, one batch-8 run of each policy plan's
    # spans; a session's ms is one replayed round of 8 (its other times are
    # its deployment's spans'); the frontier's: its seven new spans at
    # batch 8; the calibration's: the profile's stage sum at microbatch 1
    # beside those spans' other times; the STAP pipeline's: its spans,
    # each timed over the run's 16 microbatches of 2 (its 80 launches);
    # the async engine's: one round's spans at batch 8, and the ring
    # engine's: one slot's spans at microbatch 2, each span one call;
    # launches: each path's counted run; the benchmarks path's: vgg_mini's
    # three spans at batch 1 beside every launch of the harness and the
    # smoke pass. Flash on the pipeline path: one run's 128 calls timed,
    # launches of both runs (128 each)
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
    } for name, rec in paths.items()] + [flash_rec, ssd_rec, olmoe_rec,
                                         ep_rec, seamless_rec, train_rec,
                                         pipe_rec, *dry_recs,
                                         *example_recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
