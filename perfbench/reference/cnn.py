"""Plain PyTorch forward of a conv/pool body, from a configuration file.

This is what decides ``correct``. It imports nothing of the program and
takes nothing the program made: the harness hands it the same weights
(HWIO ``(k, k, Cin, Cout)`` and a bias per conv, as drawn from the seed)
and the same NHWC images it handed the program.

Semantics (those of the CNN bodies the OCCAM paper runs, with the
configuration's ``assumed`` choices):

* conv: zero padding, stride, bias, then ReLU;
* pool: max over the window, padding that never wins;
* residual edge ``(s, t)``: map ``s`` is added to map ``t`` after ``t``'s
  ReLU, through the parameter-free option-A shortcut (strided subsample,
  channels zero-padded or trimmed).

``precision="fp32"`` runs every conv in float32 with TF32 off. The
control, ``precision="tf32"``, rounds each conv's operands to TF32 (10
mantissa bits, to nearest, ties away from zero, as the tensor cores'
conversion does) and accumulates in float32: what a float32 conv run
with TF32 on computes, on any device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32")


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) with its mantissa rounded to TF32's 10 bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _shortcut(src: torch.Tensor, h: int, w: int, c: int) -> torch.Tensor:
    """Option A on an NCHW map: subsample by the ratio of heights, keep the
    first ``h`` x ``w`` positions, zero-pad or trim channels to ``c``."""
    sh = max(src.shape[2] // h, 1)
    sw = max(src.shape[3] // w, 1)
    y = src[:, :, ::sh, ::sw][:, :, :h, :w]
    if c > y.shape[1]:
        y = F.pad(y, (0, 0, 0, 0, 0, c - y.shape[1]))
    return y[:, :c]


def forward(config: dict, params: list[dict], xs: torch.Tensor,
            precision: str = "fp32") -> torch.Tensor:
    """``xs`` (B, H, W, C) -> the last map (B, H', W', C'), NHWC."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    edges = [tuple(e) for e in config["residual_edges"]]
    maps = [xs.permute(0, 3, 1, 2)]
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for idx, (kind, k, stride, padding, _out) in enumerate(
                config["layers"]):
            x = maps[-1]
            if kind == "conv":
                w = params[idx]["w"].permute(3, 2, 0, 1)
                if precision == "tf32":
                    x, w = round_to_tf32(x), round_to_tf32(w)
                y = F.conv2d(x, w, params[idx]["b"], stride=stride,
                             padding=padding)
                y = torch.relu(y)
            elif kind == "pool":
                y = F.max_pool2d(x, k, stride, padding)
            else:
                raise ValueError(f"layer {idx}: unknown kind {kind!r}")
            for s, t in edges:
                if t == idx + 1:
                    y = y + _shortcut(maps[s], y.shape[2], y.shape[3],
                                      y.shape[1])
            maps.append(y)
            # a map no later edge reads is not kept
            for m in range(len(maps) - 1):
                if maps[m] is not None and not any(
                        s == m and t > idx + 1 for s, t in edges):
                    maps[m] = None
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    return maps[-1].permute(0, 2, 3, 1).contiguous()
