"""The benchmark's own yardstick: the work one image costs and the peaks
it is held against.

The arithmetic is a frozen copy: a later change to the program cannot
move what a share of the peak means. It reads only a configuration's
layer list (``configs/<name>.json``), never the program.
"""
from __future__ import annotations

import dataclasses

# Why 165 TFLOP/s: the fastest rate at which an H100 SXM yields products
# as exact as fp32 is three TF32 passes on the tensor cores (3xTF32: the
# operands split into a high and a low TF32 part), 495 TFLOP/s dense TF32
# over 3. fp32 on the CUDA cores peaks lower (67 TFLOP/s), so no
# fp32-exact implementation can read over 100% of this peak, whatever
# units it runs on. (NVIDIA H100 SXM data sheet, dense, at 700 W.)
PEAK_FLOPS = 495e12 / 3
# HBM3 of the H100 SXM (data sheet).
PEAK_HBM_BYTES_PER_S = 3.35e12
BYTES_PER_ELEM = 4          # every configuration here is fp32


@dataclasses.dataclass(frozen=True)
class Layer:
    kind: str
    k: int
    stride: int
    padding: int
    in_h: int
    in_w: int
    in_ch: int
    out_ch: int

    @property
    def out_h(self) -> int:
        return (self.in_h + 2 * self.padding - self.k) // self.stride + 1

    @property
    def out_w(self) -> int:
        return (self.in_w + 2 * self.padding - self.k) // self.stride + 1


def layers(config: dict) -> list[Layer]:
    """The configuration's layers with their input geometry."""
    h, w, c = config["in_h"], config["in_w"], config["in_ch"]
    out = []
    for kind, k, stride, padding, out_ch in config["layers"]:
        out_ch = c if kind == "pool" else out_ch
        layer = Layer(kind, k, stride, padding, h, w, c, out_ch)
        out.append(layer)
        h, w, c = layer.out_h, layer.out_w, out_ch
    return out


def in_range_taps(n_out: int, n_in: int, k: int, stride: int,
                  pad: int) -> int:
    """(output position, tap) pairs along one axis whose input index lies
    inside [0, n_in): taps on the zero padding multiply nothing, so they
    are no work."""
    return sum(1 for r in range(n_out) for d in range(k)
               if 0 <= r * stride - pad + d < n_in)


def macs_per_image(config: dict) -> int:
    """Multiply-adds of one image: the in-range taps of every conv (pools
    and residual adds do none)."""
    total = 0
    for layer in layers(config):
        if layer.kind == "conv":
            rows = in_range_taps(layer.out_h, layer.in_h, layer.k,
                                 layer.stride, layer.padding)
            cols = in_range_taps(layer.out_w, layer.in_w, layer.k,
                                 layer.stride, layer.padding)
            total += rows * cols * layer.in_ch * layer.out_ch
    return total


@dataclasses.dataclass(frozen=True)
class Work:
    """What one image costs at full reuse: FLOPs, the bytes of its input
    read once and its output written once, and the weights' bytes, read
    once per round."""

    flops_per_image: float
    io_bytes_per_image: float
    weight_bytes: float

    def bound_s(self, images: float, rounds: float) -> float:
        """The least time the chip could take for ``images`` images in
        ``rounds`` rounds: operations or bytes, whichever is larger."""
        t_ops = images * self.flops_per_image / PEAK_FLOPS
        t_mem = (images * self.io_bytes_per_image
                 + rounds * self.weight_bytes) / PEAK_HBM_BYTES_PER_S
        return max(t_ops, t_mem)


def work(config: dict) -> Work:
    ls = layers(config)
    first, last = ls[0], ls[-1]
    io = (first.in_h * first.in_w * first.in_ch
          + last.out_h * last.out_w * last.out_ch)
    weights = sum(layer.k * layer.k * layer.in_ch * layer.out_ch
                  + layer.out_ch for layer in ls if layer.kind == "conv")
    return Work(2.0 * macs_per_image(config), io * BYTES_PER_ELEM,
                weights * BYTES_PER_ELEM)


def out_shape(config: dict) -> tuple[int, int, int]:
    last = layers(config)[-1]
    return last.out_h, last.out_w, last.out_ch
