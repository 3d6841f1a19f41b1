"""Layer-graph spec for Occam's partitioning / closure analysis.

The paper reasons about a CNN as a chain of feature maps ``L_0 .. L_n`` joined
by layers (conv / pool), optionally with residual edges.  Everything in
``repro.core`` operates on this spec; ``repro.models`` executes it in JAX.

Sizes are counted in *elements* (dtype-agnostic), exactly as the paper does
(§III-D: "independent of data format (e.g., FP32, FP16, INT8)").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer mapping feature map ``L_i`` -> ``L_{i+1}``.

    kind: "conv" (k x k x in_ch x out_ch weights) or "pool" (no weights).
    Spatial geometry is square-symmetric (h, w handled separately anyway).
    """

    name: str
    kind: str  # "conv" | "pool"
    k: int
    stride: int
    padding: int
    in_ch: int
    out_ch: int
    in_h: int
    in_w: int

    def __post_init__(self) -> None:
        if self.kind not in ("conv", "pool"):
            raise ValueError(f"bad layer kind {self.kind!r}")
        if self.kind == "pool" and self.in_ch != self.out_ch:
            raise ValueError("pool layers preserve channel count")

    @property
    def out_h(self) -> int:
        return (self.in_h + 2 * self.padding - self.k) // self.stride + 1

    @property
    def out_w(self) -> int:
        return (self.in_w + 2 * self.padding - self.k) // self.stride + 1

    @property
    def weight_elems(self) -> int:
        if self.kind != "conv":
            return 0
        return self.k * self.k * self.in_ch * self.out_ch

    @property
    def out_elems(self) -> int:
        return self.out_h * self.out_w * self.out_ch

    @property
    def in_elems(self) -> int:
        return self.in_h * self.in_w * self.in_ch

    @property
    def macs(self) -> int:
        """Multiply-accumulates to produce the full output map once."""
        if self.kind != "conv":
            return 0
        return self.out_h * self.out_w * self.out_ch * self.k * self.k * self.in_ch


@dataclasses.dataclass(frozen=True)
class NetSpec:
    """A chain of layers + residual edges ``(src_map, dst_map)``.

    ``residual_edges[(s, t)]`` means feature map ``L_s`` is added into ``L_t``
    (ResNet identity/projection shortcuts).  ``0 <= s < t <= n``.
    """

    name: str
    layers: tuple[LayerSpec, ...]
    residual_edges: tuple[tuple[int, int], ...] = ()

    def __post_init__(self) -> None:
        # Validate the chain: layer l's input geometry == map l geometry.
        for l in range(1, len(self.layers)):
            prev, cur = self.layers[l - 1], self.layers[l]
            if (prev.out_h, prev.out_w, prev.out_ch) != (
                cur.in_h,
                cur.in_w,
                cur.in_ch,
            ):
                raise ValueError(
                    f"{self.name}: layer {l} input "
                    f"{(cur.in_h, cur.in_w, cur.in_ch)} != layer {l-1} output "
                    f"{(prev.out_h, prev.out_w, prev.out_ch)}"
                )
        for s, t in self.residual_edges:
            if not (0 <= s < t <= self.n_layers):
                raise ValueError(f"bad residual edge ({s}, {t})")

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    # --- feature-map accessors (map index 0..n) -----------------------------
    def map_shape(self, i: int) -> tuple[int, int, int]:
        """(h, w, c) of feature map L_i."""
        if i == 0:
            l0 = self.layers[0]
            return (l0.in_h, l0.in_w, l0.in_ch)
        l = self.layers[i - 1]
        return (l.out_h, l.out_w, l.out_ch)

    def map_elems(self, i: int) -> int:
        h, w, c = self.map_shape(i)
        return h * w * c

    def span_weight_elems(self, i: int, j: int) -> int:
        """Sum of |W_l| for layers l in [i, j)."""
        return sum(l.weight_elems for l in self.layers[i:j])

    def total_weight_elems(self) -> int:
        return self.span_weight_elems(0, self.n_layers)

    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    def edges_crossing(self, p: int, lo: int = 0, hi: int | None = None) -> list[tuple[int, int]]:
        """Residual edges (s, t) with lo <= s < p < t <= hi."""
        hi = self.n_layers if hi is None else hi
        return [(s, t) for (s, t) in self.residual_edges if lo <= s < p < t <= hi]


# --------------------------------------------------------------------------
# Builders
# --------------------------------------------------------------------------

def conv(name: str, k: int, stride: int, padding: int, in_ch: int, out_ch: int,
         in_h: int, in_w: int) -> LayerSpec:
    return LayerSpec(name, "conv", k, stride, padding, in_ch, out_ch, in_h, in_w)


def pool(name: str, k: int, stride: int, in_ch: int, in_h: int, in_w: int,
         padding: int = 0) -> LayerSpec:
    return LayerSpec(name, "pool", k, stride, padding, in_ch, in_ch, in_h, in_w)


def chain(name: str, specs: Iterable[tuple], in_h: int, in_w: int, in_ch: int,
          residual_edges: Sequence[tuple[int, int]] = ()) -> NetSpec:
    """Build a NetSpec from (kind, k, stride, padding, out_ch) tuples.

    ``out_ch`` is ignored for pools. Geometry is threaded automatically.
    """
    layers: list[LayerSpec] = []
    h, w, c = in_h, in_w, in_ch
    for idx, (kind, k, stride, padding, out_ch) in enumerate(specs):
        if kind == "conv":
            l = conv(f"{name}.{idx}", k, stride, padding, c, out_ch, h, w)
        elif kind == "pool":
            l = pool(f"{name}.{idx}", k, stride, c, h, w, padding)
        else:
            raise ValueError(kind)
        layers.append(l)
        h, w, c = l.out_h, l.out_w, l.out_ch
    return NetSpec(name, tuple(layers), tuple(residual_edges))


# --------------------------------------------------------------------------
# Serialization (shipped inside deployment Plans — repro.occam)
# --------------------------------------------------------------------------

def net_to_dict(net: NetSpec) -> dict:
    """JSON-safe spec of the net: input geometry + per-layer chain tuples.

    Layer *names* are not preserved — ``net_from_dict`` rebuilds them with
    :func:`chain`'s ``{name}.{idx}`` scheme. Names carry no semantics
    (geometry and edges fully determine partitioning and execution)."""
    h, w, c = net.map_shape(0)
    return {
        "name": net.name,
        "in_h": h, "in_w": w, "in_ch": c,
        "layers": [[l.kind, l.k, l.stride, l.padding, l.out_ch]
                   for l in net.layers],
        "residual_edges": [list(e) for e in net.residual_edges],
    }


def net_from_dict(d: dict) -> NetSpec:
    return chain(d["name"], [tuple(s) for s in d["layers"]],
                 in_h=d["in_h"], in_w=d["in_w"], in_ch=d["in_ch"],
                 residual_edges=tuple((int(s), int(t))
                                      for (s, t) in d["residual_edges"]))
