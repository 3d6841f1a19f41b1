"""Production mesh construction, the port of ``repro/launch/mesh.py``.

A FUNCTION, not a module-level constant: importing this module touches
no device. The mesh is the port's ``DeviceMesh``: one controller over a
grid of positions, each a ``torch.device``, where a device may repeat.
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.runtime.stap_pipeline import (DeviceMesh, _grid,
                                               _mesh_devices)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence | None = None) -> DeviceMesh:
    """16x16 (one pod's 256 chips) or 2x16x16 (two pods, 512 chips).

    Axes: data = DP/FSDP/batch, model = TP/EP/SP; pod = the cross-pod
    data axis in the multi-pod mesh. ``devices`` fills the positions in
    row-major order (default: the visible CUDA devices; fewer than the
    mesh needs raises, naming ``devices=``).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = _mesh_devices(math.prod(shape), devices,
                         f"the production mesh {shape}")
    return DeviceMesh(_grid(devs, shape), axes)


def data_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)
