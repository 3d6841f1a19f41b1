"""Shared fixtures of the benchmark's CPU tests: a small residual net in
the configurations' format, and cells on it with the real traffic mixes."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from perfbench import bench, spec

HERE = Path(__file__).resolve().parent

# 16x16 input, a pool, a strided conv, three residual edges; at 4,096
# elements the plan cuts it at 4 and 6, so (5, 7) crosses a cut and map 5
# spills
TINY = {
    "name": "tiny", "dtype": "float32", "in_h": 16, "in_w": 16, "in_ch": 3,
    "capacity_elems": 4096, "reference": "cnn",
    "layers": [["conv", 3, 1, 1, 8], ["pool", 3, 2, 1, 8],
               ["conv", 3, 1, 1, 8], ["conv", 3, 1, 1, 8],
               ["conv", 3, 2, 1, 16], ["conv", 3, 1, 1, 16],
               ["conv", 3, 1, 1, 16]],
    "residual_edges": [[2, 4], [4, 6], [5, 7]],
}


@pytest.fixture
def one_thread():
    """The plain path is many small ops; parallel test workers and torch's
    intra-op threads slow each other down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tiny_cell(workload: str, config: dict = TINY) -> bench.Cell:
    """Cell ``workload``'s traffic and limits on the small net."""
    real = spec.cell(spec.load(), workload)
    traffic = dict(real.traffic, pool_images=16)
    return bench.Cell(workload, dict(config), traffic, real.limits)


def config(name: str) -> dict:
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
