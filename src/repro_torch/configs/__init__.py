"""Architecture registry: ``get_config(arch)`` / ``get_smoke(arch)``.

Ten assigned LM architectures + the paper's own CNN zoo (repro.models.zoo).
"""
from __future__ import annotations

import importlib

from .base import SHAPE_GRID, ModelCfg, MoECfg, ShapeCfg, SSMCfg, applicable_shapes

_ARCH_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen2.5-14b": "qwen2_5_14b",
    "minitron-4b": "minitron_4b",
    "llama3.2-1b": "llama3_2_1b",
    "internlm2-1.8b": "internlm2_1_8b",
}

ARCHS = tuple(_ARCH_MODULES)


def _module(arch: str):
    try:
        mod = _ARCH_MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str) -> ModelCfg:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelCfg:
    return _module(arch).SMOKE


__all__ = ["ARCHS", "SHAPE_GRID", "ModelCfg", "MoECfg", "SSMCfg", "ShapeCfg",
           "applicable_shapes", "get_config", "get_smoke"]
