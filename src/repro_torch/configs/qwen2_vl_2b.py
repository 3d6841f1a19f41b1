"""Qwen2-VL-2B backbone [arXiv:2409.12191; hf].

28L dense decoder with M-RoPE (temporal/height/width sections 16/24/24 over
d_head=128 -> rotary half 64 = 16+24+24) and QKV bias. The vision patch
frontend is a STUB per the assignment: ``input_specs`` provides precomputed
patch embeddings + 3D position ids.
"""
from .base import ModelCfg

CONFIG = ModelCfg(
    name="qwen2-vl-2b",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab=151936,
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ModelCfg(
    name="qwen2vl-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    mrope_sections=(2, 3, 3),
    qkv_bias=True,
)
