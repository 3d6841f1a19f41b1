"""Qwen2.5-14B [hf:Qwen/Qwen2.5-*]: dense GQA decoder with QKV bias."""
from .base import ModelCfg

CONFIG = ModelCfg(
    name="qwen2.5-14b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ModelCfg(
    name="qwen25-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
)
