"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B]."""
from .base import ModelCfg

CONFIG = ModelCfg(
    name="llama3.2-1b",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_head=64,
    d_ff=8192,
    vocab=128256,
    rope_theta=5e5,
    tie_embeddings=True,
)

SMOKE = ModelCfg(
    name="llama32-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    tie_embeddings=True,
)
