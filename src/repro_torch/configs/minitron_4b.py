"""Minitron-4B (pruned Nemotron) [arXiv:2407.14679; hf]."""
from .base import ModelCfg

CONFIG = ModelCfg(
    name="minitron-4b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=9216,
    vocab=256000,
)

SMOKE = ModelCfg(
    name="minitron-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
)
