"""InternLM2-1.8B [arXiv:2403.17297; hf]."""
from .base import ModelCfg

CONFIG = ModelCfg(
    name="internlm2-1.8b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=92544,
)

SMOKE = ModelCfg(
    name="internlm2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
)
