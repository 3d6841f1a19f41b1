"""Mamba2-1.3B [arXiv:2405.21060]: attention-free SSD stack.

48L, d_model 2048 (d_inner 4096, 64 SSD heads of dim 64), d_state 128,
vocab 50280 (padded to 50288 for 16-way TP).
"""
from .base import ModelCfg, SSMCfg

CONFIG = ModelCfg(
    name="mamba2-1.3b",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab=50280,
    period=1,
    attn_every=(),
    ssm_every=(0,),
    ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64),
    tie_embeddings=True,
)

SMOKE = ModelCfg(
    name="mamba2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab=256,
    period=1,
    attn_every=(),
    ssm_every=(0,),
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    tie_embeddings=True,
)
