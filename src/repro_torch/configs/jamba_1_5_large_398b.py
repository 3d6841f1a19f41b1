"""Jamba-1.5-Large (398B total / ~94B active) [arXiv:2403.19887; hf].

72 layers, Mamba:attention 7:1 interleave (attention at in-period index 4,
one per 8-layer period), MoE (16 experts, top-2) on every other layer.
"""
from .base import ModelCfg, MoECfg, SSMCfg

CONFIG = ModelCfg(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab=65536,
    period=8,
    attn_every=(4,),
    ssm_every=(0, 1, 2, 3, 5, 6, 7),
    moe_every=(1, 3, 5, 7),
    moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMCfg(d_state=64, d_conv=4, expand=2, head_dim=64),
    rope_theta=1e4,
)

SMOKE = ModelCfg(
    name="jamba-smoke",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    period=8,
    attn_every=(4,),
    ssm_every=(0, 1, 2, 3, 5, 6, 7),
    moe_every=(1, 3, 5, 7),
    moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=128),
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
)
