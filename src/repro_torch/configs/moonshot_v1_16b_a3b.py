"""Moonlight-16B-A3B (kimi/moonshot) [hf:moonshotai/Moonlight-16B-A3B].

48L, 64 experts top-6, every layer MoE, huge vocab (163840).
"""
from .base import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=0,
    vocab=163840,
    period=1,
    attn_every=(0,),
    moe_every=(0,),
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408),
)

SMOKE = ModelCfg(
    name="moonshot-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=0,
    vocab=256,
    period=1,
    attn_every=(0,),
    moe_every=(0,),
    moe=MoECfg(n_experts=8, top_k=3, d_ff_expert=64),
)
