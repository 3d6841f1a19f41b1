"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L, 64 experts top-8, every layer MoE."""
from .base import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=0,  # no dense FFN: every layer routes
    vocab=50304,
    period=1,
    attn_every=(0,),
    moe_every=(0,),
    moe=MoECfg(n_experts=64, top_k=8, d_ff_expert=1024),
)

SMOKE = ModelCfg(
    name="olmoe-smoke",
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
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=64),
)
