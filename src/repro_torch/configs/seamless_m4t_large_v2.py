"""SeamlessM4T-Large v2 text backbone [arXiv:2308.11596; hf].

Encoder-decoder: 24 encoder + 24 decoder layers, d_model 1024, 16 heads
(MHA: kv=16), d_ff 8192, vocab 256206 (padded to 256208 for 16-way TP).
The speech/audio frontend is a STUB per the assignment: ``input_specs``
provides precomputed frame embeddings (B, S_enc, d_model).
"""
from .base import ModelCfg

CONFIG = ModelCfg(
    name="seamless-m4t-large-v2",
    n_layers=24,
    n_enc_layers=24,
    enc_frontend="stub_audio",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab=256206,
)

SMOKE = ModelCfg(
    name="seamless-smoke",
    n_layers=2,
    n_enc_layers=2,
    enc_frontend="stub_audio",
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=256,
)
