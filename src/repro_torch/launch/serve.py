"""Serving entry point: batched prefill + greedy decode loop, the port of
``repro/launch/serve.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 32 --gen 16

It runs on the GPU: prefill attention through the CUDA flash-attention
kernel (in an encoder-decoder, ``--arch seamless-m4t-large-v2``, the
encoder's, the decoder's and the cross-attention), and prefill's SSD scan
in Mamba layers through the CUDA SSD-scan kernel (``--arch
mamba2-1.3b``); MoE configs (``--arch olmoe-1b-7b``) route each token to
its top-k experts. ``serve(..., device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.models.api import ModelAPI, build_model, make_batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(api: ModelAPI, params, prompt: dict, gen: int) -> dict:
    """Answer one request: prefill ``prompt`` (a batch of ``tokens``
    (B, S) and, for M-RoPE, ``positions``; for an encoder-decoder,
    ``enc_embeds`` (B, S_enc, d_model)), then ``gen - 1`` greedy decode
    steps. Returns the ``gen`` new tokens per row (B, gen), the prefill's
    seconds and the decode loop's tokens per second, each read after the
    device finished its work."""
    batch, prompt_len = prompt["tokens"].shape
    s_max = prompt_len + gen
    _sync(api.device)
    t0 = time.perf_counter()
    logits, caches = api.prefill(params, prompt, s_max)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    _sync(api.device)
    t_prefill = time.perf_counter() - t0

    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = api.decode_step(params, tok, caches, prompt_len + i)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        out_tokens.append(tok)
    _sync(api.device)
    t_decode = time.perf_counter() - t0
    return {
        "tokens": torch.cat(out_tokens, dim=1),
        "prefill_s": t_prefill,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }


def serve(arch: str, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, seed: int = 0,
          dtype=torch.float32, greedy: bool = True, device=None) -> dict:
    """Init ``arch`` (its smoke config, or the full one with
    ``smoke=False``) from ``seed``, draw a prompt of ``batch`` x
    ``prompt_len`` tokens (and, for an encoder-decoder, as many frame
    embeddings), and :func:`generate` ``gen`` tokens greedily.
    ``device=None`` means the GPU."""
    if not greedy:
        raise NotImplementedError("only greedy decoding is implemented, as "
                                  "in the reference")
    cfg = get_smoke(arch) if smoke else get_config(arch)
    api = build_model(cfg, dtype=dtype, device=device)
    params = api.init(torch.Generator(api.device).manual_seed(seed))
    prompt = make_batch(cfg, batch, prompt_len,
                        generator=torch.Generator().manual_seed(1),
                        device=api.device, dtype=dtype)
    prompt.pop("labels", None)
    return generate(api, params, prompt, gen)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args()
    r = serve(args.arch, True, args.batch, args.prompt_len, args.gen)
    print(f"generated {tuple(r['tokens'].shape)} tokens; prefill "
          f"{r['prefill_s']:.2f}s; decode {r['decode_tok_per_s']:.1f} tok/s")


if __name__ == "__main__":
    main()
