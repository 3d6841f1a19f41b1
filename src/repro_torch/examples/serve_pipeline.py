"""Serve a small LM with batched requests: prefill + decode through the
public API, reporting tokens/s — the serving-side runnable example, the
twin of ``examples/serve_pipeline.py``.

On the GPU the prefills run the CUDA flash-attention kernel (Llama,
OLMoE) and the CUDA SSD-scan kernel (Mamba2); ``--device cpu`` runs
their plain versions.

    PYTHONPATH=src python -m repro_torch.examples.serve_pipeline [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.serve import serve

ARCHS = ("llama3.2-1b", "mamba2-1.3b", "olmoe-1b-7b")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the models run (default: the GPU)")
    device = ap.parse_args(argv).device
    out = {}
    for arch in ARCHS:
        r = serve(arch, smoke=True, batch=4, prompt_len=32, gen=16,
                  device=device)
        print(f"{arch:16s} generated {tuple(r['tokens'].shape)} "
              f"prefill {r['prefill_s']*1e3:.0f}ms "
              f"decode {r['decode_tok_per_s']:.1f} tok/s")
        out[arch] = r
    print("serving OK")
    return out


if __name__ == "__main__":
    main()
