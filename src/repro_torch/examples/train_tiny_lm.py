"""End to end: train a ~100M-param llama-family model for a few
hundred steps on the synthetic permutation-LM stream, with checkpointing
and restart-recovery demonstrated mid-run; the twin of
``examples/train_tiny_lm.py``. It trains on the GPU unless ``--device
cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm [--steps 300]
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.launch import train as trainer


def tiny_100m():
    """~95M-param llama3.2 shrink (12 layers, d=768, vocab 2k)."""
    base = get_config("llama3.2-1b")
    return dataclasses.replace(
        base, name="llama-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_head=64, d_ff=2304, vocab=2048,
        tie_embeddings=False)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = tiny_100m()
    total, _ = cfg.param_count()
    print(f"model: {cfg.name} with {total/1e6:.0f}M params")

    ckpt_dir = tempfile.mkdtemp(prefix="tinylm_ckpt_")
    # patch the registry so the trainer sees our custom config; restored
    # after, since main may run inside a longer process
    smoke = trainer.get_smoke
    trainer.get_smoke = lambda _arch: cfg
    try:
        every = max(10, args.steps // 6)
        kw = dict(smoke=True, batch=args.batch, seq=args.seq,
                  ckpt_dir=ckpt_dir, ckpt_every=every, microbatches=2,
                  dtype=torch.float32, device=args.device)
        # phase 1: first half of training, checkpointing as we go
        _, losses1 = trainer.train("llama-100m", steps=args.steps // 2, **kw)
        # phase 2: simulate a node failure + restart — resumes from the
        # last committed checkpoint and continues to the full step count
        print("--- simulated failure; restarting from checkpoint ---")
        _, losses2 = trainer.train("llama-100m", steps=args.steps, **kw)
        print(f"loss: start {losses1[0]:.3f} -> mid {losses1[-1]:.3f} "
              f"-> final {losses2[-1]:.3f}")
        # progress bar scales with how long we were allowed to run; very
        # short smoke invocations only exercise the restart mechanics
        if args.steps >= 100:
            need = 0.5 if args.steps >= 250 else 0.1
            assert losses2[-1] < losses1[0] - need, \
                "training must make progress"
    finally:
        trainer.get_smoke = smoke
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"params": total, "losses_phase1": losses1,
            "losses_phase2": losses2}


if __name__ == "__main__":
    main()
