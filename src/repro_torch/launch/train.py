"""The training loop: synthetic data -> microbatched train step -> async
checkpoints, with heartbeat/straggler hooks; the port of
``repro/launch/train.py`` on one device.

It runs on the GPU unless ``device="cpu"`` is asked for: the smoke
configs train end to end on either, and ``smoke=False`` trains a config
at its published width (Llama-3.2-1B fits one 80 GB card in fp32 with
AdamW). The loss runs the chunked attention and SSD twins under
per-layer checkpointing (``ModelAPI.train_loss``). Parameters are drawn
from ``seed`` with a ``torch.Generator`` on the device; a restart from a
checkpoint replays the same batches (``SyntheticLM`` is a function of
the step). The one host sync of a step is reading its loss, as in the
reference; the logged step time is read after it, so it covers the
device's work.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --steps 200 --batch 8 --seq 64

As in the reference, ``--smoke`` is a ``store_true`` flag that defaults
to true, so the command line always trains the smoke config; call
``train(arch, smoke=False, ...)`` for the full one.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime.elastic import HeartbeatMonitor, StragglerDetector

from .train_step import make_train_step


def train(arch: str, smoke: bool = True, steps: int = 100, batch: int = 8,
          seq: int = 64, lr: float = 3e-3, ckpt_dir: str | None = None,
          ckpt_every: int = 50, microbatches: int = 1, seed: int = 0,
          log_every: int = 10, dtype=torch.float32,
          total_steps: int | None = None, device=None):
    """Train ``arch`` for ``steps`` steps (resuming from the newest
    checkpoint in ``ckpt_dir``, saving one every ``ckpt_every`` steps).
    ``device=None`` means the GPU. Returns (params, losses): the model's
    module and the loss of each step this call ran."""
    cfg = get_smoke(arch) if smoke else get_config(arch)
    api = build_model(cfg, dtype=dtype, device=device)
    total = total_steps or steps  # schedule horizon survives early stops
    opt = AdamW(learning_rate=cosine_schedule(lr, total // 10, total),
                weight_decay=0.01)
    step_fn = make_train_step(api, opt, microbatches=microbatches)

    params = api.init(torch.Generator(api.device).manual_seed(seed))
    opt_state = opt.init(params)
    start_step = 0

    ck = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ck is not None:
        restored_step, _ = ck.restore((params, opt_state))
        if restored_step is not None:
            start_step = restored_step
            print(f"restored checkpoint at step {start_step}")

    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                     seed=seed)
    monitor = HeartbeatMonitor()
    stragglers = StragglerDetector()
    losses = []
    for step in range(start_step, steps):
        t0 = time.time()
        raw = ds.batch_at(step)
        b = {k: torch.from_numpy(raw[k]).to(api.device)
             for k in ("tokens", "labels")}
        if cfg.is_enc_dec:
            b["enc_embeds"] = torch.zeros((batch, seq, cfg.d_model),
                                          dtype=dtype, device=api.device)
        if microbatches > 1:
            b = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                              *v.shape[1:]) for k, v in b.items()}
        metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        dt = time.time() - t0
        monitor.beat(0, time.time())
        stragglers.record(0, dt)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({dt*1e3:.0f} ms/step)", flush=True)
        if ck is not None and (step + 1) % ckpt_every == 0:
            ck.save_async(step + 1, (params, opt_state))
    if ck is not None:
        ck.wait()
    return params, losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args()
    _, losses = train(args.arch, args.smoke, args.steps, args.batch,
                      args.seq, args.lr, args.ckpt_dir,
                      microbatches=args.microbatches)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
