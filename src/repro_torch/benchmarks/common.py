"""What the benchmark twins share: the device they run on, the clock
they read, and where their documents go.

The reference's benchmarks time emulated CPU devices with the host clock
around ``jax.block_until_ready``; here a GPU's work is asynchronous, so
every timed call ends in ``torch.cuda.synchronize`` (:func:`block`)
before the clock is read, and stage bodies are timed between CUDA events
(:func:`time_call`), as ``occam.calibrate.timers`` times them.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
RESULTS = ROOT / "results"


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means ``cuda:0``; raises when no GPU is visible."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the benchmarks run on the GPU by default, and no CUDA "
                "device is visible; pass device=\"cpu\" (--device cpu) to "
                "run them on the CPU")
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def device_block(dev: torch.device) -> dict | str:
    """What a measured document ran on: the card's name and power limit
    as ``nvidia-smi --query-gpu=name,power.limit`` gives them, or
    ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index)],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip()
        name, limit = (s.strip() for s in line.rsplit(",", 1))
    except (OSError, subprocess.SubprocessError, ValueError):
        name, limit = torch.cuda.get_device_name(dev), None
    return {"name": name, "power_limit": limit,
            "torch_name": torch.cuda.get_device_name(dev)}


def full_fp32() -> None:
    """TF32 off for cuDNN and for matmuls: the oracle and the plain
    versions compute in full fp32, as the outputs held against them do."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def block(dev: torch.device) -> None:
    """Wait for the device's queued work (the GPU's launches return
    before the work is done)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_call(fn, dev: torch.device) -> float:
    """Seconds of one call of ``fn``: between two CUDA events on the
    current stream on the GPU (the device idles while the host issues,
    so the host's issue counts too), by the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def images(shape, seed: int, dev: torch.device) -> torch.Tensor:
    """Standard normal images drawn on the host from ``seed``."""
    return torch.randn(shape, generator=generator(seed)).to(dev)


def out_path(name: str, out_json: str | os.PathLike | None = None) -> Path:
    """``out_json``, or ``results/BENCH_torch_<name>.json``."""
    return Path(out_json) if out_json is not None \
        else RESULTS / f"BENCH_torch_{name}.json"


def write_doc(path: Path, doc: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
