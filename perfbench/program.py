"""The system under test, as the benchmark reaches it: ``repro_torch``'s
normal path, plan -> place -> compile -> ``Deployment.serve`` (a
``Session``, one CUDA graph per ``round_batch``) or ``AsyncEngine``.

Everything the harness takes from the program goes through here. The
package is found under ``src/`` of the checkout; a checkout without it
cannot run the benchmark.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class ProgramMissing(RuntimeError):
    """The program's package is not in this checkout."""


def _import():
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    try:
        from repro_torch import occam
        from repro_torch.core.graph import chain
        from repro_torch.occam.serve.engine import AsyncEngine
        from repro_torch.occam.serve.queue import AdmissionError
    except ImportError as e:
        raise ProgramMissing(
            f"the program's package repro_torch is not importable from "
            f"{src}: {e}") from e
    return occam, chain, AsyncEngine, AdmissionError


def build_kernels(device) -> None:
    """Build (or find already built) the program's CUDA kernels."""
    _import()
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()


def deploy(config: dict, device):
    """The configuration's net planned at its capacity, placed and compiled
    on ``device``."""
    occam, chain, _engine, _err = _import()
    net = chain(config["name"], [tuple(x) for x in config["layers"]],
                in_h=config["in_h"], in_w=config["in_w"],
                in_ch=config["in_ch"],
                residual_edges=[tuple(e) for e in config["residual_edges"]])
    plan = occam.plan(net, config["capacity_elems"])
    return plan.place().compile(device=device)


def session(dep, params, round_batch: int):
    return dep.serve(params, round_batch=round_batch)


def engine(dep, params, *, round_batch: int, max_wait_ms: float,
           max_pending: int):
    _occam, _chain, AsyncEngine, _err = _import()
    return AsyncEngine(dep, params, round_batch=round_batch,
                       max_wait_ms=max_wait_ms, max_pending=max_pending)


def admission_error():
    return _import()[3]

