"""Roofline assembly for the port's dry run, the twin of
``benchmarks/roofline.py``: per (arch x shape x mesh) record in
``results/torch_dryrun/*.json`` (``repro_torch.launch.dryrun``).

    compute term    = FLOPs per position / peak FLOP/s
    memory term     = bytes accessed / HBM bandwidth: None, the records
                      carry no bytes accessed
    collective term = None, the records carry no collectives

plus MODEL_FLOPS (the reference's analytic 6·N_active·D & friends,
:func:`model_flops_global`) and its ratio to the records' own count.
The port's records hold ``bytes_accessed`` and
``collectives_per_device`` as ``None``: eager PyTorch has no HLO to walk
and no SPMD partitioner (the reasons are the records' ``notes``). So
``t_memory_s``, ``t_collective_s``, ``dominant`` and
``roofline_fraction`` are ``None`` with those reasons: a compute-only
fraction is not a roofline, and no estimate stands in for the missing
terms.

Hardware constants: NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit) — 989 TFLOP/s bf16, 3.35 TB/s HBM.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import SHAPE_GRID, get_config

from . import common

PEAK_FLOPS = 989e12
RESULT_DIR = str(common.ROOT / "results" / "torch_dryrun")


def model_flops_global(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs for the whole cell (all chips)."""
    cfg = get_config(arch)
    shape = SHAPE_GRID[shape_name]
    b, s = shape.global_batch, shape.seq_len
    n_act = cfg.param_count()[1]
    n_attn = (cfg.n_layers // cfg.period) * len(cfg.attn_every)
    if cfg.is_enc_dec:
        n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    n_ssm = (cfg.n_layers // cfg.period) * len(cfg.ssm_every)

    def attn_fwd(tokens_q, tokens_kv, causal):
        f = 4.0 * tokens_q * tokens_kv * cfg.n_heads * cfg.d_head / max(b, 1)
        return f * (0.5 if causal else 1.0)

    def ssd_fwd(tokens):
        """Chunked SSD: per token ~ 2(Q·N_total [scores] + Q·H·P [apply]
        + 2·H·N·P [state update/read])."""
        if cfg.ssm is None:
            return 0.0
        q = cfg.ssm.chunk
        h = cfg.ssm.n_ssm_heads(cfg.d_model)
        n = cfg.ssm.d_state
        p = cfg.ssm.head_dim
        per_tok = 2.0 * (q * n * cfg.ssm.n_groups + q * h * p
                         + 2 * h * n * p)
        return tokens * per_tok

    if shape.kind == "train":
        toks = b * s
        f = 6.0 * n_act * toks
        f += 3.0 * n_attn * b * attn_fwd(s, s, True)
        f += 3.0 * n_ssm * ssd_fwd(toks)
        return f
    if shape.kind == "prefill":
        toks = b * s
        f = 2.0 * n_act * toks
        f += n_attn * b * attn_fwd(s, s, True)
        f += n_ssm * ssd_fwd(toks)
        return f
    # decode: one token per sequence against an s-long cache
    f = 2.0 * n_act * b
    f += n_attn * 4.0 * b * s * cfg.n_kv_heads * cfg.d_head  # cache reads
    if cfg.ssm is not None:
        h = cfg.ssm.n_ssm_heads(cfg.d_model)
        f += n_ssm * 4.0 * b * h * cfg.ssm.d_state * cfg.ssm.head_dim
    return f


def roofline_row(record: dict) -> dict:
    """One record's terms. The compute term is the record's own FLOP
    count per position over the bf16 peak; the terms whose inputs the
    record lacks are ``None``, with the record's reason in ``reasons``."""
    arch, shape = record["arch"], record["shape"]
    chips = record["n_chips"]
    cost = record["cost_per_device"]
    flops_dev = cost["flops"]
    if cost["bytes_accessed"] is not None or \
            record["collectives_per_device"] is not None:
        raise ValueError(f"{arch} {shape}: the port's dry run counts no "
                         f"bytes accessed and no collectives, and this "
                         f"record holds some")
    notes = record.get("notes", {})
    reasons = {"t_memory_s": notes.get("bytes_accessed",
                                       "no bytes accessed in the record"),
               "t_collective_s": notes.get("collectives_per_device",
                                           "no collectives in the record")}
    reasons["dominant"] = reasons["roofline_fraction"] = (
        "needs the memory and collective terms, which the record lacks")
    mf = model_flops_global(arch, shape) / chips
    return {
        "arch": arch,
        "shape": shape,
        "mesh": record["mesh"],
        "t_compute_s": flops_dev / PEAK_FLOPS,
        "t_memory_s": None,
        "t_collective_s": None,
        "dominant": None,
        "model_flops_per_dev": mf,
        "counted_flops_per_dev": flops_dev,
        "model_over_counted": (mf / flops_dev) if flops_dev else 0.0,
        "roofline_fraction": None,
        "reasons": reasons,
        "mem_gib_per_dev":
            record["memory_per_device"]["peak_estimate_bytes"] / 2**30,
    }


def load_rows(result_dir: str = RESULT_DIR, mesh: str | None = "16x16"):
    rows = []
    for path in sorted(glob.glob(os.path.join(result_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if mesh and rec["mesh"] != mesh:
            continue
        rows.append(roofline_row(rec))
    return rows


def fmt_table(rows) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':8s} {'compute':>9s} "
           f"{'memory':>9s} {'collect':>9s} {'MODEL/cnt':>9s} "
           f"{'GiB/dev':>8s}")
    out = [hdr, "-" * len(hdr)]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        out.append(
            f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:8s} "
            f"{r['t_compute_s']*1e3:7.1f}ms {'n/a':>9s} {'n/a':>9s} "
            f"{r['model_over_counted']:9.2f} {r['mem_gib_per_dev']:8.2f}")
    return "\n".join(out)


if __name__ == "__main__":
    import sys

    mesh = sys.argv[1] if len(sys.argv) > 1 else "16x16"
    print(fmt_table(load_rows(mesh=mesh)))
