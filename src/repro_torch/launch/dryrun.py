"""Multi-pod dry run on the ``meta`` device: build every (architecture x
input shape) on the production meshes and count, per mesh position, what
it holds and what it computes; the port of ``repro/launch/dryrun.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \
        --shape train_4k [--multi-pod] [--out results/torch_dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

The reference lowers and compiles each cell with XLA on 512 placeholder
CPU devices and reads the compiled program's memory and cost analyses.
Eager PyTorch has no SPMD partitioner and no HLO, so the port builds the
cell of ``meta`` tensors (nothing is allocated) on a mesh of ``meta``
positions and fills the reference's record with three kinds of value,
each named in the record's ``notes``:

- exact: ``arguments_bytes`` and ``alias_bytes`` per position, from the
  resolved partition specs (a sharded dimension holds ``ceil(dim /
  positions along its axes)``, as XLA pads), and ``params_total`` /
  ``params_active`` from the config;
- the port's own count: ``flops`` (``FlopCounterMode`` over the cell's
  function run on ``meta`` at the global batch, ``flops_global``, spread
  evenly over the positions) and ``n_dots`` (its ``mm``/``bmm``/
  ``addmm``/``baddbmm`` calls);
- estimates: ``output_bytes`` and ``temp_bytes``, from the peak of live
  ``meta`` storage while one data position's share of the batch runs
  with the model axis unsharded (the port runs no tensor parallelism);
- ``None``: ``flops_xla_raw``, ``bytes_xla_raw``, ``bytes_accessed`` and
  ``collectives_per_device``, which need XLA's compiled program.

The reference's ``--save-hlo`` has no counterpart: there is no HLO to
save. The default ``--out`` is ``results/torch_dryrun``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCHS, SHAPE_GRID, ModelCfg, ShapeCfg,
                                 applicable_shapes, get_config)
from repro_torch.models.sharding import NamedSpec, use_shardings

from .mesh import make_production_mesh
from .specs import Cell, build_cell, make_ctx

DOTS = ("mm", "bmm", "addmm", "baddbmm")

NOTES = {
    "arguments_bytes": "exact: the shard on one position of every "
                       "argument leaf the function reads (jax.jit drops "
                       "the unread ones), ceil(dim / positions along its "
                       "axes) on a sharded dimension",
    "alias_bytes": "exact: the donated arguments (params and optimizer "
                   "state for train, the caches for decode), which the "
                   "port updates in place",
    "output_bytes": "estimate: the results one data position's call "
                    "allocates, plus alias_bytes (the donated arguments, "
                    "updated in place, are results as XLA counts them)",
    "temp_bytes": "estimate: the peak of live meta storage while one data "
                  "position's share of the batch runs, less the results "
                  "it allocates; the model axis is unsharded (the port "
                  "runs no tensor parallelism), so parameter-sized "
                  "temporaries such as gradients are whole",
    "flops": "the port's own count: FlopCounterMode over the cell's "
             "function on meta at the global batch (chunked attention and "
             "SSD twins, backward and checkpoint recomputation included; "
             "outside the sharding context, so an MoE layer takes its "
             "local path), flops_global, divided evenly over the "
             "positions",
    "n_dots": "the port's own count: mm/bmm/addmm/baddbmm calls in that run",
    "flops_xla_raw": "None: no XLA cost analysis in eager PyTorch",
    "bytes_xla_raw": "None: no XLA cost analysis in eager PyTorch",
    "bytes_accessed": "None: no HLO to walk for memory traffic",
    "collectives_per_device": "None: eager PyTorch has no SPMD partitioner "
                              "to insert collectives",
    "seconds_lower": "seconds to build the cell's meta stand-ins and specs",
    "seconds_compile": "None: eager PyTorch compiles nothing; "
                       "seconds_trace holds the meta runs' seconds",
}


# --------------------------------------------------------------------------
# Exact: bytes per position from the resolved specs
# --------------------------------------------------------------------------

def flat_leaves(tree, leaf_type) -> list:
    """The ``leaf_type`` leaves of a cell's argument (or sharding) tree in
    order: a module's parameters, dict values, list and tuple items."""
    if isinstance(tree, leaf_type):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in flat_leaves(sub, leaf_type)]
    raise TypeError(f"not a cell argument: {type(tree).__name__}")


def shard_bytes(t: torch.Tensor, named) -> int:
    """Bytes of ``t``'s shard on one position of ``named.mesh``."""
    spec = tuple(named.spec) + (None,) * (t.ndim - len(named.spec))
    sizes = named.mesh.shape
    n = 1
    for dim, entry in zip(t.shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n *= -(-dim // math.prod(sizes[a] for a in axes))
    return n * t.element_size()


def argument_bytes(cell: Cell, reads: set[int]) -> tuple[int, int]:
    """(arguments, donated arguments) bytes on one position, of the leaves
    the cell's function reads: ``reads`` holds the storages its operators
    took, and the arguments in ``cell.host_reads`` are read on the host.
    ``jax.jit`` drops the arguments its function never reads
    (``keep_unused=False``), such as an encoder-decoder's encoder
    weights in a decode step."""
    total = alias = 0
    for i, (arg, sh) in enumerate(zip(cell.args, cell.in_shardings)):
        leaves = flat_leaves(arg, torch.Tensor)
        specs = flat_leaves(sh, NamedSpec)
        if len(leaves) != len(specs):
            raise ValueError(f"argument {i}: {len(leaves)} leaves for "
                             f"{len(specs)} specs")
        b = sum(shard_bytes(t, s) for t, s in zip(leaves, specs)
                if i in cell.host_reads
                or t.untyped_storage()._cdata in reads)
        total += b
        alias += b if i in cell.donate_argnums else 0
    return total, alias


# --------------------------------------------------------------------------
# The port's own counts and estimates: the cell run on meta
# --------------------------------------------------------------------------

class Reads(TorchDispatchMode):
    """Counts the matrix-product calls (``DOTS``) that run under it and
    records the storages its operators read. A tensor read into a Python
    number (``_local_scalar_dense``) is a host read, which does not
    count: where it feeds the device the cell says so (``host_reads``)."""

    def __init__(self):
        super().__init__()
        self.n_dots = 0
        self.storages: set[int] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n_dots += name in DOTS
        if name != "_local_scalar_dense":
            self.storages.update(
                t.untyped_storage()._cdata
                for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor))
        return func(*args, **(kwargs or {}))


class LiveBytes(TorchDispatchMode):
    """Tracks the bytes of storage that operators allocate under it: each
    new storage counts from the op that returns it until it is freed
    (a finalizer on the storage). Storages of ``known`` tensors (the
    call's arguments) never count, even when an in-place op returns
    them."""

    def __init__(self, known=()):
        super().__init__()
        self.known = {t.untyped_storage()._cdata for t in known}
        self.sizes: dict[int, int] = {}
        self.live = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known or key in self.sizes:
                continue
            self.sizes[key] = st.nbytes()
            weakref.finalize(st, self._free, key)
            self.live += self.sizes[key]
            self.peak = max(self.peak, self.live)
        return out

    def new_bytes(self, tensors) -> int:
        """Bytes of the distinct live storages among ``tensors`` that were
        allocated under this mode."""
        keys = {t.untyped_storage()._cdata for t in tensors}
        return sum(self.sizes.get(k, 0) for k in keys)


def trace(cell: Cell) -> tuple[int, Reads]:
    """One run of the cell: its FLOPs, and what it read (``Reads``)."""
    reads = Reads()
    with FlopCounterMode(display=False) as flops, reads:
        cell.fn(*cell.args)
    return int(flops.get_total_flops()), reads


def peak_bytes(cell: Cell) -> tuple[int, int]:
    """(peak bytes allocated, bytes of the results it allocated) over one
    run of the cell, its arguments excluded."""
    mode = LiveBytes(flat_leaves(cell.args, torch.Tensor))
    with mode:
        out = cell.fn(*cell.args)
        new_results = mode.new_bytes(
            t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor))
    return mode.peak, new_results


def _position_share(shape: ShapeCfg, dp: int) -> ShapeCfg:
    """One data position's share of the batch (the whole batch when it
    does not divide: the reference then shards the cache sequence)."""
    if shape.global_batch % dp:
        return shape
    return ShapeCfg(shape.name, shape.seq_len, shape.global_batch // dp,
                    shape.kind)


def cell_record(cfg: ModelCfg, shape: ShapeCfg, ctx) -> dict:
    """The dry-run record of ``cfg`` at ``shape`` on ``ctx.mesh`` (its
    positions may be ``meta``; nothing is allocated)."""
    mesh = ctx.mesh
    t0 = time.perf_counter()
    with use_shardings(ctx):
        cell = build_cell(cfg, shape, ctx)
    t_build = time.perf_counter() - t0

    t0 = time.perf_counter()
    flops_global, reads = trace(cell)
    args_b, alias_b = argument_bytes(cell, reads.storages)
    dp = math.prod(mesh.shape[a] for a in ctx.data_axes)
    share = _position_share(shape, dp)
    local = cell if share is shape else build_cell(
        cfg, share, ctx, microbatches=cell.microbatches)
    peak, new_results = peak_bytes(local)
    t_trace = time.perf_counter() - t0

    n_pos = math.prod(mesh.shape.values())
    out_b = new_results + alias_b
    temp_b = peak - new_results
    total, active = cfg.param_count()
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "label": cell.label,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "n_chips": n_pos,
        "seconds_lower": round(t_build, 1),
        "seconds_compile": None,
        "seconds_trace": round(t_trace, 1),
        "params_total": total,
        "params_active": active,
        "memory_per_device": {
            "arguments_bytes": args_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "alias_bytes": alias_b,
            "peak_estimate_bytes": args_b + out_b + temp_b - alias_b,
        },
        "cost_per_device": {
            "flops_xla_raw": None,
            "bytes_xla_raw": None,
            "flops": flops_global / n_pos,
            "flops_global": flops_global,
            "bytes_accessed": None,
            "n_dots": reads.n_dots,
        },
        "collectives_per_device": None,
        "notes": dict(NOTES),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None) -> dict:
    """The record of one cell on the production mesh of ``meta``
    positions, written to ``out_dir`` when given."""
    cfg = get_config(arch)
    shape = SHAPE_GRID[shape_name]
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    record = cell_record(cfg, shape, make_ctx(mesh, multi_pod, shape))
    record["arch"] = arch
    record["mesh"] = "2x16x16" if multi_pod else "16x16"
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}__{shape_name}__{record['mesh']}".replace("/", "_")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(record, f, indent=2)
    return record


def _num(x, spec: str, unit: str = "") -> str:
    return "n/a" if x is None else f"{x:{spec}}{unit}"


def fmt(record: dict) -> str:
    m = record["memory_per_device"]
    c = record["cost_per_device"]
    k = record["collectives_per_device"]
    coll = None if k is None else k["total_bytes"]
    return (f"{record['label']:60s} mesh={record['mesh']:7s} "
            f"mem/dev={m['peak_estimate_bytes'] / 2**30:7.2f}GiB "
            f"flops/dev={_num(c['flops'], '.3e')} "
            f"bytes/dev={_num(c['bytes_accessed'], '.3e')} "
            f"coll/dev={_num(coll, '.3e', 'B')} "
            f"(compile {_num(record['seconds_compile'], '.0f', 's')}, "
            f"trace {record['seconds_trace']:.0f}s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPE_GRID))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCHS:
            for shape in applicable_shapes(get_config(arch)):
                cells.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    t0 = time.perf_counter()
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, mp, args.out)
                print(fmt(rec), flush=True)
            except Exception as e:  # noqa: BLE001 — report, keep sweeping
                failures.append((arch, shape, mp, repr(e)))
                print(f"FAIL {arch}/{shape} multi_pod={mp}: {e!r}",
                      flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        sys.exit(1)
    print(f"\nall dry-run cells built OK in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
