"""Fault-tolerant checkpointing: atomic commit, async save, retention GC.
The port of ``repro/checkpoint/checkpointer.py``, with the same layout on
disk:

    <dir>/step_<k>.tmp/...      during write
    <dir>/step_<k>/leaf_<i>.npy one file per leaf
    <dir>/step_<k>/manifest.json tree description + shapes + dtypes + md5
    <dir>/step_<k>/COMMIT       written LAST -> a directory without COMMIT
                                is garbage from a crashed save and ignored

Restore picks the newest committed step and validates every leaf against
the manifest. A tree is a tensor, a module (its
``state_dict()`` tensors in order), an ``AdamWState`` (``m``, then
``v``, then ``count``), a tuple or list (its items in order) or a dict
(its values in sorted key order, as JAX flattens one). The training
state is ``(params, opt_state)``. A bfloat16 leaf is stored as its 16-bit
pattern with dtype ``bfloat16`` in the manifest.

``save_async`` copies every leaf from the device to the host before it
returns, because the next step updates the parameters in place; only the
disk I/O overlaps the next step. Leaves are written, hashed, read and
checked by a pool of threads (numpy's file I/O and ``hashlib`` release
the interpreter lock); ``COMMIT`` is still written after all of them.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import shutil

import numpy as np
import torch
from torch import nn

from repro_torch.optim.adamw import AdamWState

IO_THREADS = 8


def flatten(tree) -> list:
    """The leaves of ``tree`` in checkpoint order (see the module
    docstring). Tensor leaves are the tree's own tensors (a module's
    ``state_dict()`` tensors share its parameters' storage)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, AdamWState):
        return list(tree.m) + list(tree.v) + [tree.count]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in flatten(item)]
    raise TypeError(f"cannot flatten a {type(tree).__name__} into "
                    f"checkpoint leaves")


def describe(tree) -> str:
    """The tree's structure as text, for the manifest."""
    if isinstance(tree, torch.Tensor):
        return "*"
    if isinstance(tree, nn.Module):
        return f"{type(tree).__name__}({', '.join(tree.state_dict())})"
    if isinstance(tree, AdamWState):
        return f"AdamWState(m={len(tree.m)}, v={len(tree.v)}, count)"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "(" + ", ".join(describe(item) for item in tree) + ")"


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A host copy of ``leaf`` (a copy on the CPU too: the caller may
    change the tensor as soon as a save returns)."""
    leaf = leaf.detach()
    if leaf.dtype == torch.bfloat16:  # numpy has no bfloat16: its bits
        return leaf.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    return leaf.to("cpu", copy=True).numpy()


@dataclasses.dataclass
class Checkpointer:
    directory: str
    keep_n: int = 3

    def __post_init__(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: concurrent.futures.Future | None = None

    # -- save ----------------------------------------------------------------
    def _snapshot(self, tree):
        leaves = flatten(tree)
        host = [_to_host(leaf) for leaf in leaves]
        dtypes = [str(leaf.dtype).removeprefix("torch.") for leaf in leaves]
        return host, dtypes, describe(tree)

    def save(self, step: int, tree) -> None:
        self._write(step, *self._snapshot(tree))

    def save_async(self, step: int, tree) -> None:
        """Device->host copy happens now; disk IO overlaps the next step."""
        self.wait()
        snapshot = self._snapshot(tree)
        self._pending = self._pool.submit(self._write, step, *snapshot)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, leaves: list[np.ndarray],
               dtypes: list[str], treedef: str) -> None:
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def write_leaf(i):
            arr = leaves[i]
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            return {"shape": list(arr.shape), "dtype": dtypes[i],
                    "crc": _crc(arr)}

        with concurrent.futures.ThreadPoolExecutor(IO_THREADS) as ex:
            metas = list(ex.map(write_leaf, range(len(leaves))))
        manifest = {"step": step, "treedef": treedef, "leaves": metas}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    # -- restore ---------------------------------------------------------------
    def committed_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name, "COMMIT")):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def restore(self, like, step: int | None = None):
        """Restore into ``like``'s tensors, in place (validates
        congruence).

        Returns (step, like) or (None, like) when no committed checkpoint.
        """
        steps = self.committed_steps()
        if not steps:
            return None, like
        step = steps[-1] if step is None else step
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like = flatten(like)
        if len(manifest["leaves"]) != len(leaves_like):
            raise ValueError("checkpoint/model structure mismatch")

        def load_leaf(i):
            meta = manifest["leaves"][i]
            arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
            if list(arr.shape) != meta["shape"] or _crc(arr) != meta["crc"]:
                raise ValueError(f"leaf {i} corrupted")
            if tuple(arr.shape) != tuple(leaves_like[i].shape):
                raise ValueError(f"leaf {i}: checkpoint shape "
                                 f"{tuple(arr.shape)}, model shape "
                                 f"{tuple(leaves_like[i].shape)}")
            return arr

        with concurrent.futures.ThreadPoolExecutor(IO_THREADS) as ex:
            arrays = list(ex.map(load_leaf, range(len(leaves_like))))
        with torch.no_grad():
            for meta, arr, ref in zip(manifest["leaves"], arrays,
                                      leaves_like):
                if meta["dtype"] == "bfloat16":
                    ref.copy_(torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16))
                else:
                    ref.copy_(torch.from_numpy(arr))
        return step, like

    # -- retention -------------------------------------------------------------
    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)


def _crc(arr: np.ndarray) -> str:
    return hashlib.md5(np.ascontiguousarray(arr)).hexdigest()
