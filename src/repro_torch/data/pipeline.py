"""Deterministic synthetic data pipeline with background prefetch.

Tokens follow a learnable hidden-permutation process: token t+1 is
``perm[token t]`` with probability (1 - noise), else uniform — so a real
model's loss drops quickly below log(V) (used by the end-to-end example and
convergence tests), while remaining fully deterministic per (seed, step,
shard) for failure-recovery replay: after a restart at step k, batch k is
bit-identical (no data loss / duplication — the checkpoint stores only the
step counter).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    n_shards: int = 1
    shard: int = 0

    def __post_init__(self) -> None:
        if self.global_batch % self.n_shards:
            raise ValueError("global_batch must divide across shards")
        rng = np.random.default_rng(self.seed)
        self.perm = rng.permutation(self.vocab)

    @property
    def shard_batch(self) -> int:
        return self.global_batch // self.n_shards

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for (step, shard): {tokens, labels}."""
        rng = np.random.default_rng(
            (self.seed, step, self.shard, 0xD00D) if self.seed is not None
            else step)
        b, s = self.shard_batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b)
        flip = rng.random((b, s)) < self.noise
        rand = rng.integers(0, self.vocab, size=(b, s))
        for t in range(s):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(flip[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator (depth-bounded)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker() -> None:
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
