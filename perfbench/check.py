"""How ``correct`` is decided: the outputs the client received for a sample
of the window's requests, drawn from the seed, against the plain
reference on the same images and weights.

The number compared is the worst relative gap over the sampled images:
for each image, max |program - reference| over its output map, divided by
max |reference| of that image. A request sampled and never answered, or
an answer that is not finite, fails the run outright.
"""
from __future__ import annotations

import dataclasses
import math
import random

import torch

# seeds the sampler apart from the traffic's and the weights' draws
_SAMPLE_SALT = 0x5A3F1E


class Reservoir:
    """A uniform sample of ``k`` of a stream whose length is not known in
    advance (Algorithm R), drawn from ``seed``: the same stream and seed
    keep the same items."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed ^ _SAMPLE_SALT)
        self.seen = 0
        self.items: dict[int, object] = {}   # slot -> item

    def wants(self) -> int | None:
        """The slot the next item of the stream goes to, or None; call once
        per item, then :meth:`put` if a slot came back."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        self.items[slot] = item

    def sample(self) -> list:
        return [self.items[s] for s in sorted(self.items)]


def sample_indices(n: int, k: int, seed: int, must=()) -> list[int]:
    """``k`` of ``range(n)`` drawn from ``seed``, with ``must`` in it."""
    rng = random.Random(seed ^ _SAMPLE_SALT)
    picked = set(must) | set(rng.sample(range(n), min(k, n)))
    return sorted(picked)


@dataclasses.dataclass
class Answer:
    """One sampled request: the pool images it carried and the outputs
    the client received for them (None: never received)."""

    pool_index: list[int]
    outputs: torch.Tensor | None


def worst_gap(answers: list[Answer], reference: torch.Tensor) -> float:
    """The number compared: the worst relative gap of any sampled image.
    ``reference`` holds the reference's output for every pool image."""
    worst = 0.0
    for ans in answers:
        want = reference[ans.pool_index].double()
        got = ans.outputs.to(want.device).double()
        if not bool(torch.isfinite(got).all()):
            return math.inf
        flat = (got - want).abs().flatten(1).amax(1)
        scale = want.abs().flatten(1).amax(1).clamp_min(1e-30)
        worst = max(worst, float((flat / scale).max()))
    return worst


def checks(answers: list[Answer], reference: torch.Tensor,
           limit: float) -> dict:
    """Every number compared, beside its limit, under a short plain name."""
    missing = sum(1 for a in answers if a.outputs is None)
    got = [a for a in answers if a.outputs is not None]
    return {
        "missing_answers": {"value": missing, "limit": 0},
        "sampled_requests": {"value": len(answers), "limit": 1},
        "worst_rel_gap": {"value": worst_gap(got, reference) if got
                          else math.inf, "limit": limit},
    }


def passed(result: dict) -> bool:
    c = result
    return (c["missing_answers"]["value"] <= c["missing_answers"]["limit"]
            and c["sampled_requests"]["value"]
            >= c["sampled_requests"]["limit"]
            and c["worst_rel_gap"]["value"] <= c["worst_rel_gap"]["limit"])
