"""The one traffic generator. A traffic mix is a data file,
``traffic/<name>.json``; a cell's ``workloads/<cell>.json`` may set or
override its parameters (an open loop's rate is the cell's own).

Parameters:

* ``loop``: ``"closed"`` (one client; a request waits for the reply to an
  earlier one) or ``"open"`` (requests are due on a schedule, whatever the
  system does).
* ``round_batch``: the session's fixed round shape.
* ``images_on``: ``"device"`` (the pool lives on the card, as images
  decoded there) or ``"host"`` (CPU tensors, as they arrive from clients).
* ``pool_images``: the images made from the seed; requests draw them in
  turn.
* closed loop: ``request_images`` per request, at most ``outstanding``
  requests in flight.
* open loop: ``rate_rps`` (requests per second, one request at each
  Poisson arrival), ``sizes`` and ``size_weights`` (images per request),
  ``tenants`` (in turn), ``max_wait_ms`` and ``max_pending`` of the
  engine.

Every seed gets the same work: an open loop's sizes are the weights'
exact quotas and its gaps the exponential distribution's quantiles, and
the seed only orders them. So two seeds differ in the order of arrivals
and in the images and weights, never in how much is asked.
"""
from __future__ import annotations

import dataclasses
import math
import random

LOOPS = ("closed", "open")
IMAGES_ON = ("device", "host")


@dataclasses.dataclass(frozen=True)
class Request:
    due_s: float        # offset from the window's start
    images: int
    tenant: int


def check(params: dict) -> dict:
    """Validate a traffic mix's parameters; return them."""
    if params.get("loop") not in LOOPS:
        raise ValueError(f"traffic loop {params.get('loop')!r} not in "
                         f"{LOOPS}")
    if params.get("images_on") not in IMAGES_ON:
        raise ValueError(f"traffic images_on {params.get('images_on')!r} "
                         f"not in {IMAGES_ON}")
    need = ["round_batch", "pool_images"]
    need += (["request_images", "outstanding"] if params["loop"] == "closed"
             else ["rate_rps", "sizes", "size_weights", "tenants",
                   "max_wait_ms", "max_pending"])
    missing = [k for k in need if params.get(k) is None]
    if missing:
        raise ValueError(f"traffic lacks {missing}")
    if params["loop"] == "open":
        sizes = params["sizes"]
        if (len(sizes) != len(params["size_weights"]) or min(sizes) < 1
                or max(sizes) > params["pool_images"]):
            raise ValueError("sizes and size_weights must pair up, each "
                             "size within 1 .. pool_images")
    elif params["request_images"] > params["pool_images"]:
        raise ValueError("request_images exceeds pool_images")
    return params


def quotas(weights: list[float], n: int) -> list[int]:
    """``n`` split in proportion to ``weights`` by largest remainder."""
    total = sum(weights)
    exact = [w * n / total for w in weights]
    out = [math.floor(x) for x in exact]
    order = sorted(range(len(weights)), key=lambda i: out[i] - exact[i])
    for i in order[:n - sum(out)]:
        out[i] += 1
    return out


def open_schedule(params: dict, seconds: float, seed: int) -> list[Request]:
    """The requests due in a window of ``seconds``, in due order: one at
    each Poisson arrival, ``rate_rps`` on average."""
    rng = random.Random(seed)
    n = max(1, round(params["rate_rps"] * seconds))
    sizes = [s for s, q in zip(params["sizes"],
                               quotas(params["size_weights"], n))
             for _ in range(q)]
    rng.shuffle(sizes)
    # the exponential distribution's quantiles, scaled so that the window
    # ends one mean gap after the last arrival
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    rng.shuffle(gaps)
    scale = seconds / (sum(gaps) + sum(gaps) / n)
    out, t = [], 0.0
    for i in range(n):
        t += gaps[i] * scale
        out.append(Request(t, sizes[i], i % params["tenants"]))
    return out


def pool_offsets(sizes, pool: int) -> list[int]:
    """Where each request's images start in the pool: requests take the
    pool's images in turn, wrapping around (the pool is stored with its
    head repeated after its end, so every request is one slice)."""
    out, off = [], 0
    for n in sizes:
        out.append(off)
        off = (off + n) % pool
    return out
