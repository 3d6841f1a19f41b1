"""Admission-controlled request queue for the async serving engine.

Traffic-shaping policy lives *above* the fixed-shape SPMD program (cf.
Jung et al., arXiv:1806.06541 — partition the compute, shape the
traffic statistically in front of it): the queue decides what gets in
and how it packs; the compiled tick below never changes shape.

Backpressure is **per tenant**: each tenant may hold at most
``max_pending`` images in the engine (queued + in flight). A tenant
that floods gets :class:`AdmissionError` on its own submits while every
other tenant keeps being admitted — the global round packer then mixes
whoever is queued, FIFO, splitting requests across round boundaries
exactly like ``Session`` does.

Wall-clock aging generalizes the session's ``max_wait_ticks``: the
queue records each request's arrival time and reports how long its
oldest entry has waited, so the engine can flush a partial round once
the head request ages past ``max_wait_ms`` — a lone small request
completes under its latency SLO even while another tenant is being
backpressured.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import time


class AdmissionError(RuntimeError):
    """A tenant exceeded its ``max_pending`` budget; the submit was
    refused (other tenants are unaffected)."""

    def __init__(self, tenant: str, pending: int, images: int,
                 max_pending: int):
        self.tenant = tenant
        self.pending = pending
        self.images = images
        self.max_pending = max_pending
        super().__init__(
            f"tenant {tenant!r} holds {pending} pending images; admitting "
            f"{images} more would exceed max_pending={max_pending} "
            f"(await its tickets, then resubmit)")


@dataclasses.dataclass
class Request:
    """One admitted submit: the images, who sent them, when, and the
    future its ticket awaits."""

    uid: int
    tenant: str
    images: object                       # (B, H, W, C) array
    n: int
    arrived: float                       # clock() at admission
    future: asyncio.Future
    delivered: list = dataclasses.field(default_factory=list)
    remaining: int = 0
    cancelled: bool = False
    # time.time_ns() at admission and at the last pack of its images,
    # noted while torch.profiler records (occam.trace)
    admitted_ns: int | None = None
    staged_ns: int | None = None

    def __post_init__(self) -> None:
        self.remaining = self.n


class AdmissionQueue:
    """FIFO of admitted requests with per-tenant pending budgets.

    ``offer`` admits or raises :class:`AdmissionError`; ``take`` pops up
    to N images as ``(request, slice)`` segments (a request may straddle
    rounds); ``settle`` returns a tenant's budget once its images
    deliver; ``cancel`` withdraws a request's still-queued images so
    they never pack into a round and stop counting against the tenant's
    budget immediately. ``depth`` counts queued (not yet packed)
    images; ``pending(tenant)`` counts everything admitted and not yet
    delivered or cancelled — the quantity the budget bounds.
    """

    def __init__(self, *, max_pending: int = 64, clock=time.monotonic):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.max_pending = max_pending
        self.clock = clock
        self._queue: collections.deque = collections.deque()  # [req, offset]
        self._depth = 0
        self._pending: collections.Counter = collections.Counter()
        self._next_uid = 0
        self.rejections = 0
        self.cancellations = 0

    # -- admission -----------------------------------------------------------

    def pending(self, tenant: str) -> int:
        """Images this tenant has in the engine (queued + in flight)."""
        return self._pending[tenant]

    @property
    def depth(self) -> int:
        """Images queued, not yet packed into a round."""
        return self._depth

    @property
    def tenants(self) -> tuple[str, ...]:
        return tuple(t for t, n in self._pending.items() if n > 0)

    def offer(self, tenant: str, images, n: int,
              future: asyncio.Future) -> Request:
        held = self._pending[tenant]
        if held + n > self.max_pending:
            self.rejections += 1
            raise AdmissionError(tenant, held, n, self.max_pending)
        req = Request(self._next_uid, tenant, images, n,
                      arrived=self.clock(), future=future)
        self._next_uid += 1
        self._pending[tenant] += n
        self._queue.append([req, 0])
        self._depth += n
        return req

    def settle(self, request: Request, n: int) -> None:
        """Return ``n`` delivered images to ``request.tenant``'s budget."""
        self._pending[request.tenant] -= n

    def cancel(self, request: Request) -> int:
        """Withdraw ``request``'s queued (not yet packed) images: its
        queue entry is removed, the tenant's budget is credited for them
        immediately, and the request's ``remaining`` drops by the same
        count. Images already packed into a round stay in flight — they
        settle as they deliver. Returns how many images were withdrawn
        from the queue."""
        removed = 0
        for i, entry in enumerate(self._queue):
            if entry[0] is request:
                removed = request.n - entry[1]
                del self._queue[i]
                break
        if removed:
            self._depth -= removed
            self._pending[request.tenant] -= removed
            request.remaining -= removed
        self.cancellations += 1
        return removed

    # -- packing -------------------------------------------------------------

    def oldest_wait(self, now: float | None = None) -> float | None:
        """Seconds the head request has been queued (``None`` if empty) —
        the quantity ``max_wait_ms`` bounds."""
        if not self._queue:
            return None
        now = self.clock() if now is None else now
        return now - self._queue[0][0].arrived

    def take(self, n_images: int) -> list[tuple[Request, object, int]]:
        """Pop up to ``n_images`` queued images, FIFO, splitting requests
        across round boundaries: ``[(request, lanes, take), ...]``."""
        segs: list[tuple[Request, object, int]] = []
        n = 0
        while self._queue and n < n_images:
            entry = self._queue[0]
            req, off = entry
            take = min(req.n - off, n_images - n)
            segs.append((req, req.images[off:off + take], take))
            n += take
            if off + take == req.n:
                self._queue.popleft()
            else:
                entry[1] = off + take
        self._depth -= n
        return segs
