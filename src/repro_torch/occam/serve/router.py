"""Multi-model front door: one fleet, many nets, one ``submit``.

The millions-of-users shape: a host owns ONE :class:`~repro.occam.Fleet`
and serves several networks from it, each planned into its own
:class:`~repro.occam.Frontier` (``occam.autoplan(net, fleet)``). The
:class:`Router` registers one :class:`~repro.occam.serve.AsyncEngine`
per model id — all frontiers must describe the *same* fleet, so chip
budgets mean the same thing across models — and dispatches
``submit(model, images, tenant=...)`` to the right engine. Tenancy is
per (model, tenant): a tenant flooding one model gets backpressured
there without touching its budget on another. Each engine autoscales
independently against its own frontier; the shared fleet is the common
currency its candidates spend chips in.
"""
from __future__ import annotations

from .engine import AsyncEngine, AsyncTicket

__all__ = ["Router"]


class Router:
    """Dispatches async submits to per-model engines over one shared
    fleet. Register models with :meth:`add`; then
    ``await router.submit("resnet", xs, tenant="alice")``."""

    def __init__(self):
        self._fleet = None
        self._engines: dict[str, AsyncEngine] = {}

    # -- registration --------------------------------------------------------

    def add(self, model: str, frontier, params, **engine_kw) -> AsyncEngine:
        """Register ``model``: deploy ``frontier``'s best candidate and
        open an engine on it (``engine_kw`` passes through to
        ``Frontier.serve`` — backend, SLO knobs, ``autoscale=...``).

        Every registered frontier must be planned over the SAME fleet;
        a mismatched one is refused, not silently mixed.
        """
        if model in self._engines:
            raise ValueError(f"model {model!r} is already registered")
        if self._fleet is None:
            self._fleet = frontier.fleet
        elif frontier.fleet != self._fleet:
            raise ValueError(
                f"frontier for {model!r} was planned over a different "
                f"fleet than this router serves ({frontier.fleet} != "
                f"{self._fleet}); one router routes one fleet")
        engine = frontier.serve(params, **engine_kw)
        self._engines[model] = engine
        return engine

    @property
    def models(self) -> tuple[str, ...]:
        return tuple(self._engines)

    @property
    def fleet(self):
        return self._fleet

    def engine(self, model: str) -> AsyncEngine:
        eng = self._engines.get(model)
        if eng is None:
            raise KeyError(f"unknown model {model!r} "
                           f"(registered: {sorted(self._engines)})")
        return eng

    # -- the front door ------------------------------------------------------

    async def submit(self, model: str, images, *,
                     tenant: str = "default") -> AsyncTicket:
        """Admit ``images`` for ``model`` -> awaitable ticket (raises
        ``KeyError`` on an unknown model, ``AdmissionError`` when the
        (model, tenant) budget is exhausted)."""
        return await self.engine(model).submit(images, tenant=tenant)

    async def drain(self) -> None:
        for eng in self._engines.values():
            await eng.drain()

    async def stop(self) -> None:
        for eng in self._engines.values():
            await eng.stop()

    async def __aenter__(self) -> "Router":
        for eng in self._engines.values():
            await eng.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def describe(self) -> dict:
        """Machine-readable router state: the shared fleet plus every
        model's engine description."""
        return {
            "models": sorted(self._engines),
            "fleet": None if self._fleet is None else self._fleet.to_dict(),
            "engines": {m: e.describe()
                        for m, e in self._engines.items()},
        }
