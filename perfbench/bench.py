"""Drive one cell: set-up, the measured window, the traced slice, and the
comparison that decides ``correct``.

Set-up makes the weights and the image pool on the device from the seed,
plans and compiles the configuration, opens the cell's session or engine
(which captures the round's CUDA graph) and warms up the cell's own
traffic. The window then runs the traffic for ``seconds``. With tracing,
``torch.profiler`` runs across the window and the metrics read its
middle half (the slice); the harness marks its own calls into the
program with spans (``perfbench.*``). After the window the peak memory
is read, the program's state is freed, and the reference runs on the
pool.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import gc
import math
import time

import torch
from torch.autograd.profiler import record_function

from perfbench import check, generator, profile_reader, program, work
from perfbench.reference import cnn as reference

SLICE = (0.25, 0.75)        # the traced share of the window
SAMPLE_REQUESTS = 64        # answers compared, drawn from the seed
GRACE_S = 60.0              # how long answers due in the window are awaited
WARMUP_REQUESTS = 16        # closed loop: requests run in set-up
WARMUP_S = 1.0              # open loop: seconds of traffic run in set-up
HOST_THREADS = 4            # torch's intra-op threads: one process, few


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int = 1


@dataclasses.dataclass
class Slice:
    """What the harness counted inside the traced slice."""

    images: int             # outputs on the host inside the slice
    rounds: int


@dataclasses.dataclass
class Run:
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    images_done: int        # outputs on the host inside the window
    # per answered request, from when it was due (open loop) or submitted
    # (closed loop) to its outputs on the host
    latencies_s: list
    lateness_s: list        # open loop: submit minus due, per request
    work: work.Work
    answers: list
    memory_peak_bytes: int = 0
    engine: dict | None = None
    slice: Slice | None = None
    trace: profile_reader.Trace | None = None
    checks: dict = dataclasses.field(default_factory=dict)
    control_gap: float | None = None
    setup_parts: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return check.passed(self.checks)


def now() -> float:
    return time.perf_counter()


# -- inputs from the seed -------------------------------------------------

def make_params(config: dict, seed: int, device):
    """He-scaled weights and small biases, drawn on ``device`` in one call
    and cut into per-layer views (HWIO weights, NHWC convention); returned
    with the generator, which draws the images next."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    convs = [layer for layer in work.layers(config) if layer.kind == "conv"]
    total = sum(l.k * l.k * l.in_ch * l.out_ch + l.out_ch for l in convs)
    flat = torch.randn(total, generator=gen, device=device)
    params, off = [], 0
    for layer in work.layers(config):
        if layer.kind != "conv":
            params.append({})
            continue
        n = layer.k * layer.k * layer.in_ch * layer.out_ch
        w = flat[off:off + n].view(layer.k, layer.k, layer.in_ch,
                                   layer.out_ch)
        w.mul_(math.sqrt(2.0 / (layer.k * layer.k * layer.in_ch)))
        b = flat[off + n:off + n + layer.out_ch].mul_(0.01)
        params.append({"w": w, "b": b})
        off += n + layer.out_ch
    return params, gen


def make_pool(config: dict, traffic: dict, gen, device):
    """The pool of images, drawn on ``device`` after the weights; on the
    host for a host-side cell. Returned with its head repeated after its
    end, so a request of up to a pool's images is one slice."""
    n = traffic["pool_images"]
    pool = torch.randn((n, config["in_h"], config["in_w"], config["in_ch"]),
                       generator=gen, device=device)
    if traffic["images_on"] == "host":
        pool = pool.cpu()
    head = max(traffic.get("sizes") or [traffic.get("request_images", 1)])
    return torch.cat([pool, pool[:head]])


# -- the client's side: outputs to the host -----------------------------

class ToHost:
    """Copies answers into pinned host memory, each behind a CUDA event that
    times the copy's end on the device's clock, placed on the host's clock
    by a reference event recorded while the device is idle. The closed
    loop waits for each answer; the open loop never does, so the client
    neither blocks nor spins the event loop, and its answers' times are as
    exact as the device's timer. Buffers of answers already on the host are
    released as later ones are sent. On the CPU an answer is on the host
    when it is produced."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.done: dict[int, float] = {}
        self.kept: dict[int, torch.Tensor] = {}
        self._pending: collections.OrderedDict = collections.OrderedDict()
        if self.cuda:
            self._ref = torch.cuda.Event(enable_timing=True)
            self._ref.record()
            self._ref.synchronize()
            self._t_ref = now()

    def send(self, key: int, y: torch.Tensor, keep: bool) -> None:
        self._reap(None)
        with record_function("perfbench.to_host"):
            if self.cuda:
                buf = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                buf.copy_(y, non_blocking=True)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
            else:
                buf, ev = y.clone(), None
        self._pending[key] = (ev, buf, keep)

    def _reap(self, until: int | None) -> None:
        """Note every answer on the host, in the order they were sent
        (copies on one stream end in that order); with ``until``, wait
        until that answer is noted. Keys need not come in order: an open
        loop's answers arrive as the engine delivers them."""
        while self._pending:
            key, (ev, buf, keep) = next(iter(self._pending.items()))
            if ev is None:
                t = now()
            else:
                if until is not None and until in self._pending:
                    ev.synchronize()
                elif not ev.query():
                    return
                t = self._t_ref + self._ref.elapsed_time(ev) / 1e3
            del self._pending[key]
            self.done[key] = t
            if keep:
                # pageable: a pinned buffer kept would make a later answer
                # allocate a new one, and pinning memory stalls the host
                self.kept[key] = buf.clone()

    def wait_for(self, key: int) -> None:
        """Wait until answer ``key`` (and every one sent before it) is on
        the host."""
        self._reap(key)

    def finish(self) -> None:
        """Wait until every answer sent is on the host."""
        if self._pending:
            self._reap(next(reversed(self._pending)))


# -- tracing ----------------------------------------------------------------

class Tracer:
    """The profiler, on from just before the window to just after it, so
    that neither its start nor its stop stalls the window; the slice is
    the harness's marker span inside it."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self._mark = None
        self.t0 = self.t1 = None

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self, fn) -> None:
        """Run ``fn`` once under the profiler (set-up: the first profile of
        a process pays for the tracer's own start)."""
        with self._profile():
            fn()
            self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()

    def begin(self) -> None:
        self._mark = record_function(profile_reader.SLICE)
        self._mark.__enter__()
        self.t0 = now()

    def end(self) -> None:
        self.t1 = now()
        self._mark.__exit__(None, None, None)

    def stop(self) -> None:
        if self._mark is not None and self.t1 is None:
            self.end()
        self._sync()
        self.prof.stop()

    def reduce(self) -> profile_reader.Trace | None:
        if self.prof is None or self.t1 is None:
            return None
        return profile_reader.reduce(
            profile_reader.events_from_profiler(self.prof))


# -- the closed loop: one client on a Session ------------------------------

def closed_loop(sess, pool, tr: dict, seconds: float, device, *,
                sampler: check.Reservoir | None, tracer: Tracer | None,
                max_requests: int | None = None) -> dict:
    n, depth, size = tr["request_images"], tr["outstanding"], \
        tr["pool_images"]
    if tracer is not None:
        tracer.start()
    to_host = ToHost(device)
    inflight: collections.deque = collections.deque()
    submitted: dict[int, float] = {}
    i = 0
    t0 = now()
    t_end = t0 + seconds
    lo, hi = (t0 + SLICE[0] * seconds, t0 + SLICE[1] * seconds)

    def issue(i: int) -> None:
        off = (i * n) % size
        t_sub = now()
        with record_function("perfbench.submit"):
            sess.submit(pool[off:off + n])
        with record_function("perfbench.results"):
            done = sess.results(flush=False)
        if len(done) != 1:
            raise RuntimeError(f"a request of {n} images left {len(done)} "
                               f"answers in the session (round_batch must "
                               f"divide the request)")
        slot = sampler.wants() if sampler is not None else None
        if slot is not None:
            sampler.put(slot, (i, off))
        to_host.send(i, done[0][1], slot is not None)
        submitted[i] = t_sub
        inflight.append(i)

    def complete() -> None:
        j = inflight.popleft()
        with record_function("perfbench.wait"):
            to_host.wait_for(j)

    while True:
        if len(inflight) >= depth:
            complete()
        t = now()
        if t >= t_end or (max_requests is not None and i >= max_requests):
            break
        if tracer is not None:
            if tracer.t0 is None and t >= lo:
                tracer.begin()
            elif tracer.t0 is not None and tracer.t1 is None and t >= hi:
                tracer.end()
        issue(i)
        i += 1
    while inflight:
        complete()
    if tracer is not None:
        tracer.stop()
    done = to_host.done
    out = {
        "attempted": i,
        "failed": sum(1 for j in range(i) if j not in done),
        "images_done": n * sum(1 for t in done.values() if t <= t_end),
        "latencies_s": [done[j] - submitted[j] for j in range(i)
                        if j in done],
        "lateness_s": [],
        "window_s": seconds,
        "answers": [check.Answer([(off + k) % size for k in range(n)],
                                 to_host.kept.get(j))
                    for j, off in (sampler.sample() if sampler else [])],
    }
    if tracer is not None and tracer.t1 is not None:
        imgs = n * sum(1 for t in done.values()
                       if tracer.t0 <= t <= tracer.t1)
        out["slice"] = Slice(imgs, imgs // tr["round_batch"])
    return out


# -- the open loop: independent clients into the AsyncEngine --------------

async def open_loop(eng, pool, tr: dict, schedule: list, seconds: float,
                    device, *, sample: set, tracer: Tracer | None) -> dict:
    """Submit each request when it is due, whatever the engine does; time
    each from when it was due to when its outputs are on the host."""
    admission_error = program.admission_error()
    size = tr["pool_images"]
    offsets = generator.pool_offsets([r.images for r in schedule], size)
    if tracer is not None:
        tracer.start()
    to_host = ToHost(device)
    loop = asyncio.get_running_loop()
    tasks, lateness, refused = [], [], set()
    totals = {}

    async def collect(i: int, ticket) -> None:
        y = await ticket
        to_host.send(i, y, i in sample)

    async def trace_slice(t0: float) -> None:
        await asyncio.sleep(max(0.0, t0 + SLICE[0] * seconds - now()))
        tracer.begin()
        totals["slice0"] = eng.metrics.total_rounds
        await asyncio.sleep(max(0.0, t0 + SLICE[1] * seconds - now()))
        totals["slice1"] = eng.metrics.total_rounds
        tracer.end()

    m = eng.metrics
    totals["rounds0"], totals["done0"] = m.total_rounds, m.total_completions
    t0 = now()
    tracing = None
    if tracer is not None:
        tracing = loop.create_task(trace_slice(t0))
    for i, req in enumerate(schedule):
        due = t0 + req.due_s
        if due > now():
            await asyncio.sleep(due - now())
        lateness.append(now() - due)
        off = offsets[i]
        try:
            with record_function("perfbench.submit"):
                ticket = await eng.submit(pool[off:off + req.images],
                                          tenant=f"tenant{req.tenant}")
        except admission_error:
            refused.add(i)
            continue
        tasks.append((i, loop.create_task(collect(i, ticket))))
    t_end = t0 + seconds
    pending = [t for _i, t in tasks]
    if pending:
        await asyncio.wait(pending, timeout=max(0.0, t_end + GRACE_S - now()))
    if tracing is not None:
        await tracing
    for t in pending:
        if not t.done():
            t.cancel()
        elif t.exception() is not None:
            raise t.exception()
    to_host.finish()
    if tracer is not None:
        tracer.stop()
    await eng.drain()
    totals["rounds1"], totals["done1"] = m.total_rounds, m.total_completions
    done = to_host.done
    answered = [i for i, _t in tasks if i in done]
    out = {
        "attempted": len(schedule),
        "failed": len(schedule) - len(answered),
        "images_done": sum(schedule[i].images for i in answered
                           if done[i] <= t_end),
        "latencies_s": [done[i] - (t0 + schedule[i].due_s)
                        for i in answered],
        "lateness_s": lateness,
        "window_s": seconds,
        "answers": [check.Answer([(offsets[i] + k) % size
                                  for k in range(schedule[i].images)],
                                 to_host.kept.get(i))
                    for i in sorted(sample - refused)],
        "refused": len(refused),
        "engine": {"rounds": totals["rounds1"] - totals["rounds0"],
                   "completions": totals["done1"] - totals["done0"],
                   "round_batch": eng.round_batch},
    }
    if tracer is not None and tracer.t1 is not None:
        imgs = sum(schedule[i].images for i in answered
                   if tracer.t0 <= done[i] <= tracer.t1)
        out["slice"] = Slice(imgs, totals["slice1"] - totals["slice0"])
    return out


# -- one run of a cell ----------------------------------------------------

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_outputs(cell: Cell, seed: int, device,
                      precision: str = "fp32") -> torch.Tensor:
    """The reference's output for every pool image, from weights and
    images drawn again from the seed (the same values the program got,
    none of its tensors), in blocks of 8 images."""
    params, gen = make_params(cell.config, seed, device)
    pool = make_pool(cell.config, cell.traffic, gen, device)
    n = cell.traffic["pool_images"]
    outs = [reference.forward(cell.config, params, pool[i:i + 8].to(device),
                              precision) for i in range(0, n, 8)]
    return torch.cat(outs)[:n]


def run_cell(cell: Cell, seed: int, seconds: float, *, trace: bool,
             device, t_start: float, max_requests: int | None = None,
             control: bool = False) -> Run:
    """Set up, run the window, free the program, judge the answers."""
    tr = cell.traffic
    marks = [("", t_start), ("imports", now())]

    def mark(label: str) -> None:
        _sync(device)
        marks.append((label, now()))

    program.build_kernels(device)
    mark("kernels built or found")
    params, gen = make_params(cell.config, seed, device)
    pool = make_pool(cell.config, tr, gen, device)
    mark("weights and images")
    dep = program.deploy(cell.config, device)
    mark("plan, place, compile")
    tracer = Tracer(device) if trace else None
    warm_requests = WARMUP_REQUESTS if max_requests is None else 1
    if tr["loop"] == "closed":
        sess = program.session(dep, params, tr["round_batch"])
        mark("session and graph capture")
        closed_loop(sess, pool, tr, math.inf, device, sampler=None,
                    tracer=None, max_requests=warm_requests)
        if tracer is not None:
            tracer.warm(lambda: closed_loop(sess, pool, tr, math.inf, device,
                                            sampler=None, tracer=None,
                                            max_requests=1))
        mark("warm-up")
        setup_s = now() - t_start
        out = closed_loop(sess, pool, tr, seconds, device,
                          sampler=check.Reservoir(SAMPLE_REQUESTS, seed),
                          tracer=tracer, max_requests=max_requests)
        sess.close()
        del sess
    else:
        schedule = generator.open_schedule(tr, seconds, seed)
        warm = generator.open_schedule(tr, WARMUP_S, seed + 1)
        if max_requests is not None:
            schedule, warm = schedule[:max_requests], warm[:warm_requests]
        biggest = max(range(len(schedule)),
                      key=lambda i: schedule[i].images)
        sample = set(check.sample_indices(len(schedule), SAMPLE_REQUESTS,
                                          seed, must=[biggest]))

        async def serve():
            eng = program.engine(dep, params, round_batch=tr["round_batch"],
                                 max_wait_ms=tr["max_wait_ms"],
                                 max_pending=tr["max_pending"])
            mark("engine, session and graph capture")
            async with eng:
                await open_loop(eng, pool, tr, warm, WARMUP_S, device,
                                sample=set(), tracer=None)
                if tracer is not None:
                    tracer.warm(lambda: _sync(device))
                mark("warm-up")
                setup = now() - t_start
                return setup, await open_loop(eng, pool, tr, schedule,
                                              seconds, device, sample=sample,
                                              tracer=tracer)

        setup_s, out = asyncio.run(serve())
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    traced = tracer.reduce() if tracer is not None else None
    # the program's state goes before the reference runs
    del dep, params, pool, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_outputs(cell, seed, device)
    run = Run(setup_s=setup_s, window_s=out["window_s"],
              attempted=out["attempted"], failed=out["failed"],
              images_done=out["images_done"],
              latencies_s=out["latencies_s"], lateness_s=out["lateness_s"],
              work=work.work(cell.config),
              answers=out["answers"], memory_peak_bytes=peak,
              engine=out.get("engine"), slice=out.get("slice"),
              trace=traced,
              setup_parts={label: t - marks[i][1] for i, (label, t)
                           in enumerate(marks[1:]) if label})
    run.checks = check.checks(run.answers, ref,
                              cell.limits["worst_rel_gap"])
    if control:
        low = reference_outputs(cell, seed, device, "tf32")
        run.control_gap = check.worst_gap(
            [check.Answer(a.pool_index, low[a.pool_index])
             for a in run.answers], ref)
    return run
