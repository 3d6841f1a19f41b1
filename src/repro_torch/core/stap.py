"""STAP — Staggered Asynchronous Pipelining (paper §III-E).

Occam's optimal partitions may be latency-unbalanced; STAP replicates the
bottleneck stages and staggers mini-batches across replicas (mini-batch m ->
replica m mod r_i), raising throughput *without touching the optimal
partitioning*. Latency is unaffected while the arrival rate stays under the
bottleneck service rate (asynchronous stages: no clock edges).

Four artifacts:
  * ``plan_replication`` — closed-form replica counts under a chip budget or
    a target throughput.
  * ``simulate`` — a discrete-event simulator of the asynchronous pipeline
    used to *verify* the closed-form claims (paper example: stages
    15-35-40-10, replicate stages 2 and 3 -> one inference per 20 units).
  * ``staggered_schedule`` — the *executable* form: an explicit lock-step
    tick schedule (round width, per-replica ownership, fill/drain activity,
    inter-stage routing) that ``repro.runtime.stap_pipeline`` runs as an
    SPMD program over a (stage, replica) device mesh. Its lock-step
    makespan model is what measured pipeline throughput is checked
    against.
  * ``steady_schedule`` — the round-independent steady-state view of the
    same schedule (a *ring of rounds*, one per stage): what a compiled
    single-tick serving step (``StapRing`` / ``Deployment.serve``) needs,
    with the steady tick cost whose throughput recovers the closed form.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class StapPlan:
    stage_times: tuple[float, ...]
    replicas: tuple[int, ...]
    throughput: float          # inferences per time unit
    latency: float             # single-inference latency (sum of stages)
    chips: int                 # total chips used

    @property
    def bottleneck_period(self) -> float:
        return 1.0 / self.throughput


def plan_replication(stage_times: Sequence[float],
                     target_period: float | None = None,
                     max_chips: int | None = None,
                     max_replicas: int | None = None,
                     harmonize: bool = False,
                     harmonize_eps: float = 0.05) -> StapPlan:
    """Pick replica counts r_i.

    With ``target_period`` T: r_i = ceil(t_i / T)  (minimum replicas meeting T).
    With ``max_chips`` B: water-fill replicas onto the current bottleneck
    until the budget is spent (greedy is optimal here: throughput is
    min_i r_i/t_i and each increment strictly helps only the argmin).
    With neither: no replication (r_i = 1).
    ``max_replicas`` caps every r_i — the physical constraint of a
    (stage, replica) device mesh whose replica axis is max_replicas wide
    (a capped target_period plan may miss the target; the returned
    throughput is always honest).

    ``harmonize=True`` applies the round-width economy pass: snap each
    r_i to a divisor of max(r) so the executable's lcm(replicas) slot
    unroll shrinks (e.g. 4-3-2 -> 4-4-2: round width 12 -> 4), snapping
    *up* when the chip budget allows (throughput never drops) and *down*
    only when the predicted throughput loss stays within
    ``harmonize_eps`` (relative).
    """
    times = [float(t) for t in stage_times]
    if any(t <= 0 for t in times):
        raise ValueError("stage times must be positive")
    cap = max_replicas if max_replicas is not None else math.inf
    if cap < 1:
        raise ValueError("max_replicas must be >= 1")
    n = len(times)
    if target_period is not None:
        reps = [min(max(1, math.ceil(t / target_period)), cap)
                for t in times]
    elif max_chips is not None:
        if max_chips < n:
            raise ValueError(f"need >= {n} chips for {n} stages")
        reps = [1] * n
        budget = max_chips - n
        while budget > 0:
            # replicate the current bottleneck (among uncapped stages)
            free = [k for k in range(n) if reps[k] < cap]
            if not free:
                break
            i = max(free, key=lambda k: times[k] / reps[k])
            reps[i] += 1
            budget -= 1
    else:
        reps = [1] * n
    if harmonize:
        reps = _harmonize_replicas(times, reps, max_chips, harmonize_eps)
    thr = 1.0 / max(t / r for t, r in zip(times, reps))
    return StapPlan(tuple(times), tuple(reps), thr, sum(times), sum(reps))


def _harmonize_replicas(times: Sequence[float], reps: Sequence[int],
                        max_chips: int | None, eps: float) -> list[int]:
    """Round-width economy: snap replica counts to divisors of max(reps).

    The SPMD executor unrolls lcm(replicas) slots per tick
    (:class:`StaggeredSchedule`), so pairwise-coprime vectors like 4-3-2
    pay a 12-wide round. When every r_i divides r_max the width collapses
    to r_max. Per stage (bottleneck untouched — it already holds r_max):
    prefer the smallest divisor of r_max *above* r_i (more replicas,
    throughput can only rise) when the chip budget allows it, else fall
    back to the largest divisor *below* r_i if the resulting throughput
    stays within ``eps`` of the unharmonized plan. Stages that cannot
    snap keep their count — the pass never makes throughput worse than
    the eps band and never exceeds ``max_chips``.
    """
    reps = [int(r) for r in reps]
    r_max = max(reps)
    divisors = [d for d in range(1, r_max + 1) if r_max % d == 0]
    base_thr = 1.0 / max(t / r for t, r in zip(times, reps))
    budget = max_chips if max_chips is not None else math.inf
    chips = sum(reps)
    for i in range(len(reps)):
        if r_max % reps[i] == 0:
            continue
        up = min(d for d in divisors if d > reps[i])
        down = max(d for d in divisors if d < reps[i])
        if chips - reps[i] + up <= budget:
            chips += up - reps[i]
            reps[i] = up
            continue
        trial = reps.copy()
        trial[i] = down
        thr = 1.0 / max(t / r for t, r in zip(times, trial))
        if thr >= (1.0 - eps) * base_thr:
            chips += down - reps[i]
            reps[i] = down
    return reps


# --------------------------------------------------------------------------
# Explicit staggered tick schedule (the executable form of the plan)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SteadySchedule:
    """The round-independent steady-state view of the staggered schedule —
    one lock-step tick of a *ring of rounds*.

    A continuous serving session never sees fill/drain or a round count:
    every tick, each of the ``n_stages`` stages holds one round of
    ``round_width`` mini-batch slots (the ring is ``ring_depth`` rounds
    deep), serves its owned slots, and ships the boundary payloads one hop
    down the pipe. Everything a compiled single-tick SPMD step needs is
    here and static — ownership tables, per-slot inter-stage routing, the
    steady tick cost — so one lowering serves an unbounded stream.
    :class:`StaggeredSchedule` extends this with the finite-stream facts
    (round count, fill/drain activity, makespan) a batch run needs.
    """

    replicas: tuple[int, ...]
    round_width: int           # W = lcm(replicas): slots per round

    @property
    def n_stages(self) -> int:
        return len(self.replicas)

    @property
    def max_replicas(self) -> int:
        return max(self.replicas)

    @property
    def ring_depth(self) -> int:
        """Rounds resident in the serving ring: one per stage. A round
        submitted at tick t leaves the last stage at tick
        t + ring_depth - 1 — the session's submit-to-result latency."""
        return self.n_stages

    def replica_of(self, stage: int, m: int) -> int:
        return m % self.replicas[stage]

    def owner_table(self) -> list[list[list[bool]]]:
        """(stage, replica, slot) -> does this replica serve this slot?

        Identical for every round because round_width is a multiple of every
        r_i: slot w of any round is mini-batch ``g*W + w`` and
        ``(g*W + w) % r_i == w % r_i``.
        """
        s, r, w = self.n_stages, self.max_replicas, self.round_width
        return [[[self.replica_of(i, slot) == j for slot in range(w)]
                 for j in range(r)] for i in range(s)]

    def slot_perm(self, slot: int) -> list[tuple[int, int]]:
        """Inter-stage routing for one round slot, over the row-major
        flattened (stage, replica) device index: the replica of stage i
        that served the slot sends its boundary activations straight to
        the replica of stage i+1 that will serve it — the only
        inter-stage traffic in the executable."""
        r = self.max_replicas
        return [(i * r + self.replica_of(i, slot),
                 (i + 1) * r + self.replica_of(i + 1, slot))
                for i in range(self.n_stages - 1)]

    def steady_tick_time(self, stage_times: Sequence[float]) -> float:
        """Steady-state lock-step tick cost: every stage is active, each
        replica of stage i serves W / r_i slots sequentially."""
        return max(self.round_width / self.replicas[i] * stage_times[i]
                   for i in range(self.n_stages))

    def predicted_throughput(self, stage_times: Sequence[float]) -> float:
        """Steady-state mini-batches per time unit: W per tick. Equals the
        closed-form ``plan_replication`` throughput 1 / max_i(t_i / r_i) —
        what a serving session's measured throughput is checked against."""
        return self.round_width / self.steady_tick_time(stage_times)


def steady_schedule(plan: StapPlan) -> SteadySchedule:
    """The ring-of-rounds steady-state schedule view of ``plan`` — the
    static facts a compiled single-tick serving step needs (round width,
    ownership, routing), independent of any stream length."""
    width = functools.reduce(math.lcm, plan.replicas, 1)
    return SteadySchedule(plan.replicas, width)


@dataclasses.dataclass(frozen=True)
class StaggeredSchedule(SteadySchedule):
    """Lock-step tick schedule for a replicated span pipeline.

    Mini-batch m is served by replica ``m % r_i`` of stage i (the paper's
    staggering rule).  An SPMD executable cannot be event-driven, so the
    asynchronous pipeline is discretized into *rounds* of ``round_width``
    mini-batches (round_width = lcm of the replica counts, making the
    slot -> replica assignment identical in every round): round ``g`` is
    processed by stage ``i`` at tick ``g + i``, each replica of stage i
    serving ``round_width / r_i`` of the round's slots sequentially.

    Everything here is static: ownership tables and routing (inherited
    from the round-independent :class:`SteadySchedule` view — get it
    alone via :meth:`steady`), fill/drain activity, and a lock-step cost
    model (:meth:`predicted_makespan`) whose steady-state limit recovers
    the closed-form ``plan_replication`` throughput — the prediction that
    measured pipeline throughput is validated against.

    Cost note: every slot in a round has a distinct replica-assignment
    pattern (slots coincide only mod lcm), so the SPMD executor unrolls
    its per-tick work round_width = lcm(replicas) times. Pairwise-coprime
    replica counts (e.g. 4-3-2 -> W = 12) therefore inflate program size
    and round padding; prefer harmonic counts (each dividing
    max_replicas), which ``plan_replication``'s water-fill under a
    ``max_replicas`` cap tends to produce.
    """

    n_microbatches: int
    n_rounds: int              # ceil(n_microbatches / W)

    def steady(self) -> SteadySchedule:
        """Drop the finite-stream facts: the ring-of-rounds view."""
        return SteadySchedule(self.replicas, self.round_width)

    @property
    def n_ticks(self) -> int:
        """Fill + steady + drain: round g occupies stage i at tick g + i."""
        return self.n_rounds + self.n_stages - 1

    @property
    def n_slots(self) -> int:
        """Total slots including the padding of a partial final round."""
        return self.n_rounds * self.round_width

    def active(self, stage: int, tick: int) -> bool:
        """Does ``stage`` hold a live round at ``tick`` (fill/drain aware)?"""
        return 0 <= tick - stage < self.n_rounds

    def slot_live(self) -> list[bool]:
        """Per global slot: is it a real mini-batch (not final-round pad)?"""
        return [m < self.n_microbatches for m in range(self.n_slots)]

    def tick_time(self, stage_times: Sequence[float], tick: int) -> float:
        """Lock-step tick cost: slowest active stage; each replica of stage
        i serves W / r_i slots of its round sequentially within the tick."""
        per_stage = [self.round_width / self.replicas[i] * stage_times[i]
                     for i in range(self.n_stages) if self.active(i, tick)]
        return max(per_stage, default=0.0)

    def predicted_makespan(self, stage_times: Sequence[float]) -> float:
        """Exact lock-step makespan (fill + steady + drain)."""
        return sum(self.tick_time(stage_times, t) for t in range(self.n_ticks))

    def predicted_throughput(self, stage_times: Sequence[float]) -> float:
        """Mini-batches per time unit over the whole run. For n_rounds >>
        n_stages this approaches ``plan_replication``'s closed form
        1 / max_i(t_i / r_i) (the steady-state tick serves W mini-batches
        in W * max_i(t_i / r_i) time)."""
        return self.n_microbatches / self.predicted_makespan(stage_times)


def staggered_schedule(plan: StapPlan, n_microbatches: int) -> StaggeredSchedule:
    """Build the explicit tick schedule executing ``plan`` on a stream of
    ``n_microbatches`` mini-batches (a partial final round is padded and
    masked by the runtime)."""
    if n_microbatches < 1:
        raise ValueError("need at least one mini-batch")
    width = functools.reduce(math.lcm, plan.replicas, 1)
    rounds = -(-n_microbatches // width)
    return StaggeredSchedule(plan.replicas, width, n_microbatches, rounds)


@dataclasses.dataclass
class SimStats:
    completed: int
    makespan: float
    throughput: float
    mean_latency: float
    max_latency: float
    # jobs served per (stage, replica) — staggering fairness diagnostics
    replica_jobs: tuple[tuple[int, ...], ...] = ()


def simulate(plan: StapPlan, n_jobs: int, arrival_period: float | None = None) -> SimStats:
    """Discrete-event simulation of the staggered asynchronous pipeline.

    Mini-batch m uses replica (m mod r_i) of stage i (the paper's staggering
    rule). Stages are asynchronous FIFOs: a job starts on its designated
    replica as soon as (a) it has arrived from the previous stage and (b)
    that replica is free. Saturating arrivals by default.
    """
    if arrival_period is None:
        arrival_period = 0.0  # back-to-back
    n_stages = len(plan.stage_times)
    # replica_free[i][r] = earliest time replica r of stage i is idle
    replica_free = [[0.0] * plan.replicas[i] for i in range(n_stages)]
    jobs_served = [[0] * plan.replicas[i] for i in range(n_stages)]
    arrive = [m * arrival_period for m in range(n_jobs)]
    done_at = [0.0] * n_jobs
    for m in range(n_jobs):
        t = arrive[m]
        for i in range(n_stages):
            r = m % plan.replicas[i]
            start = max(t, replica_free[i][r])
            finish = start + plan.stage_times[i]
            replica_free[i][r] = finish
            jobs_served[i][r] += 1
            t = finish
        done_at[m] = t
    makespan = max(done_at)
    latencies = [done_at[m] - arrive[m] for m in range(n_jobs)]
    # steady-state throughput: jobs after warmup / time
    warm = n_jobs // 2
    steady = (done_at[-1] - done_at[warm - 1]) / max(n_jobs - warm, 1)
    return SimStats(
        completed=n_jobs,
        makespan=makespan,
        throughput=1.0 / steady if steady > 0 else float("inf"),
        mean_latency=sum(latencies) / n_jobs,
        max_latency=max(latencies),
        replica_jobs=tuple(tuple(j) for j in jobs_served),
    )


def paper_example() -> tuple[StapPlan, StapPlan]:
    """§III-E worked example: 15-35-40-10; replicating stages 2 and 3 gives
    one inference per 20 units, latency still 100."""
    base = plan_replication([15, 35, 40, 10])
    staged = plan_replication([15, 35, 40, 10], target_period=20.0)
    return base, staged
