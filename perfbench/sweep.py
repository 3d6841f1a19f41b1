"""Find the highest rate an open-loop cell sustains: short windows at a
few offered rates, in one process on one engine, each printed with its
completions, tail, generator lateness, occupancy and a verdict, then the
knee and the rate at four fifths of it.

    python3 perfbench/sweep.py --workload resnet18-poisson \
        --rates 100,120,140 --seconds 20 --seed 1

A rate is sustained when every request is answered (none refused, none
left unanswered) and the p95 latency of the window's last third of
requests is under ``GROWTH`` times that of its first third (the backlog
does not grow). The knee is the highest rate that is sustained with
every lower rate swept.
"""
from __future__ import annotations

import argparse
import asyncio
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GROWTH = 1.5
SHARE = 0.8     # the cell runs at this share of the knee


def p95_ms(xs) -> float:
    if len(xs) < 2:
        return float("nan")
    return statistics.quantiles(xs, n=20, method="inclusive")[18] * 1e3


def verdict(out: dict) -> tuple[bool, str]:
    """Whether an open loop's window sustained its rate, and why not
    (``latencies_s`` in due order, as :func:`bench.open_loop` gives them)."""
    if out["failed"]:
        return False, f"{out['failed']} requests refused or unanswered"
    lat = out["latencies_s"]
    third = max(1, len(lat) // 3)
    first, last = p95_ms(lat[:third]), p95_ms(lat[-third:])
    if not last < GROWTH * first:
        return False, (f"last third's p95 {last:.3f} ms not under "
                       f"{GROWTH} x the first third's {first:.3f} ms")
    return True, "sustained"


def knee(verdicts: list[tuple[float, bool]]) -> float | None:
    """The highest rate sustained with every lower rate swept."""
    best = None
    for rate, ok in sorted(verdicts):
        if not ok:
            break
        best = rate
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True,
                    help="comma-separated requests per second")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import bench, generator, program, spec

    torch.set_num_threads(bench.HOST_THREADS)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load(), args.workload)
    tr = cell.traffic
    if tr["loop"] != "open":
        print("sweep: the cell is not an open loop", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    program.build_kernels(device)
    params, gen = bench.make_params(cell.config, args.seed, device)
    pool = bench.make_pool(cell.config, tr, gen, device)
    dep = program.deploy(cell.config, device)
    sizes = generator.quotas(tr["size_weights"], 1000)
    mean_images = sum(s * q for s, q in zip(tr["sizes"], sizes)) / 1000

    async def sweep():
        eng = program.engine(dep, params, round_batch=tr["round_batch"],
                             max_wait_ms=tr["max_wait_ms"],
                             max_pending=tr["max_pending"])
        async with eng:
            warm = generator.open_schedule(tr, bench.WARMUP_S, args.seed)
            await bench.open_loop(eng, pool, tr, warm, bench.WARMUP_S,
                                  device, sample=set(), tracer=None)
            verdicts = []
            for k, rate in enumerate(float(r) for r in
                                     args.rates.split(",")):
                p = dict(tr, rate_rps=rate)
                sched = generator.open_schedule(p, args.seconds,
                                                args.seed + k)
                out = await bench.open_loop(eng, pool, p, sched,
                                            args.seconds, device,
                                            sample=set(), tracer=None)
                ok, why = verdict(out)
                verdicts.append((rate, ok))
                lat = out["latencies_s"]
                third = max(1, len(lat) // 3)
                eng_c = out["engine"]
                print(f"rate {rate:.1f} rps ({rate * mean_images:.1f} "
                      f"images/s offered): answered {len(lat)} of "
                      f"{out['attempted']}, refused {out['refused']}, "
                      f"images/s in window "
                      f"{out['images_done'] / args.seconds:.1f}, p50 "
                      f"{statistics.median(lat) * 1e3:.3f} ms, p95 "
                      f"{p95_ms(lat):.3f} ms, first third p95 "
                      f"{p95_ms(lat[:third]):.3f} ms, last third p95 "
                      f"{p95_ms(lat[-third:]):.3f} ms, lateness p95 "
                      f"{p95_ms(out['lateness_s']):.3f} ms, occupancy "
                      f"{100 * eng_c['completions'] / max(1, eng_c['rounds'] * eng_c['round_batch']):.1f}%"
                      f": {why}", flush=True)
            k = knee(verdicts)
            print(f"knee: {k} rps; the cell's rate at {SHARE} of it: "
                  f"{None if k is None else SHARE * k} rps", flush=True)

    asyncio.run(sweep())
    return 0


if __name__ == "__main__":
    sys.exit(main())
