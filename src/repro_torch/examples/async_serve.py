"""Async continuous-batching serving demo (paper §III-E behind an
asyncio front door): ``occam.autoplan -> Frontier.serve -> AsyncEngine``,
the twin of ``examples/async_serve.py``.

Build a VGG-style net -> fleet-aware planning frontier -> open the async
engine and push *concurrent multi-tenant* traffic through it. The engine
packs ragged requests into fixed rounds under a wall-clock SLO
(``max_wait_ms``), stages host packing while the device ticks, enforces
per-tenant admission control, and keeps live windowed metrics — all from
ONE built round program (zero new builds vs a bare session). Damped
autoscaling over the frontier is armed by default.

Every mesh position of the serving candidate sits on one device (a
device may repeat): ``cuda:0`` by default, where the spans run the
fused-span kernel, or ``--device cpu`` (its plain version).

    PYTHONPATH=src python -m repro_torch.examples.async_serve [--device cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import time

import torch

from repro_torch import occam
from repro_torch.core.graph import chain
from repro_torch.models import cnn
from repro_torch.models.api import resolve_device

C, P = "conv", "pool"
SPECS = [(C, 3, 1, 1, 8), (C, 3, 1, 1, 8), (P, 2, 2, 0, 0),
         (C, 3, 1, 1, 16), (C, 3, 1, 1, 16), (P, 2, 2, 0, 0),
         (C, 3, 1, 1, 16)]


async def serve(net, frontier, params, device) -> dict:
    # 2. one call opens the whole serving stack: pick a candidate,
    #    compile it (cached), start the engine, arm damped autoscaling.
    #    max_wait_ms is the packing SLO: a partial round older than this
    #    flushes masked instead of waiting for more traffic.
    # admission budget scales with the planned round: the winning
    # candidate's round width x its microbatch is one round
    best = frontier.best("throughput")
    round_batch = best.round_width * best.plan.batch
    max_pending = 2 * round_batch + 4
    eng = frontier.serve(params, objective="throughput", device=device,
                         max_wait_ms=25.0, max_pending=max_pending)
    async with eng:
        cand = eng.deployment.candidate
        print(f"engine: round_batch={eng.round_batch} on {cand.chips} "
              f"chips (kind={cand.kind}, autoscale armed)")

        # 3. concurrent multi-tenant traffic, ragged sizes: every request
        #    is packed into the one round shape
        sizes = [1, 3, eng.round_batch, 2, 2 * eng.round_batch + 1]
        tenants = ["alice", "bob", "carol"]

        requests = {}

        async def client(i: int, n: int) -> tuple[str, int]:
            x = torch.randn((n,) + net.map_shape(0),
                            generator=torch.Generator().manual_seed(1 + i))
            ticket = await eng.submit(x, tenant=tenants[i % len(tenants)])
            ys = await ticket            # resolves when all n images land
            assert ys.shape[0] == n
            requests[i] = (x, ys)
            return ticket.tenant, n

        served = await asyncio.gather(*(client(i, n)
                                        for i, n in enumerate(sizes)))
        print(f"served {served} from {eng.compile_count} compile(s), "
              f"{eng.packs_overlapped} host/device-overlapped packs")

        # 4. admission control: a tenant holding max_pending images gets
        #    backpressured instead of growing the queue without bound
        gen = torch.Generator().manual_seed(1)
        try:
            await eng.submit(torch.randn((max_pending + 1,)
                                         + net.map_shape(0), generator=gen),
                             tenant="dave")
        except occam.AdmissionError as e:
            print(f"admission: rejected oversubmit ({e})")

        # 5. steady state: saturate the engine with full rounds and read
        #    the live metrics ring (rates, occupancy, p50/p99 latency)
        xs = torch.randn((eng.round_batch,) + net.map_shape(0),
                         generator=gen)
        t0 = time.perf_counter()
        n_rounds = 24
        n_imgs = n_rounds * xs.shape[0]
        pending = []
        for _ in range(n_rounds):
            while True:
                try:
                    pending.append(await eng.submit(xs))
                    break
                except occam.AdmissionError:
                    await pending.pop(0)   # backpressure: drain oldest
        await asyncio.gather(*pending)
        if device.type == "cuda":  # a ticket resolves on host delivery
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        snap = eng.metrics.snapshot()
        print(f"steady state: {n_imgs} images in "
              f"{dt * 1e3:.1f} ms ({n_imgs / dt:.1f} "
              f"images/s; still {eng.compile_count} compile)")
        print(f"metrics: completions={snap['total_completions']} "
              f"rounds={snap['total_rounds']} "
              f"p50={snap['latency_p50_s'] * 1e3:.1f}ms "
              f"p99={snap['latency_p99_s'] * 1e3:.1f}ms "
              f"(p99 includes the first build)")
        # the armed autoscaler may have re-fit the deployment to the
        # observed rate by now — every switch keeps in-flight tickets
        cand2 = eng.deployment.candidate
        print(f"autoscale: {eng.switches} switch(es); serving on "
              f"{cand2.chips} chips, round_batch={eng.round_batch}")

        # 6. model == machine, still: the session under the engine counts
        #    masked lanes out of the traffic measurement
        report = eng.session.report()
        ok = report.matches_prediction
        print(f"traffic: counted={int(report.measured_elems)} over "
              f"{report.images} images, predicted "
              f"{int(report.offchip_elems)}/image "
              f"({'OK' if ok else 'MISMATCH'})")
        print("async serving OK" if ok else "async serving MISMATCH")
        return {"served": served, "compile_count": eng.compile_count,
                "switches": eng.switches, "images": report.images,
                "requests": [requests[i] for i in range(len(sizes))],
                "candidate": list(frontier).index(cand2),
                "predicted_per_image": report.offchip_elems,
                "matches_prediction": ok, "images_per_s": n_imgs / dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the one device of every mesh position (default: "
                         "cuda:0)")
    device = resolve_device(ap.parse_args(argv).device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    # 1. the net and its fleet-aware planning frontier: autoplan sweeps
    #    capacity x placement and keeps the Pareto-optimal candidates
    net = chain("vgg_mini", SPECS, in_h=16, in_w=16, in_ch=3)
    fleet = occam.Fleet(chips=6, vmem_elems=6000)
    frontier = occam.autoplan(net, fleet, batch=2)
    params = cnn.init_params(torch.Generator().manual_seed(0), net,
                             device=device)
    print(f"frontier: {len(frontier.candidates)} candidates over {fleet}")
    out = asyncio.run(serve(net, frontier, params, device))
    if not out["matches_prediction"]:
        raise AssertionError("async serving: traffic does not match the "
                             "prediction")
    return dict(out, net=net, frontier=frontier, params=params)


if __name__ == "__main__":
    main()
