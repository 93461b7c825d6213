"""Online-serving launcher (port of ``repro.launch.online``):
``python -m repro_torch.launch.online [...] [--device cpu]``.

Runs the continuous-batching engine end to end on a reduced config: a
:mod:`repro_torch.sched.workload` arrival trace becomes a live request
queue, :class:`repro_torch.serve.online.OnlineServeEngine` (or the
router-dispatched :class:`~repro_torch.serve.online.OnlineFleetEngine`
with ``--n-devices > 1``) serves it on fixed slots with admission
control, and the *measured* per-device slot occupancy is replayed into
:meth:`repro_torch.core.fleet.FleetRuntime.apply_load`: served traffic,
not a synthetic envelope, drives the aging recursion, and the wear it
produced is reported beside the serving metrics (tok/s, p50/p99 latency,
drop rate).

The flags are the reference's, plus ``--device`` (where the model runs:
``cuda``, the default, or ``cpu``).  ``--quick`` shrinks everything to a
small smoke run.
"""
from __future__ import annotations

import argparse

from ..configs import get_config
from ..core.fleet import FleetRuntime
from ..device import resolve_device
from ..sched.router import ROUTER_REGISTRY
from ..sched.workload import WORKLOADS, get_workload
from ..serve.online import (OnlineFleetEngine, OnlineServeEngine,
                            requests_from_workload)
from . import serve as serve_launch

YEAR_S = 365.25 * 24 * 3600.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek_7b")
    ap.add_argument("--n-devices", type=int, default=1)
    ap.add_argument("--age-years", type=float, default=5.0,
                    help="staggered fleet ages (device i at "
                         "age*(i+1)/n) — served BERs reflect them")
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--chunk-steps", type=int, default=8,
                    help="decode steps per chunk (refills happen between "
                         "chunks)")
    ap.add_argument("--workload", default="diurnal",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--utilization", type=float, default=0.6,
                    help="mean offered load / fleet slot capacity")
    ap.add_argument("--n-epochs", type=int, default=12,
                    help="arrival-trace epochs")
    ap.add_argument("--steps-per-epoch", type=int, default=64,
                    help="decode steps per arrival epoch")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16,
                    help="generation budget per request")
    ap.add_argument("--max-queue", type=int, default=32,
                    help="admission-control bound (arrivals beyond it "
                         "are dropped)")
    ap.add_argument("--router", default="wear_level",
                    choices=tuple(sorted(ROUTER_REGISTRY)),
                    help="lane-dispatch policy (fleet mode)")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replay-horizon-years", type=float, default=1.0,
                    help="service horizon the measured occupancy trace "
                         "spans when replayed into the aging recursion")
    ap.add_argument("--quick", action="store_true",
                    help="smoke run: tiny trace, 2 slots, short budgets")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        args.n_epochs = min(args.n_epochs, 4)
        args.steps_per_epoch = min(args.steps_per_epoch, 24)
        args.n_slots = min(args.n_slots, 2)
        args.max_new = min(args.max_new, 8)
        args.prompt_len = min(args.prompt_len, 8)
        args.chunk_steps = min(args.chunk_steps, 4)

    cfg = get_config(args.arch).reduced()
    params = serve_launch.served_params(cfg, dev)
    fleet = FleetRuntime(n_devices=args.n_devices, device=dev)
    for i in range(args.n_devices):
        fleet.set_age(years=args.age_years * (i + 1) / args.n_devices,
                      device=i)

    wl = get_workload(args.workload, n_devices=args.n_devices,
                      utilization=args.utilization,
                      n_epochs=args.n_epochs)
    reqs = requests_from_workload(
        wl, n_slots=args.n_slots, steps_per_epoch=args.steps_per_epoch,
        max_new=args.max_new, prompt_len=args.prompt_len,
        vocab=cfg.vocab, n_devices=args.n_devices, seed=args.seed)
    max_len = args.prompt_len + args.max_new + 1
    horizon = args.n_epochs * args.steps_per_epoch
    kw = dict(n_slots=args.n_slots, max_len=max_len,
              max_new_cap=args.max_new, chunk_steps=args.chunk_steps,
              max_queue=args.max_queue, seed=args.seed, device=dev)
    if args.n_devices > 1:
        eng = OnlineFleetEngine(cfg, params, fleet, router=args.router, **kw)
    else:
        eng = OnlineServeEngine(cfg, params, runtime=fleet, **kw)
    res = eng.serve(reqs, greedy=args.temperature == 0.0,
                    temperature=args.temperature or None,
                    max_steps=4 * horizon)

    s = res.summary()
    mode = (f"fleet={args.n_devices} router={args.router}"
            if args.n_devices > 1 else "single-device")
    print(f"[online] arch={cfg.name} {mode} slots={args.n_slots} "
          f"chunk={args.chunk_steps} workload={args.workload}")
    print(f"[online] {s['n_arrived']} arrived, {s['n_completed']} "
          f"completed, {s['n_dropped']} dropped "
          f"(rate {s['drop_rate']:.3f}) over {s['total_steps']} steps")
    print(f"[online] {s['tok_per_s']:.1f} tok/s, latency p50 "
          f"{s['p50']:.0f} / p99 {s['p99']:.0f} steps, occupancy "
          f"{s['mean_occupancy']:.2f}")

    # close the loop: measured occupancy -> duty -> aging
    util = res.lane_utilization(max(args.n_epochs, 2))
    if util.ndim == 1:
        util = util[:, None]
    cos = fleet.apply_load(util_trace=util,
                           horizon_s=args.replay_horizon_years * YEAR_S)
    wear = cos.device_wear()[-1]
    print(f"[online] replayed measured occupancy into the aging scan: "
          f"{args.replay_horizon_years:g}y at mean duty "
          f"{util.mean():.2f} -> fleet-max ΔVth {wear.max():.1f} mV "
          f"(spread {wear.max() - wear.min():.1f} mV)")
    return res


if __name__ == "__main__":
    main()
