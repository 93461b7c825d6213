"""Fleet health report (port of ``repro.launch.obs_report``):
``python -m repro_torch.launch.obs_report [...] [--device cpu]``.

Renders a co-sim or an online-serving run into the per-device "aging
odometer" table (:mod:`repro_torch.obs.health`): ΔVth, guardband headroom,
ETA-to-threshold, admitted BER, plus the served-shape counters and span
timings from the metrics registry.

* ``--mode cosim`` (default) — age a staggered fleet under routed traffic
  (:meth:`repro_torch.core.fleet.FleetRuntime.apply_load`) and read the
  odometer off the co-sim trajectory (:func:`repro_torch.obs.taps.
  cosim_taps`: per-epoch ΔVth, headroom, boost events);
* ``--mode online`` — serve a live request queue with the taps enabled
  (:mod:`repro_torch.serve.online`), replay the measured occupancy into
  the aging recursion, and fold the serving metrics (p50/p99 latency,
  drop rate, tok/s) into the snapshot.

``--jsonl`` / ``--prom`` also export the run through
:mod:`repro_torch.obs.export` (an event log with a manifest header / a
Prometheus text exposition).  The flags are the reference's, plus
``--device`` (where the fleet and the model run: ``cuda``, the default,
or ``cpu``).
"""
from __future__ import annotations

import argparse

from ..configs import get_config
from ..core.fleet import FleetRuntime
from ..device import resolve_device
from ..obs import export as obs_export
from ..obs.taps import cosim_taps, enable_taps, telemetry_to_host
from ..sched.router import ROUTER_REGISTRY
from ..sched.workload import WORKLOADS
from . import serve as serve_launch

YEAR_S = 365.25 * 24 * 3600.0


def _print_odometer_series(telem, tag="[obs]"):
    """Condense the per-epoch (N, E) tap series to a start -> end digest."""
    if not telem:
        return
    n = telem["dvth_eff_mv"].shape[0]
    for i in range(n):
        eff = telem["dvth_eff_mv"][i]
        head = telem["headroom_s"][i] * 1e12
        boosts = telem["boosts"][i].sum() if "boosts" in telem else 0.0
        rec = telem["dvth_mono_mv"][i][-1] - eff[-1]
        print(f"{tag}   dev{i}: dVth {eff[0]:6.2f} -> {eff[-1]:6.2f} mV "
              f"(recovered {rec:5.2f}), margin {head[0]:6.1f} -> "
              f"{head[-1]:6.1f} ps, {boosts:.0f} boost events")


def _run_cosim(args, fleet, dev):
    cos = fleet.apply_load(workload=args.workload, router=args.router,
                           utilization=args.utilization,
                           horizon_s=args.horizon_years * YEAR_S)
    telem = telemetry_to_host(cosim_taps(cos, fleet.unit_scenario))
    print(f"[obs] co-sim: {cos.n_epochs} epochs of {args.workload} via "
          f"{args.router} over {args.horizon_years:g}y")
    _print_odometer_series(telem)
    return None


def _run_online(args, fleet, dev):
    from ..sched.workload import get_workload
    from ..serve.online import (OnlineFleetEngine, OnlineServeEngine,
                                requests_from_workload)

    cfg = get_config(args.arch).reduced()
    params = serve_launch.served_params(cfg, dev)
    wl = get_workload(args.workload, n_devices=args.n_devices,
                      utilization=args.utilization, n_epochs=args.n_epochs)
    reqs = requests_from_workload(
        wl, n_slots=args.n_slots, steps_per_epoch=args.steps_per_epoch,
        max_new=args.max_new, prompt_len=args.prompt_len, vocab=cfg.vocab,
        n_devices=args.n_devices, seed=0)
    max_len = args.prompt_len + args.max_new + 1
    kw = dict(n_slots=args.n_slots, max_len=max_len,
              max_new_cap=args.max_new, chunk_steps=args.chunk_steps,
              device=dev)
    if args.n_devices > 1:
        eng = OnlineFleetEngine(cfg, params, fleet, router=args.router,
                                **kw)
    else:
        eng = OnlineServeEngine(cfg, params, runtime=fleet, **kw)
    res = eng.serve(reqs, temperature=0.7,
                    max_steps=4 * args.n_epochs * args.steps_per_epoch)
    print(f"[obs] online: {res.n_completed} completed / "
          f"{res.n_dropped} dropped, p50 {res.p50:.0f} / "
          f"p99 {res.p99:.0f} steps")
    if res.telemetry is not None:
        lm = res.telemetry["logit_max"]
        print(f"[obs]   in-scan taps over {lm.shape[-1]} served steps: "
              f"mean logit_max {lm.mean():.2f}, mean margin "
              f"{res.telemetry['logit_margin'].mean():.2f}")
    # measured occupancy -> duty -> aging: the odometer advances on
    # traffic the engine actually served
    util = res.lane_utilization(max(args.n_epochs, 2))
    if util.ndim == 1:
        util = util[:, None]
    fleet.apply_load(util_trace=util,
                     horizon_s=args.horizon_years * YEAR_S)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="cosim", choices=("cosim", "online"),
                    help="what run feeds the health table")
    ap.add_argument("--arch", default="deepseek_7b",
                    help="--mode online model arch")
    ap.add_argument("--n-devices", type=int, default=3)
    ap.add_argument("--age-years", type=float, default=4.0,
                    help="staggered fleet ages (device i at age*(i+1)/n)")
    ap.add_argument("--budget", type=float, default=0.5)
    ap.add_argument("--workload", default="diurnal",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--router", default="wear_level",
                    choices=sorted(ROUTER_REGISTRY))
    ap.add_argument("--utilization", type=float, default=0.6)
    ap.add_argument("--horizon-years", type=float, default=2.0)
    # --mode online queue shape
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--chunk-steps", type=int, default=8)
    ap.add_argument("--n-epochs", type=int, default=8)
    ap.add_argument("--steps-per-epoch", type=int, default=48)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--jsonl", default=None,
                    help="write the run's event log (manifest + health "
                         "snapshot + metric samples) to this path")
    ap.add_argument("--prom", default=None,
                    help="write a Prometheus text exposition to this path")
    ap.add_argument("--quick", action="store_true",
                    help="smoke run: tiny fleet / trace")
    ap.add_argument("--device", default="cuda",
                    help="where the fleet and the model run: cuda "
                         "(default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        args.n_devices = min(args.n_devices, 2)
        args.n_epochs = min(args.n_epochs, 3)
        args.steps_per_epoch = min(args.steps_per_epoch, 16)
        args.n_slots = min(args.n_slots, 2)
        args.max_new = min(args.max_new, 6)
        args.prompt_len = min(args.prompt_len, 8)
        args.chunk_steps = min(args.chunk_steps, 4)

    fleet = FleetRuntime(n_devices=args.n_devices,
                         max_loss_pct=args.budget, device=dev)
    for i in range(args.n_devices):
        fleet.set_age(years=args.age_years * (i + 1) / args.n_devices,
                      device=i)

    with enable_taps():
        online_res = (_run_online(args, fleet, dev) if args.mode == "online"
                      else _run_cosim(args, fleet, dev))

    hlth = fleet.health(online_result=online_res)
    print()
    print(hlth.render())

    if args.jsonl:
        n = obs_export.write_jsonl(
            args.jsonl, manifest=obs_export.run_manifest(
                run=f"obs_report:{args.mode}", arch=args.arch,
                n_devices=args.n_devices), health=hlth.to_dict())
        print(f"\n[obs] wrote {n} rows -> {args.jsonl}")
    if args.prom:
        with open(args.prom, "w") as fh:
            fh.write(obs_export.prometheus_text())
        print(f"[obs] wrote Prometheus exposition -> {args.prom}")
    return hlth


if __name__ == "__main__":
    main()
