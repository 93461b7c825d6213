"""Scheduler launcher (port of ``repro.launch.schedule``): route traffic
to slow down fleet aging.

``python -m repro_torch.launch.schedule [--n-devices 8] [--workload
diurnal] [--routers round_robin,least_loaded,least_aged,wear_level]
[--device cpu] [...]``

Builds a heterogeneous fleet (a rack thermal gradient ``--t-amb-spread``
on top of a staggered deployment ``--stagger-years``), draws an
offered-load trace from the requested arrival model, and co-simulates the
same traffic under each routing policy
(:func:`repro_torch.sched.lifetime.compare_routers`) on ``--device`` (the
card by default).  Reports fleet-max ΔVth, wear spread, lifetime fleet
power and worst end-of-life supply per router, and how much of the
round-robin fleet's worst-case degradation ``wear_level`` removes.

``--scenario`` switches to a disruption scenario
(:mod:`repro_torch.sched.disruption`): ``flash_crowd``, ``retirement`` or
``rest_to_recover``.  ``--recovery`` / ``--thermal`` enable the
short-term recoverable trap pool and the routed-power thermal node.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.artifacts import load_calibration
from ..core.constants import T_AMB
from ..core.policy import BaselinePolicy, get_policy
from ..core.scenario import Scenario
from ..device import resolve_device
from ..sched import compare_routers, get_workload
from ..sched.lifetime import HEAT_PER_UTIL_K
from ..sched.router import ROUTER_REGISTRY
from ..sched.workload import WORKLOADS

YEAR_S = 365.25 * 24 * 3600.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-devices", type=int, default=8, help="fleet size")
    ap.add_argument("--workload", default="diurnal",
                    choices=sorted(WORKLOADS),
                    help="request-arrival model")
    ap.add_argument("--routers",
                    default="round_robin,least_loaded,least_aged,"
                            "wear_level",
                    help=f"comma list from {sorted(ROUTER_REGISTRY)}")
    ap.add_argument("--epochs", type=int, default=480,
                    help="scheduling epochs over the horizon")
    ap.add_argument("--horizon-years", type=float, default=5.0,
                    help="service horizon of the co-simulation")
    ap.add_argument("--utilization", type=float, default=0.55,
                    help="mean offered load / fleet capacity")
    ap.add_argument("--t-amb-spread", type=float, default=30.0,
                    help="rack thermal gradient across the fleet [K]")
    ap.add_argument("--stagger-years", type=float, default=7.0,
                    help="age of the oldest device at t=0 (staggered "
                         "deployment; 0 = fresh fleet)")
    ap.add_argument("--heat-per-util", type=float, default=HEAT_PER_UTIL_K,
                    help="load-induced heating at full utilization [K]")
    ap.add_argument("--budget", type=float, default=0.5,
                    help="accuracy budget [%% loss] of the AVS policy")
    ap.add_argument("--policy", default="fault_tolerant",
                    choices=("fault_tolerant", "baseline"))
    ap.add_argument("--seed", type=int, default=0,
                    help="arrival-noise stream")
    ap.add_argument("--scenario", default="routers",
                    choices=("routers", "flash_crowd", "retirement",
                             "rest_to_recover"),
                    help="router comparison (default) or a disruption "
                         "scenario from repro_torch.sched.disruption")
    ap.add_argument("--recovery", action="store_true",
                    help="model the short-term recoverable trap pool")
    ap.add_argument("--thermal", action="store_true",
                    help="close the temperature loop on routed power")
    ap.add_argument("--surge-gain", type=float, default=4.0,
                    help="flash-crowd load multiplier")
    ap.add_argument("--retire-epoch", type=int, default=None,
                    help="retirement epoch (default: mid-horizon)")
    ap.add_argument("--retire-devices", type=int, default=1,
                    help="number of (most-worn-slot) devices to retire")
    ap.add_argument("--hot-swap", type=int, default=0,
                    help="fresh replacements taking retired rack slots")
    ap.add_argument("--device", default="cuda",
                    help="where the co-simulation runs (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.scenario != "routers":
        return _run_disruption(args, dev)

    cal = load_calibration()
    n = args.n_devices
    scn = Scenario.from_lifetime_config(cal.lifetime_cfg,
                                        max_loss_pct=args.budget).replace(
        lifetime_s=args.horizon_years * YEAR_S)
    if args.t_amb_spread:
        scn = scn.replace(t_amb=torch.as_tensor(
            T_AMB + np.linspace(0.0, args.t_amb_spread, n),
            dtype=torch.float32))
    if args.policy == "fault_tolerant":
        policy = get_policy("fault_tolerant", ber_model=cal.ber)
    else:
        policy = BaselinePolicy(t_clk=cal.lifetime_cfg.t_clk)

    wl = get_workload(args.workload, n_devices=n,
                      utilization=args.utilization, n_epochs=args.epochs)
    loads = wl.loads(args.seed, device=dev)
    ages = np.linspace(0.0, args.stagger_years, n) * YEAR_S
    routers = tuple(r for r in args.routers.split(",") if r)

    print(f"[schedule] fleet of {n} devices | workload={args.workload} "
          f"(mean util {args.utilization:.2f}, {args.epochs} epochs over "
          f"{args.horizon_years:g}y) | policy={args.policy} "
          f"budget={args.budget}% | on {dev}")
    print(f"[schedule] heterogeneity: t_amb +[0..{args.t_amb_spread:g}]K, "
          f"deployment ages [0..{args.stagger_years:g}]y; one co-sim per "
          f"router")

    res = compare_routers(cal, scn, policy, loads, routers=routers,
                          n_devices=n, ages_s=ages,
                          heat_per_util=args.heat_per_util,
                          recovery_dynamics=args.recovery or None,
                          thermal=args.thermal or None, device=dev)

    hdr = (f"{'router':>12} | {'max ΔVth':>9} | {'spread':>7} | "
           f"{'P_avg fleet':>11} | {'worst V_f':>9} | {'served':>6}")
    print("\n" + hdr + "\n" + "-" * len(hdr))
    for name in routers:
        s = res[name]
        print(f"{name:>12} | {s['fleet_max_dvp_mv']:7.1f}mV | "
              f"{s['wear_spread_mv']:5.1f}mV | {s['p_avg_w']:9.2f} W | "
              f"{s['v_final_max']:8.3f}V | {100 * s['served_frac']:5.1f}%")

    if "round_robin" in res and "wear_level" in res:
        rr, wlv = res["round_robin"], res["wear_level"]
        d_dvp = 100.0 * (1.0 - wlv["fleet_max_dvp_mv"]
                         / rr["fleet_max_dvp_mv"])
        d_p = 100.0 * (1.0 - wlv["p_avg_w"] / rr["p_avg_w"])
        print(f"\n[schedule] wear_level vs round_robin: fleet-max ΔVth "
              f"-{d_dvp:.1f}%, lifetime fleet power -{d_p:.2f}% "
              f"(routing as the fleet-scale aging knob, cf. the paper's "
              f"45.8%/30.6% single-device AVS headline)")
    return res


def _run_disruption(args, dev):
    """Dispatch ``--scenario`` to the repro_torch.sched.disruption
    drivers."""
    from ..sched.disruption import (run_flash_crowd, run_rest_to_recover,
                                    run_retirement)
    common = dict(n_devices=args.n_devices, epochs=args.epochs,
                  horizon_years=args.horizon_years,
                  utilization=args.utilization, seed=args.seed, device=dev)
    if args.scenario == "flash_crowd":
        out = run_flash_crowd(surge_gain=args.surge_gain,
                              recovery=True, thermal=True,
                              t_amb_spread=args.t_amb_spread, **common)
        s = out["stats"]
        print(f"[disrupt] flash crowd x{args.surge_gain:g} over epochs "
              f"[{s['surge_start']}, {s['surge_end']}): served "
              f"{100 * s['surge_served_frac']:.1f}% of surge traffic | "
              f"node T peak {s['t_peak_k']:.1f}K "
              f"(fleet-mean rise +{s['t_surge_rise_k']:.1f}K, steady "
              f"{s['t_steady_k']:.1f}K) | fleet-max ΔVth "
              f"{s['fleet_max_dvp_mv']:.1f}mV (recovered pool "
              f"{s.get('recovered_mv_final', 0.0):.1f}mV)")
        return out
    if args.scenario == "retirement":
        retire = tuple(range(args.retire_devices))
        out = run_retirement(retire=retire, hot_swap=args.hot_swap,
                             retire_epoch=args.retire_epoch,
                             workload=args.workload,
                             recovery=True,
                             thermal=args.thermal or None,
                             t_amb_spread=args.t_amb_spread, **common)
        s = out["stats"]
        pd = out["plan_degraded"]
        print(f"[disrupt] retired {s['retired']} at epoch "
              f"{s['retire_epoch']}: fleet {s['n_before']} -> "
              f"{s['n_after']} devices | remesh "
              f"{dict(zip(pd.axis_names, pd.old_shape))} -> "
              f"{dict(zip(pd.axis_names, pd.new_shape))} "
              f"(microbatches {pd.microbatches}) | survivors resumed "
              f"bit-exactly at {s['survivor_pre_max_dvp_mv']:.1f}mV, "
              f"end of horizon {s['fleet_max_dvp_mv']:.1f}mV")
        return out
    out = run_rest_to_recover(workload=args.workload,
                              t_amb_spread=args.t_amb_spread,
                              stagger_years=args.stagger_years,
                              recovery=True,
                              thermal=args.thermal or None, **common)
    h = out["headline"]
    print(f"[disrupt] rest_to_recover vs round_robin: fleet-max ΔVth "
          f"-{h['rest_vs_round_robin_pct']:.1f}% (relaxed pool "
          f"{h['recovered_mv_final']:.1f}mV harvested by resting the "
          f"most-worn devices)")
    return out


if __name__ == "__main__":
    main()
