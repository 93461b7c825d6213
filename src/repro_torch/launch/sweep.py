"""Scenario-sweep launcher (port of ``repro.launch.sweep``): map the
reliability/efficiency trade space.

``python -m repro_torch.launch.sweep [--budgets 0.1,0.5,2.0] [--duties
0.3,0.5,0.7] [--t-ambs ...] [--policy fault_tolerant] [--device cpu]``

Builds an N-D :func:`repro_torch.core.scenario.scenario_grid` over the
requested axes, evaluates the policy's per-operator thresholds for every
cell, and runs the whole grid x all operator domains as one batched
lifetime simulation (:func:`repro_torch.core.policy.sweep_policy`) on
``--device`` (the card by default).  Reports each cell's lifetime power
saving against the classical-AVS baseline of the same mission profile,
and the sweep's throughput.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.artifacts import load_calibration
from ..core.policy import BaselinePolicy, get_policy, sweep_policy
from ..core.power import batched_lifetime_stats
from ..core.resilience import OPERATORS
from ..core.scenario import Scenario, scenario_grid
from ..device import resolve_device

AXES = {"budgets": "max_loss_pct", "duties": "duty", "toggles": "toggle",
        "t-ambs": "t_amb", "t-clks": "t_clk"}


def _floats(s: str):
    return [float(x) for x in s.split(",") if x]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budgets", default="0.1,0.5,2.0",
                    help="accuracy budgets [%% loss]")
    ap.add_argument("--duties", default="0.3,0.5,0.7",
                    help="BTI duty factors (mission profiles)")
    ap.add_argument("--toggles", default="", help="HCI toggle rates")
    ap.add_argument("--t-ambs", default="", help="ambient temperatures [K]")
    ap.add_argument("--t-clks", default="", help="clock periods [s]")
    ap.add_argument("--policy", default="fault_tolerant",
                    choices=("fault_tolerant", "baseline"))
    ap.add_argument("--device", default="cuda",
                    help="where the simulation runs (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cal = load_calibration()
    axes = {}
    for arg_name, field in AXES.items():
        vals = _floats(getattr(args, arg_name.replace("-", "_")))
        if vals:
            axes[field] = vals
    base = Scenario.from_lifetime_config(cal.lifetime_cfg)
    scn = scenario_grid(base, **axes)
    n_cells = scn.n_scenarios
    n_ops = len(OPERATORS)
    print(f"[sweep] grid {dict((k, len(v)) for k, v in axes.items())} = "
          f"{n_cells} scenarios x {n_ops} operator domains "
          f"= {n_cells * n_ops} lifetimes, one batched simulation on {dev}")

    if args.policy == "fault_tolerant":
        policy = get_policy("fault_tolerant", ber_model=cal.ber)
    else:
        policy = BaselinePolicy(t_clk=cal.lifetime_cfg.t_clk)

    t0 = time.perf_counter()
    traj = sweep_policy(policy, cal.aging, cal.delay_poly, scn, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[sweep] run: {dt:.2f}s ({n_cells * n_ops / dt:.0f} lifetimes/s, "
          f"first call included)")

    # the per-profile classical-AVS baseline: the budget axis is dropped
    # (the baseline ignores it), then broadcast back
    base_axes = {k: v for k, v in axes.items() if k != "max_loss_pct"}
    base_scn = scenario_grid(base, **base_axes)
    base_traj = sweep_policy(BaselinePolicy(t_clk=cal.lifetime_cfg.t_clk),
                             cal.aging, cal.delay_poly, base_scn, device=dev)
    stats = batched_lifetime_stats(cal.power, traj)        # grid + (O,)
    base_stats = batched_lifetime_stats(cal.power, base_traj)
    base_p = base_stats["p_avg"]
    if "max_loss_pct" in axes:
        base_p = np.expand_dims(base_p, axis=list(axes).index("max_loss_pct"))
    saving = 100.0 * (1.0 - stats["p_avg"] / base_p)
    avg_saving = saving.mean(axis=-1)                      # grid
    v_final_worst = stats["v_final"].max(axis=-1)

    names = list(axes)
    flat_save = avg_saving.reshape(-1)
    flat_vf = v_final_worst.reshape(-1)
    hdr = " | ".join(f"{n:>12}" for n in names)
    print(f"\n{hdr} | {'avg saving':>10} | {'worst V_f':>9}")
    for idx in np.ndindex(*avg_saving.shape):
        cell = " | ".join(f"{axes[n][i]:>12g}" for n, i in zip(names, idx))
        k = np.ravel_multi_index(idx, avg_saving.shape)
        print(f"{cell} | {flat_save[k]:9.1f}% | {flat_vf[k]:8.2f}V")

    print(f"\n[sweep] best cell: {flat_save.max():.1f}% avg saving; "
          f"worst: {flat_save.min():.1f}%")
    return {"saving": avg_saving, "v_final": v_final_worst}


if __name__ == "__main__":
    main()
