"""Lifetime design study: sweep the user's accuracy budget, the mission
duty factor and the clock guardband to map the reliability/efficiency trade
space — the what-if tool the paper's framework enables (Sec. V: "readily
extends to other applications by parameterizing the acceptable
timing-violation level").

The whole budget x duty grid — every operator domain of every cell — runs
as one batched ``simulate`` call (``sweep_policy``).

Run:  PYTHONPATH=src python -m repro_torch.examples.lifetime_study
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from ..core.artifacts import load_calibration
from ..core.avs import simulate
from ..core.policy import BaselinePolicy, FaultTolerantPolicy, sweep_policy
from ..core.power import batched_lifetime_stats
from ..core.resilience import OPERATORS
from ..core.scenario import Scenario, scenario_grid

BUDGETS = (0.1, 0.5, 1.0, 2.0)
DUTIES = (0.3, 0.5, 0.7)
T_CLKS = (1.55e-9, 1.60e-9, 1.65e-9, 1.70e-9)


def study(device="cuda", budgets=BUDGETS, duties=DUTIES,
          t_clks=T_CLKS) -> Dict:
    """The budget x duty sweep under both policies and the clock
    guardband sweep; returns the trajectories, the lifetime stats and
    the per-cell power saving."""
    cal = load_calibration()
    base = Scenario.from_lifetime_config(cal.lifetime_cfg)
    grid = scenario_grid(base, max_loss_pct=budgets, duty=duties)
    t0 = time.perf_counter()
    traj = sweep_policy(FaultTolerantPolicy(ber_model=cal.ber), cal.aging,
                        cal.delay_poly, grid, device=device)
    # baseline ignores the budget axis -> simulate the duty axis only
    base_traj = sweep_policy(BaselinePolicy(t_clk=cal.lifetime_cfg.t_clk),
                             cal.aging, cal.delay_poly,
                             scenario_grid(base, duty=duties), device=device)
    sweep_s = time.perf_counter() - t0
    stats = batched_lifetime_stats(cal.power, traj)
    bstats = batched_lifetime_stats(cal.power, base_traj)
    saving = 100.0 * (1.0 - stats["p_avg"] / bstats["p_avg"][None])
    tclks = torch.tensor(t_clks)
    gtraj = simulate(cal.aging, cal.delay_poly, base.replace(t_clk=tclks),
                     delay_max=tclks, device=device)
    return {"grid": grid, "traj": traj, "base_traj": base_traj,
            "stats": stats, "base_stats": bstats, "saving": saving,
            "guardband": gtraj, "sweep_s": sweep_s,
            "budgets": budgets, "duties": duties, "t_clks": t_clks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = study(args.device)
    budgets, duties, stats = r["budgets"], r["duties"], r["stats"]
    n = r["grid"].n_scenarios * len(OPERATORS)
    print(f"== {len(budgets)}x{len(duties)} scenario grid x "
          f"{len(OPERATORS)} domains = {n} lifetimes in one batched call "
          f"({r['sweep_s']:.1f}s with the baseline's) ==\n")
    i_o, i_q = OPERATORS.index("o"), OPERATORS.index("q")
    print(f"{'loss budget':>12} | {'duty':>5} | {'avg saving':>10} | "
          f"{'V_final(o)':>10} | {'ΔVth,p(q)':>10}")
    for bi, budget in enumerate(budgets):
        for di, duty in enumerate(duties):
            print(f"{budget:11.1f}% | {duty:5.1f} | "
                  f"{r['saving'][bi, di].mean():9.1f}% | "
                  f"{stats['v_final'][bi, di, i_o]:9.2f}V | "
                  f"{stats['dvp_final'][bi, di, i_q]:8.1f}mV")

    print("\n== clock guardband sweep (baseline AVS boost count) — one "
          "batched call ==")
    g = r["guardband"]
    print(f"{'t_clk [ns]':>10} | {'V_final':>8} | {'boosts':>6} | "
          f"{'ΔVth,p':>8}")
    for i, tclk in enumerate(r["t_clks"]):
        boosts = int(np.count_nonzero(np.diff(g.V[i]) > 1e-6))
        print(f"{tclk * 1e9:10.2f} | {float(g.V[i, -1]):7.2f}V | "
              f"{boosts:6d} | {float(g.dvp[i, -1]):6.1f}mV")

    print("\nTighter clocks force more boosts (the aging/voltage positive "
          "feedback); a larger accuracy budget defers them; higher duty "
          "accelerates BTI — the whole trade space from one batched call.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
