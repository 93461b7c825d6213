"""Benchmark: scenario-batch sweep throughput of the lifetime simulator
(port of the reference's ``benchmarks/scenario_bench.py``).

A budgets x duty profiles x operator domains sweep runs as one batched
simulation (:func:`repro_torch.core.policy.sweep_policy`) instead of a
per-scenario loop that simulates each cell alone.  The first batched call
(cold: libraries load, caches fill) is reported apart from a second
(warm); the per-cell loop runs after them (the port compiles nothing
per shape, so no cell needs a warm-up of its own).  On the card every time
ends in ``torch.cuda.synchronize()``.  The check is the reference's: the
warm batched sweep beats the per-cell loop's estimate for the grid.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.scenario_bench
      [--device cpu]
"""
from __future__ import annotations

import sys
import time

import torch

from ..core.artifacts import load_calibration
from ..core.avs import simulate
from ..core.policy import FaultTolerantPolicy, sweep_policy
from ..core.resilience import OPERATORS
from ..core.scenario import Scenario, scenario_grid
from ..device import resolve_device
from .common import main, report, table


def evaluate(device="cuda", n_loop: int = 2):
    dev = resolve_device(device)

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    cal = load_calibration()
    base = Scenario.from_lifetime_config(cal.lifetime_cfg)
    grid = scenario_grid(base, max_loss_pct=[0.1, 0.5, 2.0],
                         duty=[0.3, 0.5, 0.7])
    policy = FaultTolerantPolicy(ber_model=cal.ber)
    n_life = grid.n_scenarios * len(OPERATORS)
    sweep = lambda: sweep_policy(policy, cal.aging, cal.delay_poly, grid,
                                 device=dev)
    cold = timed(sweep)
    warm = timed(sweep)

    def cell(i):
        c = grid[i % 3, i // 3]
        simulate(cal.aging, cal.delay_poly, c,
                 delay_max=policy.thresholds(c, OPERATORS), device=dev)

    per_cell = timed(lambda: [cell(i) for i in range(n_loop)]) / n_loop
    loop_est = per_cell * grid.n_scenarios

    txt = table(f"Scenario-batch sweep on {dev} — 9 scenarios x 9 operator "
                f"domains",
                ["path", "lifetimes", "wall", "throughput"],
                [["batched sweep (cold)", n_life, f"{cold:.3f}s",
                  f"{n_life / cold:.0f}/s"],
                 ["batched sweep (warm)", n_life, f"{warm:.3f}s",
                  f"{n_life / warm:.0f}/s"],
                 [f"per-cell loop est. ({n_loop} cells measured)", n_life,
                  f"{loop_est:.3f}s", f"{n_life / loop_est:.0f}/s"]])
    rows = {"lifetimes": n_life, "cold_s": cold, "warm_s": warm,
            "per_cell_s": per_cell, "loop_est_s": loop_est,
            "device": str(dev)}
    return report(txt, rows, [
        ("one batched sweep beats the per-scenario loop", warm < loop_est,
         f"{loop_est / max(warm, 1e-9):.1f}x")])


if __name__ == "__main__":
    sys.exit(main(evaluate, __doc__))
