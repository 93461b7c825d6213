"""Benchmark: short-term recovery and thermal feedback in the co-sim
(port of the reference's ``benchmarks/disruption_bench.py``).

The recoverable trap pool adds one exact exponential step per epoch and
the thermal RC node one power evaluation, both inside the same epoch loop
of :func:`repro_torch.sched.lifetime.cosimulate`.  The checks:

* the full disruption physics (recovery + thermal) costs less than 3x
  the monotone co-sim (the reference's check, timed on ``--device``);
* the always-stressed limit: with every device fully busy the recovery
  pool stays exactly empty and the run equals the monotone one (the
  property the recovery model is built on).  The reference's other two
  checks (each feature set traces once; sweeping the recovery/thermal
  parameters retraces nothing) have no counterpart: the port traces
  nothing;
* on a card only: each feature set makes as many host syncs for the whole
  horizon as for half of it (none per epoch).

Prints PASS/FAIL lines and exits 1 on a FAIL.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.artifacts import load_calibration
from ..core.constants import T_AMB
from ..core.policy import FaultTolerantPolicy
from ..core.resilience import OPERATORS
from ..core.scenario import Scenario
from ..device import resolve_device
from ..sched import cosimulate, get_workload
from .common import main, report, table
from .sched_bench import _timed, host_syncs

YEAR_S = 365.25 * 24 * 3600.0
VARIANTS = {"monotone (baseline)": {},
            "+ recovery pool": {"recovery_dynamics": True},
            "+ recovery + thermal RC": {"recovery_dynamics": True,
                                        "thermal": True}}


def evaluate(device="cuda", n: int = 8, epochs: int = 96, reps: int = 2):
    dev = resolve_device(device)
    cal = load_calibration()
    scn = Scenario.from_lifetime_config(cal.lifetime_cfg).replace(
        lifetime_s=1 * YEAR_S, t_amb=torch.as_tensor(
            T_AMB + np.linspace(0.0, 20.0, n), dtype=torch.float32))
    dmax = FaultTolerantPolicy(ber_model=cal.ber).thresholds(scn, OPERATORS)
    loads = get_workload("flash_crowd", n_devices=n, utilization=0.55,
                         n_epochs=epochs).loads(0, device=dev)
    kw = dict(router="wear_level", n_devices=n, epoch_s=YEAR_S / epochs,
              device=dev)
    run = lambda e, **x: cosimulate(cal.aging, cal.delay_poly, scn, dmax,
                                    loads[:e], **kw, **x)
    t_warm = {}
    for name, extra in VARIANTS.items():
        run(epochs, **extra)
        t_warm[name] = _timed(lambda: run(epochs, **extra), reps, dev)
    base = t_warm["monotone (baseline)"]
    overhead = t_warm["+ recovery + thermal RC"] / base

    busy = np.ones((epochs, n), np.float32)
    mono = cosimulate(cal.aging, cal.delay_poly, scn, dmax, None,
                      util_trace=busy, **kw)
    pool = cosimulate(cal.aging, cal.delay_poly, scn, dmax, None,
                      util_trace=busy, recovery_dynamics=True, **kw)
    collapse = (not pool.rec.any()) and all(
        np.array_equal(getattr(mono, f), getattr(pool, f))
        for f in ("V", "dvp", "dvn", "dv"))

    rows = {"epochs": epochs, "devices": n,
            "epochs_per_s": {k: epochs / v for k, v in t_warm.items()},
            "thermal_recovery_overhead_x": overhead}
    txt = table(f"Disruption physics on {dev}: {epochs} epochs x {n} devices "
                f"x {len(OPERATORS)} domains (flash_crowd traffic)",
                ["variant", "wall", "epochs/s", "vs baseline"],
                [[k, f"{t * 1e3:.0f} ms", f"{epochs / t:.0f}/s",
                  f"{100.0 * (t / base - 1.0):+.1f}%"]
                 for k, t in t_warm.items()])
    checks = [("full disruption physics cost < 3x the monotone co-sim",
               overhead < 3.0, f"{overhead:.2f}x"),
              ("always stressed: the recovery pool stays exactly empty and "
               "the run equals the monotone one", collapse, "")]
    if dev.type == "cuda":
        half = epochs // 2
        syncs = {name: (host_syncs(lambda: run(half, **extra), dev),
                        host_syncs(lambda: run(epochs, **extra), dev))
                 for name, extra in VARIANTS.items()}
        rows["host_syncs"] = syncs
        checks.append(("no host sync between epochs on the card, for every "
                       "feature set",
                       all(a == b for a, b in syncs.values()), str(syncs)))
    return report(txt, rows, checks)


if __name__ == "__main__":
    sys.exit(main(evaluate, __doc__))
