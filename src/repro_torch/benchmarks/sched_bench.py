"""Benchmark: the traffic-to-aging co-simulation, one call for the whole
horizon against an epoch-by-epoch loop (port of the reference's
``benchmarks/sched_bench.py``).

:func:`repro_torch.sched.lifetime.cosimulate` runs routing -> stress ->
ΔVth -> policy voltage for every epoch of the horizon in one call that
never waits for the device between epochs.  A scheduler written as a
host control loop instead calls it one epoch at a time and carries the
fleet state through the host to route the next epoch.  The checks:

* a horizon cut in two and resumed from the first half's end state equals
  the uncut run bit for bit (the state the loop carries is the whole
  state);
* on a card only: the call makes as many host syncs for the whole horizon
  as for half of it (none per epoch).

Both times are printed, but their order is not a check here.  The
reference's check "one scan beats the per-epoch loop" measures what its
jitted scan fuses; the port launches each epoch's operations from the
host either way, so one call saves only the per-call setup and the
epoch's wait for the device, which is small beside the epoch itself.  The
reference's other two checks (one trace per router and shape, no retrace
on new traffic) have no counterpart: the port traces nothing.

Prints PASS/FAIL lines and exits 1 on a FAIL.
"""
from __future__ import annotations

import sys
import time

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

YEAR_S = 365.25 * 24 * 3600.0


def host_syncs(fn, dev) -> int:
    """Host-device synchronisations of ``fn()`` on a card (PyTorch's sync
    debug mode warns once per synchronising call)."""
    import warnings
    torch.cuda.synchronize(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def _timed(fn, reps: int, dev) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def evaluate(device="cuda", n: int = 8, epochs: int = 96, reps: int = 2):
    dev = resolve_device(device)
    cal = load_calibration()
    scn = Scenario.from_lifetime_config(cal.lifetime_cfg).replace(
        lifetime_s=5 * YEAR_S, t_amb=torch.as_tensor(
            T_AMB + np.linspace(0.0, 30.0, n), dtype=torch.float32))
    dmax = FaultTolerantPolicy(ber_model=cal.ber).thresholds(scn, OPERATORS)
    loads = get_workload("diurnal", n_devices=n, utilization=0.55,
                         n_epochs=epochs).loads(0, device=dev)
    epoch_s = 5 * YEAR_S / epochs
    kw = dict(router="wear_level", n_devices=n, epoch_s=epoch_s, device=dev)
    run = lambda lo, hi, **st: cosimulate(cal.aging, cal.delay_poly, scn,
                                          dmax, loads[lo:hi], **kw, **st)

    whole = run(0, epochs)
    t_whole = _timed(lambda: run(0, epochs), reps, dev)

    def looped(n_epochs):
        st = {}
        for e in range(n_epochs):
            step = run(e, e + 1, **st)
            st = {"dv0": step.dv[0], "v0": step.V[0], "util0": step.util[0]}

    n_loop = min(epochs, 16)
    looped(1)
    t_loop = _timed(lambda: looped(n_loop), reps, dev) * epochs / n_loop

    half = epochs // 2
    first = run(0, half)
    second = run(half, epochs, dv0=first.dv[-1], v0=first.V[-1],
                 util0=first.util[-1])
    resumed = all(np.array_equal(np.concatenate([getattr(first, f),
                                                 getattr(second, f)]),
                                 getattr(whole, f))
                  for f in ("util", "V", "delay", "dvp", "dvn", "dv"))

    rows = {"epochs": epochs, "devices": n, "whole_s": t_whole,
            "loop_s_est": t_loop, "epochs_per_s": epochs / t_whole,
            "loop_epochs_per_s": epochs / t_loop}
    txt = table(f"Traffic co-sim on {dev}: {epochs} epochs x {n} devices x "
                f"{len(OPERATORS)} domains (wear_level router)",
                ["path", "wall", "epochs/s"],
                [["one call for the horizon", f"{t_whole * 1e3:.0f} ms",
                  f"{epochs / t_whole:.0f}/s"],
                 [f"per-epoch loop (est. from {n_loop} epochs)",
                  f"{t_loop * 1e3:.0f} ms", f"{epochs / t_loop:.0f}/s"]])
    txt += (f"\none call for the horizon / per-epoch loop: "
            f"{t_whole / t_loop:.2f}x the loop's time")
    checks = [("a horizon resumed from its midpoint state equals the whole "
               "run bit for bit", resumed, "")]
    if dev.type == "cuda":
        syncs = {e: host_syncs(lambda: run(0, e), dev)
                 for e in (half, epochs)}
        rows["host_syncs"] = syncs
        checks.append(("no host sync between epochs on the card",
                       syncs[half] == syncs[epochs],
                       f"syncs at {half} / {epochs} epochs: "
                       f"{syncs[half]} / {syncs[epochs]}"))
    return report(txt, rows, checks)


if __name__ == "__main__":
    sys.exit(main(evaluate, __doc__))
