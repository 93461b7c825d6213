"""Benchmark: paper Fig. 5 — lifetime trajectories of V_DD, critical-path
delay and ΔVth, with vs without fault tolerance (components K, O, Down vs
the never-boosting tolerant group)."""
from __future__ import annotations

import sys

import numpy as np

from ..core.artifacts import load_calibration
from ..core.policy import FaultTolerantPolicy, evaluate_policy
from ..core.scenario import Scenario
from .common import main, report, table

YEAR = 365.25 * 24 * 3600.0
YEARS = (0.1, 1, 3, 5, 10)
COMPONENTS = ("baseline", "k", "o", "down", "q")


def _sample(traj, years):
    t = np.asarray(traj["t"])
    idx = [int(np.clip(np.searchsorted(t, y * YEAR), 0, len(t) - 1))
           for y in years]
    return {k: np.asarray(v)[idx] for k, v in traj.items() if k != "dv"}


def evaluate(device="cuda"):
    cal = load_calibration()
    res = evaluate_policy(FaultTolerantPolicy(ber_model=cal.ber),
                          cal.aging, cal.delay_poly, cal.power,
                          Scenario.from_lifetime_config(cal.lifetime_cfg),
                          device=device)
    samples = {name: _sample(res[name]["traj"], YEARS) for name in COMPONENTS}
    label = lambda name, other: name if name != "q" else other
    rows = [[label(name, "others (q,v,...)"),
             *(f"{v:.2f}" for v in samples[name]["V"])]
            for name in COMPONENTS]
    txt = table(f"Fig 5(a) — V_DD [V] at years {YEARS}",
                ["component", *[f"{y}y" for y in YEARS]], rows)
    rows_d = [[label(name, "others"),
               *(f"{v * 1e9:.3f}" for v in samples[name]["delay"])]
              for name in COMPONENTS]
    txt += "\n" + table("Fig 5(b) — critical-path delay [ns]",
                        ["component", *[f"{y}y" for y in YEARS]], rows_d)
    rows_p = [[label(name, "others"),
               *(f"{v:.1f}" for v in samples[name]["dvp"])]
              for name in COMPONENTS]
    txt += "\n" + table("Fig 5(c) — ΔVth PMOS [mV]",
                        ["component", *[f"{y}y" for y in YEARS]], rows_p)

    base_V = np.asarray(res["baseline"]["traj"]["V"])
    q_V = np.asarray(res["q"]["traj"]["V"])
    o_V = np.asarray(res["o"]["traj"]["V"])
    k_V = np.asarray(res["k"]["traj"]["V"])
    n_boost = lambda V: int(np.count_nonzero(np.diff(V) > 1e-6))
    checks = [
        ("tolerant group never boosts (paper: threshold never reached)",
         n_boost(q_V) == 0, f"{n_boost(q_V)} boosts"),
        ("fault tolerance reduces boost count (K < baseline)",
         n_boost(k_V) < n_boost(base_V),
         f"K={n_boost(k_V)}, base={n_boost(base_V)}"),
        ("sensitive O tracks baseline closely",
         abs(float(o_V[-1]) - float(base_V[-1])) <= 0.02, ""),
        ("V increases accelerate aging (baseline ΔVth > tolerant)",
         float(np.asarray(res['baseline']['traj']['dvp'])[-1]) >
         float(np.asarray(res['q']['traj']['dvp'])[-1]), ""),
    ]
    out = {name: {k: v.tolist() for k, v in samples[name].items()}
           for name in COMPONENTS}
    out["boosts"] = {name: n_boost(np.asarray(res[name]["traj"]["V"]))
                     for name in COMPONENTS}
    return report(txt, out, checks)


if __name__ == "__main__":
    sys.exit(main(evaluate, __doc__))
