"""Benchmark: paper Table II — per-operator fault-tolerant AVS over 10 years
(V_final, ΔVth, V_eff, P_avg, lifetime power saving).  All 9 operator rows
plus the baseline evaluate as one scenario-batched simulation."""
from __future__ import annotations

import sys

from ..core.artifacts import load_calibration
from ..core.policy import FaultTolerantPolicy, evaluate_policy
from ..core.scenario import Scenario
from .common import main, report, table

PAPER = {  # op -> (V_final, dvp, dvn, V_eff, P_avg, saving%)
    "q":    (0.90, 73.1, 46.1, 0.90, 0.85, 17.0),
    "k":    (0.94, 79.0, 52.1, 0.92, 0.88, 14.3),
    "v":    (0.90, 73.1, 46.1, 0.90, 0.85, 17.0),
    "qkt":  (0.90, 73.1, 46.1, 0.90, 0.85, 17.0),
    "sv":   (0.90, 73.1, 46.1, 0.90, 0.85, 17.0),
    "o":    (1.01, 99.7, 77.8, 0.97, 1.00, 3.1),
    "gate": (0.90, 73.1, 46.1, 0.90, 0.85, 17.0),
    "up":   (0.90, 73.1, 46.1, 0.90, 0.85, 17.0),
    "down": (0.99, 90.8, 66.7, 0.95, 0.95, 7.8),
}
STATS = ("v_final", "dvp_final", "dvn_final", "v_eff", "p_avg")


def evaluate(device="cuda"):
    cal = load_calibration()
    scn = Scenario.from_lifetime_config(cal.lifetime_cfg)
    res = evaluate_policy(FaultTolerantPolicy(ber_model=cal.ber),
                          cal.aging, cal.delay_poly, cal.power, scn,
                          device=device)
    base = res["baseline"]
    rows = [["baseline (none)", f"{base['v_final']:.2f} (1.02)",
             f"{base['dvp_final']:.1f} (105.3)",
             f"{base['dvn_final']:.1f} (85.1)",
             f"{base['v_eff']:.2f} (0.99)", f"{base['p_avg']:.2f} (1.03)",
             "/"]]
    for op, ref in PAPER.items():
        r = res[op]
        rows.append([
            op, f"{r['v_final']:.2f} ({ref[0]})",
            f"{r['dvp_final']:.1f} ({ref[1]})",
            f"{r['dvn_final']:.1f} ({ref[2]})",
            f"{r['v_eff']:.2f} ({ref[3]})", f"{r['p_avg']:.2f} ({ref[4]})",
            f"{r['power_saving_pct']:.1f}% ({ref[5]}%)"])
    txt = table("Table II — per-operator fault-tolerant AVS, ours (paper)",
                ["component", "V_final", "dVth,p mV", "dVth,n mV",
                 "V_eff", "P_avg W", "saving"], rows)

    avg = res["avg_power_saving_pct"]
    best_p = min(res[op]["dvp_final"] for op in PAPER)
    best_n = min(res[op]["dvn_final"] for op in PAPER)
    red_p = 100 * (1 - best_p / base["dvp_final"])
    red_n = 100 * (1 - best_n / base["dvn_final"])
    checks = [
        ("avg lifetime power saving ~14.0%", abs(avg - 14.0) < 2.0,
         f"{avg:.1f}%"),
        ("max PMOS ΔVth reduction ~30.6%", abs(red_p - 30.6) < 5.0,
         f"{red_p:.1f}%"),
        ("max NMOS ΔVth reduction ~45.8%", abs(red_n - 45.8) < 6.0,
         f"{red_n:.1f}%"),
        ("O is most sensitive (highest V_final among ops)",
         res["o"]["v_final"] == max(res[op]["v_final"] for op in PAPER),
         ""),
    ]
    out = {name: {k: res[name][k] for k in STATS}
           for name in ("baseline", *PAPER)}
    for op in PAPER:
        out[op]["power_saving_pct"] = res[op]["power_saving_pct"]
    out["avg_power_saving_pct"] = avg
    return report(txt, out, checks)


if __name__ == "__main__":
    sys.exit(main(evaluate, __doc__))
