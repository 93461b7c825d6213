"""Benchmark: paper Table I — aging evaluation across AVS scenarios.

Re-simulates all four rows and compares to the paper's numbers.  Rows 1-3
are calibration targets; row 4 is a genuine prediction of the
history-aware framework.  Rows 1 and 3 (no recovery, AVS off) run as one
scenario-batched ``simulate`` call over ``v_init``.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.artifacts import load_calibration
from ..core.avs import simulate
from ..core.constants import V_MAX
from ..core.scenario import Scenario
from .common import main, report, table

PAPER = {
    "V_nom, no recovery": (19.8, 62.2, 82.0, 50.5),
    "V_nom, recovery": (18.2, 54.9, 73.1, 46.1),
    "V_max, no recovery": (27.3, 103.4, 130.7, 105.2),
    "AVS (history-aware)": (23.7, 81.6, 105.3, 85.1),
}


def _row(dv_final):
    dv = np.asarray(dv_final)
    pmos_hci = dv[2] + dv[3]
    pmos_bti = dv[0] + dv[1]
    nmos = dv[4] + dv[5]
    return pmos_hci, pmos_bti, pmos_hci + pmos_bti, nmos


def evaluate(device="cuda"):
    cal = load_calibration()
    scn = Scenario.from_lifetime_config(cal.lifetime_cfg)
    sim = lambda s, **kw: simulate(cal.aging, cal.delay_poly, s,
                                   device=device, **kw)
    rows = {}
    norec = sim(scn.replace(v_init=torch.tensor([scn.v_init, V_MAX])),
                recovery=False, avs_enabled=False)
    rows["V_nom, no recovery"] = _row(norec.final()["dv"][0])
    rows["V_max, no recovery"] = _row(norec.final()["dv"][1])
    rec = sim(scn, recovery=True, avs_enabled=False)
    rows["V_nom, recovery"] = _row(rec.final()["dv"])
    avs = sim(scn, recovery=True, avs_enabled=True)
    rows["AVS (history-aware)"] = _row(avs.final()["dv"])

    out_rows = []
    for name, got in rows.items():
        ref = PAPER[name]
        out_rows.append([
            name,
            f"{got[0]:.1f} ({ref[0]})", f"{got[1]:.1f} ({ref[1]})",
            f"{got[2]:.1f} ({ref[2]})", f"{got[3]:.1f} ({ref[3]})",
        ])
    txt = table("Table I — ΔVth [mV], ours (paper)",
                ["scenario", "PMOS HCI", "PMOS BTI", "PMOS total", "NMOS"],
                out_rows)

    got = rows["AVS (history-aware)"]
    vmax = rows["V_max, no recovery"]
    red_p = 100 * (1 - got[2] / vmax[2])
    red_n = 100 * (1 - got[3] / vmax[3])
    v_final = float(avs.final()["v_final"])
    checks = [
        ("AVS V trajectory 0.90 -> 1.02 V",
         abs(v_final - V_MAX) < 0.005, f"V_final={v_final:.3f}"),
        ("pessimism reduction PMOS ~19.4%",
         abs(red_p - 19.4) < 4.0, f"{red_p:.1f}%"),
        ("pessimism reduction NMOS ~19.1%",
         abs(red_n - 19.1) < 4.0, f"{red_n:.1f}%"),
        ("row-4 PMOS within 5% of paper",
         abs(got[2] - 105.3) / 105.3 < 0.05, f"{got[2]:.1f} mV"),
        ("row-4 NMOS within 5% of paper",
         abs(got[3] - 85.1) / 85.1 < 0.05, f"{got[3]:.1f} mV"),
    ]
    return report(txt, {k: [float(x) for x in v] for k, v in rows.items()},
                  checks)


if __name__ == "__main__":
    sys.exit(main(evaluate, __doc__))
