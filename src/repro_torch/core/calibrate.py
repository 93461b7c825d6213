"""One-shot calibration of the aging, delay, BER and power models (port
of ``repro.core.calibrate``).

``python -m repro_torch.core.calibrate [--out PATH] [--device cpu]``
regenerates the calibration artifact (``core/calibrated.json``, the
port's byte-identical copy of the reference's; ``--out`` writes
elsewhere).  The model forms stay fixed and their free scale factors are
fitted to the paper's Table I rows 1-3 (constant-voltage scenarios); row
4 (the AVS run) and Table II are predictions.  Steps:

1. :func:`calibrate_aging` — per-population voltage acceleration ``B``
   from the V_max/V_nom ratios (self-heating included, ``brentq``),
   detrapping efficiencies ``chi`` from the recovery rows, prefactors
   ``A`` from the absolute V_nom magnitudes;
2. :func:`calibrate_delay_knobs` — the path model's (alpha, vth0,
   wire_frac, pn_split) searched (a coarse grid, then Nelder-Mead) so the
   classical-AVS lifetime reproduces the AVS row, the polynomial refitted
   per candidate (:func:`repro_torch.core.delay.fit_delay_polynomial`);
3. :func:`find_delay_max_for_vfinal` and :func:`calibrate_ber` — the
   per-operator thresholds that end at Table II's final voltages, and the
   BER curve through them;
4. :func:`repro_torch.core.power.calibrate_power` — the 2x2 power fit.

The lifetimes run on ``device`` (:func:`repro_torch.core.avs.simulate`).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from . import aging
from .aging import POPULATIONS, AgingParams
from .artifacts import CAL_PATH
from .avs import LifetimeConfig, final_shifts, run_lifetime
from .ber import BerModel, solve_ber_model
from .constants import (KB_EV, LIFETIME_S, T_AMB, T_CLK, TOGGLE_RATE,
                        TRANSITION_TIME, V_MAX, V_NOM)
from .delay import PathModel, fit_delay_polynomial
from .power import calibrate_power
from .resilience import tolerable_bers

# Table I targets [mV]
TAB1 = {
    "pmos_bti": {"nom_norec": 62.2, "nom_rec": 54.9, "vmax_norec": 103.4},
    "pmos_hci": {"nom_norec": 19.8, "nom_rec": 18.2, "vmax_norec": 27.3},
    "nmos_hci": {"nom_norec": 50.5, "nom_rec": 46.1, "vmax_norec": 105.2},
}
TAB1_AVS = {"pmos": 105.3, "nmos": 85.1}      # predicted, not fitted
# Table II targets
TAB2_VFINAL = {"k": 0.94, "o": 1.01, "down": 0.99}
TAB2_POWER = {"nom": 0.85, "avs": 1.03}

# population structure: (mechanism, share of mechanism total, n, Ea)
POP_STRUCT = {
    "pmos_bti_fast": ("pmos_bti", 0.45, 0.12, 0.06),
    "pmos_bti_slow": ("pmos_bti", 0.55, 0.22, 0.08),
    "pmos_hci_it":   ("pmos_hci", 0.60, 0.45, 0.05),
    "pmos_hci_ot":   ("pmos_hci", 0.40, 0.30, 0.05),
    "nmos_hci_it":   ("nmos_hci", 0.60, 0.45, 0.05),
    "nmos_hci_ot":   ("nmos_hci", 0.40, 0.30, 0.05),
}
# recovery multiplier of the fast (recoverable) population per mechanism;
# the other population's follows from the mechanism total
FAST_REC_MULT = {"pmos_bti": 0.78}
DT_SH = 8.0


def _solve_B(ratio: float, ea: float, dt_sh: float = DT_SH) -> float:
    """Solve ``K(V_MAX) / K(V_NOM) = ratio`` for ``B``, with self-heating
    in the temperature."""
    from scipy.optimize import brentq

    def f(b):
        def k(v):
            T = T_AMB + dt_sh * (v / V_NOM) ** 2
            return np.exp(b * v) * np.exp(-ea / (KB_EV * T))
        return k(V_MAX) / k(V_NOM) - ratio

    return float(brentq(f, 0.01, 60.0))


def _params(A, B, Ea, n, chi, device) -> AgingParams:
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                    device=device)
    return AgingParams(A=f32(A), B=f32(B), Ea=f32(Ea), n=f32(n),
                       chi=f32(chi), dT_sh=DT_SH)


def calibrate_aging(device="cuda") -> AgingParams:
    """Step 1: the six trap populations' compact-model parameters, in
    float64 Python/numpy (scipy's ``brentq`` for ``B``), the prefactors
    from the float32 stress rates; returned as float32 tensors on
    ``device``."""
    device = resolve_device(device)
    names = list(POPULATIONS)
    A, B, Ea, n, chi = (np.zeros(6) for _ in range(5))
    mech_ratio = {m: TAB1[m]["vmax_norec"] / TAB1[m]["nom_norec"]
                  for m in TAB1}
    mech_recmult = {m: TAB1[m]["nom_rec"] / TAB1[m]["nom_norec"]
                    for m in TAB1}
    for i, name in enumerate(names):
        mech, share, n_i, ea_i = POP_STRUCT[name]
        n[i], Ea[i] = n_i, ea_i
        B[i] = _solve_B(mech_ratio[mech], ea_i)

    # per-population recovery multipliers -> chi
    for mech in TAB1:
        idxs = [i for i, nm in enumerate(names) if POP_STRUCT[nm][0] == mech]
        shares = np.array([POP_STRUCT[names[i]][1] for i in idxs])
        total_mult = mech_recmult[mech]
        if mech == "pmos_bti":
            m_fast = FAST_REC_MULT[mech]
            mults = [m_fast, (total_mult - shares[0] * m_fast) / shares[1]]
        else:
            # interface traps permanent (mult 1), oxide traps recoverable
            mults = [1.0, (total_mult - shares[0] * 1.0) / shares[1]]
        for i, m in zip(idxs, mults):
            if m >= 1.0 - 1e-9:
                chi[i] = 0.0
                continue
            R = m ** (1.0 / n[i])
            act = (0.5 if aging.IS_BTI[i]
                   else TOGGLE_RATE * TRANSITION_TIME / T_CLK)
            chi[i] = (1.0 / R - 1.0) * act / (1.0 - act)

    # prefactors from the absolute no-recovery magnitudes at V_NOM
    probe = _params(np.ones(6), B, Ea, n, chi, "cpu")
    rates = aging.stress_rates(probe, recovery=False).double().numpy()
    T_nom = T_AMB + DT_SH
    for i, name in enumerate(names):
        mech, share, n_i, ea_i = POP_STRUCT[name]
        target = share * TAB1[mech]["nom_norec"]
        k_noA = np.exp(B[i] * V_NOM) * np.exp(-ea_i / (KB_EV * T_nom))
        A[i] = target / (k_noA * (rates[i] * LIFETIME_S) ** n_i)
    return _params(A, B, Ea, n, chi, device)


def _row(traj, **extra) -> Dict:
    fs = final_shifts(traj)
    pops = np.asarray(traj["dv"])[-1]
    return {"pmos_total": fs["dvp"], "nmos": fs["dvn"],
            "pmos_hci": float(pops[2] + pops[3]),
            "pmos_bti": float(pops[0] + pops[1]), **extra}


def verify_table1(params: AgingParams, poly, cfg: LifetimeConfig, *,
                  device="cuda") -> Dict:
    """All four Table I rows from the lifetime simulator: constant V_NOM
    without and with recovery, constant V_MAX, and the AVS run (the
    prediction, with its final supply)."""
    rows = {}
    for rec, key in ((False, "nom_norec"), (True, "nom_rec")):
        rows[key] = _row(run_lifetime(params, poly, cfg, recovery=rec,
                                      avs_enabled=False, device=device))
    cfg_max = LifetimeConfig(**{**cfg.__dict__, "v_init": V_MAX})
    rows["vmax_norec"] = _row(run_lifetime(params, poly, cfg_max,
                                           recovery=False, avs_enabled=False,
                                           device=device))
    traj = run_lifetime(params, poly, cfg, delay_max=cfg.t_clk,
                        recovery=True, device=device)
    rows["avs"] = _row(traj, v_final=final_shifts(traj)["v_final"])
    return rows


def calibrate_delay_knobs(params: AgingParams, cfg: LifetimeConfig, *,
                          device="cuda"):
    """Step 2: search (alpha, vth0, wire_frac, pn_split) so the classical
    AVS lifetime reproduces the AVS row (ΔVth_p 105.3, ΔVth_n 85.1 mV,
    ending at V_MAX, not before 20 % of the lifetime): a 54-point grid,
    then scipy's Nelder-Mead (250 iterations).  Returns ``(path model,
    polynomial, loss)``."""
    from scipy.optimize import minimize

    def objective(x):
        alpha, vth0, wire, pn = x
        if not (1.0 <= alpha <= 1.6 and 0.20 <= vth0 <= 0.52
                and 0.05 <= wire <= 0.55 and 0.25 <= pn <= 0.75):
            return 1e3
        pm = PathModel(alpha=float(alpha), vth_p0=float(vth0),
                       vth_n0=float(vth0) - 0.02, wire_frac=float(wire),
                       pn_split=float(pn))
        traj = run_lifetime(params, fit_delay_polynomial(pm), cfg,
                            delay_max=cfg.t_clk, recovery=True,
                            device=device)
        v = np.asarray(traj["V"])
        dvp = float(np.asarray(traj["dvp"])[-1])
        dvn = float(np.asarray(traj["dvn"])[-1])
        t = np.asarray(traj["t"])
        hit = np.nonzero(v >= V_MAX - 1e-6)[0]
        t_hit = t[hit[0]] if hit.size else np.inf
        loss = ((dvp - TAB1_AVS["pmos"]) / TAB1_AVS["pmos"]) ** 2 \
            + ((dvn - TAB1_AVS["nmos"]) / TAB1_AVS["nmos"]) ** 2
        loss += (10.0 * (V_MAX - v[-1])) ** 2          # must end at 1.02
        if np.isfinite(t_hit) and t_hit < 0.2 * LIFETIME_S:
            loss += (0.2 - t_hit / LIFETIME_S) ** 2 * 10.0   # not too early
        return float(loss)

    best, best_x = np.inf, None
    for alpha in (1.15, 1.3, 1.45):
        for vth0 in (0.30, 0.38, 0.46):
            for wire in (0.15, 0.30, 0.45):
                for pn in (0.40, 0.55):
                    x = np.array([alpha, vth0, wire, pn])
                    val = objective(x)
                    if val < best:
                        best, best_x = val, x
    res = minimize(objective, best_x, method="Nelder-Mead",
                   options={"maxiter": 250, "xatol": 1e-3, "fatol": 1e-5})
    x = res.x if res.fun < best else best_x
    alpha, vth0, wire, pn = [float(v) for v in x]
    pm = PathModel(alpha=alpha, vth_p0=vth0, vth_n0=vth0 - 0.02,
                   wire_frac=wire, pn_split=pn)
    return pm, fit_delay_polynomial(pm), float(min(res.fun, best))


def find_delay_max_for_vfinal(params, poly, cfg, v_target: float,
                              hi: float = 1.80e-9, *, device="cuda") -> float:
    """Bisect ``delay_max`` (48 steps, float32 thresholds) so the AVS
    lifetime ends at ``v_target``."""
    lo_, hi_ = cfg.t_clk, hi
    for _ in range(48):
        mid = 0.5 * (lo_ + hi_)
        d = torch.tensor(mid, dtype=torch.float32)
        vf = float(np.asarray(run_lifetime(params, poly, cfg, delay_max=d,
                                           recovery=True,
                                           device=device)["V"])[-1])
        if vf > v_target + 1e-4:
            lo_ = mid
        else:
            hi_ = mid
    return 0.5 * (lo_ + hi_)


def calibrate_ber(dmax_targets: Dict[str, float], d_never: float):
    """Step 3: the BER curve through the (threshold, tolerable BER)
    anchors of O, Down and K; the tolerant operators must not trigger at
    the end-of-life 0.90 V delay ``d_never``.  Returns ``(model,
    residual in decades)``."""
    tols = tolerable_bers(max_loss_pct=0.5)
    anchors = {dmax_targets[op]: tols[op] for op in ("o", "down", "k")}
    bm = solve_ber_model(anchors)
    ber_eol = float(bm.ber_from_delay(d_never))
    if ber_eol >= tols["q"]:
        raise RuntimeError(
            f"tolerant operators would trigger: BER(EOL)={ber_eol:.3g} "
            f">= tol {tols['q']:.3g}")
    resid = max(abs(float(bm.log10_ber_from_delay(d)) - np.log10(b))
                for d, b in anchors.items())
    return bm, float(resid)


def main(out_path: str = CAL_PATH, *, device="cuda") -> Dict:
    """Run the four steps and write the artifact to ``out_path``."""
    device = resolve_device(device)
    cfg = LifetimeConfig()
    print("[1/4] calibrating aging populations against Table I rows 1-3 ...")
    params = calibrate_aging(device)

    print("[2/4] searching delay-model knobs for the AVS-row prediction ...")
    path_model, poly, dloss = calibrate_delay_knobs(params, cfg,
                                                    device=device)
    print(f"      knobs: alpha={path_model.alpha:.3f} "
          f"vth0={path_model.vth_p0:.3f} wire={path_model.wire_frac:.3f} "
          f"pn={path_model.pn_split:.3f} (loss {dloss:.4g}, poly RMSE "
          f"{poly.rmse * 1e9:.3g} ns)")
    tab1 = verify_table1(params, poly, cfg, device=device)
    print(f"      Table I check: {json.dumps(tab1, indent=2)}")

    print("[3/4] calibrating per-operator thresholds / BER curve ...")
    dmax_targets = {op: find_delay_max_for_vfinal(params, poly, cfg, v,
                                                  device=device)
                    for op, v in TAB2_VFINAL.items()}
    nom = run_lifetime(params, poly, cfg, recovery=True, avs_enabled=False,
                       device=device)
    d_never = float(np.asarray(nom["delay"])[-1])
    ber_model, bloss = calibrate_ber(dmax_targets, d_never)
    print(f"      dmax targets: "
          f"{ {k: f'{v * 1e9:.4f}ns' for k, v in dmax_targets.items()} }"
          f" d_never={d_never * 1e9:.4f}ns (loss {bloss:.4g})")

    print("[4/4] calibrating the power model ...")
    traj_nom = {k: np.asarray(v) for k, v in nom.items()}
    base = run_lifetime(params, poly, cfg, delay_max=cfg.t_clk,
                        recovery=True, device=device)
    traj_avs = {k: np.asarray(v) for k, v in base.items()}
    power = calibrate_power(traj_nom, traj_avs, TAB2_POWER["nom"],
                            TAB2_POWER["avs"])

    blob = {
        "aging": params.to_dict(),
        "path_model": path_model.to_dict(),
        "delay_poly": poly.to_dict(),
        "ber": ber_model.to_dict(),
        "power": power.to_dict(),
        "lifetime_cfg": {k: (v if not isinstance(v, np.generic)
                             else float(v))
                         for k, v in cfg.__dict__.items()},
        "table1_check": tab1,
        "dmax_targets": {k: float(v) for k, v in dmax_targets.items()},
        "tolerable_ber": tolerable_bers(max_loss_pct=0.5),
    }
    with open(out_path, "w") as f:
        json.dump(blob, f, indent=1)
    print(f"wrote {out_path}")
    return blob


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=CAL_PATH,
                    help="artifact to write (default: the port's "
                         "core/calibrated.json)")
    ap.add_argument("--device", default="cuda",
                    help="where the lifetimes run (default cuda)")
    args = ap.parse_args()
    main(args.out, device=args.device)
