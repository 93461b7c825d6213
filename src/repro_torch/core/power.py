"""Accelerator power model (port of ``repro.core.power``).

    P(V, dVth) = P_dyn0 * (V / V0)**2
               + P_leak0 * (V / V0) * 10**((k_dibl * (V - V0) - dVth_mean) / S)

evaluated in float32; the lifetime averages are float64 numpy, as in the
reference.  :func:`calibrate_power` solves ``(P_dyn0, P_leak0)`` against
two lifetime-average anchors (the physics calibration's step 4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..device import true_div
from .constants import V_NOM


@dataclasses.dataclass
class PowerModel:
    p_dyn0: float = 0.70        # dynamic power at V0 [W]
    p_leak0: float = 0.15       # leakage power at (V0, fresh) [W]
    v0: float = V_NOM
    s_slope: float = 0.085      # subthreshold slope [V/decade]
    k_dibl: float = 1.5         # supply sensitivity of leakage

    def power_split(self, V, dvth_p_mv, dvth_n_mv):
        """(dynamic, leakage) components [W], float32; dVth args in mV."""
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
        V, dvp, dvn = f32(V), f32(dvth_p_mv), f32(dvth_n_mv)
        dv_mean = 0.5 * (dvp + dvn) * 1e-3
        r = true_div(V, self.v0)
        dyn = self.p_dyn0 * (r * r)
        leak = self.p_leak0 * r * 10.0 ** true_div(
            self.k_dibl * (V - self.v0) - dv_mean, self.s_slope)
        return dyn, leak

    def power(self, V, dvth_p_mv, dvth_n_mv) -> torch.Tensor:
        """Instantaneous power [W] at full activity; dVth args in mV."""
        dyn, leak = self.power_split(V, dvth_p_mv, dvth_n_mv)
        return dyn + leak

    def power_at_activity(self, V, dvth_p_mv, dvth_n_mv,
                          activity) -> torch.Tensor:
        """Power when the device is busy ``activity`` of the time: the
        CV^2f term scales with the duty, leakage burns regardless."""
        dyn, leak = self.power_split(V, dvth_p_mv, dvth_n_mv)
        act = torch.as_tensor(np.asarray(activity), dtype=torch.float32)
        return act * dyn + leak

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PowerModel":
        return cls(**d)


def calibrate_power(traj_nom, traj_avs, target_nom: float = 0.85,
                    target_avs: float = 1.03, **kw) -> PowerModel:
    """Solve the 2x2 linear system for ``(p_dyn0, p_leak0)`` so the
    time-weighted lifetime averages of ``traj_nom`` and ``traj_avs`` (dicts
    of ``t, V, dvp, dvn`` series) hit the two targets [W]."""
    probe = PowerModel(p_dyn0=1.0, p_leak0=0.0, **kw)
    probe2 = PowerModel(p_dyn0=0.0, p_leak0=1.0, **kw)

    def basis_avgs(traj):
        t = np.asarray(traj["t"], np.float64)
        wdt = np.diff(t, prepend=0.0)
        wdt = wdt / wdt.sum()
        dyn = probe.power(traj["V"], 0.0, 0.0).double().numpy()
        leak = probe2.power(traj["V"], traj["dvp"],
                            traj["dvn"]).double().numpy()
        return float((dyn * wdt).sum()), float((leak * wdt).sum())

    a11, a12 = basis_avgs(traj_nom)
    a21, a22 = basis_avgs(traj_avs)
    sol = np.linalg.solve(np.array([[a11, a12], [a21, a22]]),
                          np.array([target_nom, target_avs]))
    return PowerModel(p_dyn0=float(sol[0]), p_leak0=float(sol[1]), **kw)


def batched_lifetime_stats(power_model: PowerModel, traj
                           ) -> Dict[str, np.ndarray]:
    """Time-weighted lifetime averages over any batch dims (time last)."""
    if hasattr(traj, "to_dict"):
        traj = traj.to_dict()
    t = np.asarray(traj["t"], np.float64)
    wdt = np.diff(t, axis=-1, prepend=0.0)
    wdt = wdt / wdt.sum(axis=-1, keepdims=True)
    p = np.asarray(power_model.power(traj["V"], traj["dvp"], traj["dvn"]),
                   np.float64)
    v = np.asarray(traj["V"], np.float64)
    return {
        "v_eff": (v * wdt).sum(axis=-1),
        "p_avg": (p * wdt).sum(axis=-1),
        "v_final": v[..., -1],
        "dvp_final": np.asarray(traj["dvp"], np.float64)[..., -1],
        "dvn_final": np.asarray(traj["dvn"], np.float64)[..., -1],
    }


def lifetime_stats(power_model: PowerModel, traj) -> Dict[str, float]:
    """Time-weighted lifetime averages: V_eff [V] and P_avg [W]."""
    return {k: float(v)
            for k, v in batched_lifetime_stats(power_model, traj).items()}
