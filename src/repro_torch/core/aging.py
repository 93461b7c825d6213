"""Compact BTI / HCI aging models with history-aware accumulation.

Port of ``repro.core.aging`` (evaluation paths; short-term recovery and
``relax_step`` are not ported yet).  Six trap populations, each a
voltage/temperature-accelerated power law ``dVth_i = K_i(V, T) *
t_eff**n_i``; the effective-time update carries the damage state across
voltage changes (the paper's central modelling claim, Table I row 4).
Everything is float32, batched over leading axes: ``dv`` is ``(..., 6)``
and ``V`` broadcasts as ``(..., 1)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..device import true_div
from .constants import (DUTY_FACTOR, KB_EV, T_AMB, T_CLK, TOGGLE_RATE,
                        TRANSITION_TIME, V_NOM)

POPULATIONS = (
    "pmos_bti_fast",   # 0: NBTI fast traps   (recoverable)
    "pmos_bti_slow",   # 1: NBTI slow traps   (weakly recoverable)
    "pmos_hci_it",     # 2: PMOS HCI interface traps (permanent)
    "pmos_hci_ot",     # 3: PMOS HCI oxide traps     (partially recoverable)
    "nmos_hci_it",     # 4: NMOS HCI interface traps (permanent)
    "nmos_hci_ot",     # 5: NMOS HCI oxide traps     (partially recoverable)
)
N_POP = len(POPULATIONS)
IS_BTI = np.array([1, 1, 0, 0, 0, 0], dtype=bool)
IS_PMOS = np.array([1, 1, 1, 1, 0, 0], dtype=bool)

_F32 = torch.float32


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32, device=device)


@dataclasses.dataclass
class AgingParams:
    """Per-population compact-model parameters, float32 tensors ``(6,)``."""
    A: torch.Tensor        # prefactor [mV / s**n]
    B: torch.Tensor        # voltage acceleration [1/V]
    Ea: torch.Tensor       # activation energy [eV]
    n: torch.Tensor        # time exponent
    chi: torch.Tensor      # detrapping efficiency (recovery strength)
    dT_sh: float = 8.0     # self-heating rise at (V_NOM, nominal activity) [K]

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AgingParams":
        return cls(A=_f32(d["A"]), B=_f32(d["B"]), Ea=_f32(d["Ea"]),
                   n=_f32(d["n"]), chi=_f32(d["chi"]),
                   dT_sh=float(d.get("dT_sh", 8.0)))

    def to(self, device) -> "AgingParams":
        return AgingParams(self.A.to(device), self.B.to(device),
                           self.Ea.to(device), self.n.to(device),
                           self.chi.to(device), self.dT_sh)


def self_heating_temp(V, t_amb=T_AMB, dT_sh: float = 8.0,
                      v_ref: float = V_NOM):
    """Channel temperature with the ~V**2 self-heating rise [K]."""
    r = true_div(V, v_ref)
    return t_amb + dT_sh * (r * r)


def k_factor(params: AgingParams, V, t_amb=T_AMB) -> torch.Tensor:
    """Per-population power-law prefactor ``K_i(V, T)`` [mV / s**n_i]."""
    T = self_heating_temp(V, t_amb, params.dT_sh)
    return params.A * torch.exp(params.B * V) \
        * torch.exp(-params.Ea / (KB_EV * T))


def hci_gamma_closed(B, V, n) -> torch.Tensor:
    """Equivalent-stress fraction of a linear 0 -> V transition ramp:
    ``(1 - exp(-B*V/n)) / (B*V/n)``, with the ``x -> 0`` limit."""
    x = _f32(B) * _f32(V) / _f32(n)
    safe = torch.clamp_min(x, 1e-6)
    return torch.where(x > 1e-6, -torch.expm1(-safe) / safe, 1.0 - 0.5 * x)


def stress_rates(params: AgingParams, *, duty=DUTY_FACTOR,
                 toggle=TOGGLE_RATE, t_clk=T_CLK,
                 transition_time=TRANSITION_TIME,
                 recovery: bool = True) -> torch.Tensor:
    """Effective stress-seconds per wall-clock second, per population.

    BTI populations stress at the duty factor; HCI populations only during
    transitions (the paper's accumulation formula with the gamma
    equivalence).  With ``recovery`` each rate is scaled by the
    capture/emission balance ``act / (act + chi * (1 - act))``.
    """
    dev = params.A.device
    duty, toggle = _f32(duty, dev), _f32(toggle, dev)
    t_clk, transition_time = _f32(t_clk, dev), _f32(transition_time, dev)
    is_bti = torch.as_tensor(IS_BTI, device=dev)
    gamma = hci_gamma_closed(params.B, V_NOM, params.n)
    act = torch.where(is_bti, duty, toggle * transition_time / t_clk)
    base = torch.where(is_bti, duty,
                       gamma * (transition_time / t_clk) * toggle)
    if recovery:
        base = base * act / torch.clamp_min(act + params.chi * (1.0 - act),
                                            1e-30)
    return base.to(_F32)


def update_state(params: AgingParams, dv_mv: torch.Tensor, V, rates,
                 dt, t_amb=T_AMB) -> torch.Tensor:
    """Advance the six populations by a wall-clock segment ``dt`` at ``V``:
    ``t_eq = (dv / K)**(1/n)``, ``dv' = K * (t_eq + rate*dt)**n``."""
    K = k_factor(params, V, t_amb)
    inv_n = 1.0 / params.n
    t_eq = torch.where(dv_mv > 0.0, (dv_mv / K) ** inv_n,
                       torch.zeros((), dtype=_F32, device=dv_mv.device))
    t_new = t_eq + rates * dt
    return K * t_new ** params.n


def totals(dv_mv: torch.Tensor):
    """Aggregate per-population shifts into (ΔVth_p, ΔVth_n) in mV."""
    pm = torch.as_tensor(IS_PMOS, dtype=dv_mv.dtype, device=dv_mv.device)
    return (dv_mv * pm).sum(dim=-1), (dv_mv * (1.0 - pm)).sum(dim=-1)
