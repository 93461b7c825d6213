"""Compact BTI / HCI aging models with history-aware accumulation.

Port of ``repro.core.aging``.  Six trap populations, each a
voltage/temperature-accelerated power law ``dVth_i = K_i(V, T) *
t_eff**n_i``; the effective-time update carries the damage state across
voltage changes (the paper's central modelling claim, Table I row 4).
On top of that monotone state rides the short-term recoverable pool
(:class:`RecoveryParams`, :func:`relax_step`) that relaxes while a device
idles.  Everything is float32, batched over leading axes: ``dv`` is
``(..., 6)`` and ``V`` broadcasts as ``(..., 1)``.  The transcendental
steps are the reference backend's own and round alike on every device:
``exp`` and ``pow`` are :func:`repro_torch.fmath.exp` / :func:`~repro_torch.fmath.pow`
(``expm1`` is rounded from float64), and the multiply-adds the backend
fuses are fused here (:func:`repro_torch.fmath.fma`), because the
co-simulation's wear-levelling router turns an ulp of drift into
different routing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .. import fmath
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


def _is_bti(device) -> torch.Tensor:
    """:data:`IS_BTI` made on ``device`` (populations 0 and 1): copying
    the host mask over would make every co-simulation epoch wait."""
    return torch.arange(N_POP, device=device) < 2


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

    def to_dict(self) -> Dict[str, Any]:
        lst = lambda t: t.cpu().tolist()
        return {"A": lst(self.A), "B": lst(self.B), "Ea": lst(self.Ea),
                "n": lst(self.n), "chi": lst(self.chi),
                "dT_sh": float(self.dT_sh)}

    def to(self, device) -> "AgingParams":
        return AgingParams(self.A.to(device), self.B.to(device),
                           self.Ea.to(device), self.n.to(device),
                           self.chi.to(device), self.dT_sh)


@dataclasses.dataclass
class RecoveryParams:
    """Short-term (partially recoverable) trap-component parameters,
    float32 tensors ``(6,)`` in :data:`POPULATIONS` order.

    A recoverable pool ``rec`` rides on each population's monotone shift
    ``dv``: ``cap = rho * dv`` and ``d rec/dt = (1-act) * k_relax * (cap -
    rec) - act * k_retrap * rec`` with ``act`` the stressed fraction of the
    interval; the exhibited shift is ``dv - rec`` (:func:`effective_dv`).
    Interface-trap populations are permanent (``rho == 0``).
    """
    rho: torch.Tensor       # recoverable fraction of the accumulated shift
    k_relax: torch.Tensor   # idle detrapping rate [1/s]
    k_retrap: torch.Tensor  # re-capture rate under stress [1/s]

    @classmethod
    def default(cls) -> "RecoveryParams":
        """Fast NBTI traps relax within hours, slow traps over weeks, HCI
        interface traps never, HCI oxide traps partially; re-capture under
        stress is faster than relaxation."""
        return cls(rho=_f32([0.45, 0.10, 0.0, 0.25, 0.0, 0.25]),
                   k_relax=_f32([2e-4, 2e-6, 0.0, 5e-5, 0.0, 5e-5]),
                   k_retrap=_f32([1e-3, 1e-5, 0.0, 2e-4, 0.0, 2e-4]))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RecoveryParams":
        return cls(rho=_f32(d["rho"]), k_relax=_f32(d["k_relax"]),
                   k_retrap=_f32(d["k_retrap"]))

    def to_dict(self) -> Dict[str, Any]:
        return {f: getattr(self, f).cpu().numpy().tolist()
                for f in ("rho", "k_relax", "k_retrap")}

    def to(self, device) -> "RecoveryParams":
        return RecoveryParams(self.rho.to(device), self.k_relax.to(device),
                              self.k_retrap.to(device))


def relax_step(rparams: RecoveryParams, dv_mv: torch.Tensor,
               rec_mv: torch.Tensor, act, dt) -> torch.Tensor:
    """Advance the recoverable pool over a wall-clock segment ``dt`` [s].

    The exact exponential step of the linear relaxation ODE: with ``a =
    k_relax*(1-act)`` and ``b = k_retrap*act`` the pool decays toward
    ``a/(a+b) * rho*dv`` at rate ``a+b``, clipped into ``[0, rho*dv]``.  At
    ``act == 1`` the drive ``a`` is exactly zero, so an empty pool stays
    exactly empty.  The decay is :func:`repro_torch.fmath.exp`, the
    reference backend's own ``exp`` (the step cancels ``rec_inf`` against
    the decayed gap, which magnifies an ulp of ``exp``), so the pool
    equals the reference's and is the same on every device.  Broadcasts
    over leading (device, operator) axes.
    """
    dev = dv_mv.device
    act = torch.clamp(_f32(act, dev), 0.0, 1.0)
    idle = 1.0 - act
    a = rparams.k_relax * idle
    b = rparams.k_retrap * act
    # the rate a + b, with the product the reference backend fuses: the
    # equilibrium's divisor keeps a (which it reuses) and fuses b, the
    # decay fuses a
    lam_div = fmath.fma(act, rparams.k_retrap, a)
    lam_exp = fmath.fma(idle, rparams.k_relax, b)
    cap = rparams.rho * dv_mv
    rec_inf = a * cap / torch.clamp_min(lam_div, 1e-30)
    # a pool decaying at full stress underflows: flushed, as the reference
    rec = fmath.flush(fmath.fma(rec_mv - rec_inf,
                                fmath.exp(-lam_exp * _f32(dt, dev)), rec_inf))
    return torch.minimum(torch.clamp_min(rec, 0.0), cap)


def effective_dv(dv_mv, rec_mv):
    """Exhibited threshold shift: monotone state minus the relaxed pool."""
    if rec_mv is None:
        return dv_mv
    return dv_mv - rec_mv


def self_heating_temp(V, t_amb=T_AMB, dT_sh: float = 8.0,
                      v_ref: float = V_NOM):
    """Channel temperature with the ~V**2 self-heating rise [K].  The
    reference backend divides by the constant ``v_ref`` as a multiply by
    its float32 reciprocal, and so does this."""
    r = V * float(np.float32(1.0) / np.float32(v_ref))
    return t_amb + dT_sh * (r * r)


def k_factor(params: AgingParams, V, t_amb=T_AMB) -> torch.Tensor:
    """Per-population power-law prefactor ``K_i(V, T)`` [mV / s**n_i]."""
    T = self_heating_temp(V, t_amb, params.dT_sh)
    return params.A * fmath.exp(params.B * V) \
        * fmath.exp(-params.Ea / (KB_EV * T))


def hci_gamma_closed(B, V, n) -> torch.Tensor:
    """Equivalent-stress fraction of a linear 0 -> V transition ramp:
    ``(1 - exp(-B*V/n)) / (B*V/n)``, with the ``x -> 0`` limit."""
    x = _f32(B) * _f32(V) / _f32(n)
    safe = torch.clamp_min(x, 1e-6)
    em1 = torch.expm1(-safe.to(torch.float64)).to(_F32)
    return torch.where(x > 1e-6, -em1 / safe, 1.0 - 0.5 * x)


def hci_gamma(B: float, V: float, n: float, num: int = 256) -> float:
    """Equivalent-stress fraction of a linear 0 -> V transition ramp, by
    the trapezoid rule over ``num`` points (host float64): ``(1/tt) *
    int_0^tt exp(B * (Vg(t) - V) / n) dt``; :func:`hci_gamma_closed` is
    its closed form."""
    tgrid = np.linspace(0.0, 1.0, num)
    integrand = np.exp(B * (tgrid * V - V) / n)
    return float(np.trapezoid(integrand, tgrid))


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
    is_bti = _is_bti(dev)
    gamma = hci_gamma_closed(params.B, V_NOM, params.n)
    act = torch.where(is_bti, duty, toggle * transition_time / t_clk)
    base = torch.where(is_bti, duty,
                       gamma * (transition_time / t_clk) * toggle)
    if recovery:
        base = base * act / torch.clamp_min(
            fmath.fma(params.chi, 1.0 - act, act), 1e-30)
    return base.to(_F32)


def update_state(params: AgingParams, dv_mv: torch.Tensor, V, rates,
                 dt, t_amb=T_AMB) -> torch.Tensor:
    """Advance the six populations by a wall-clock segment ``dt`` at ``V``:
    ``t_eq = (dv / K)**(1/n)``, ``dv' = K * (t_eq + rate*dt)**n``."""
    K = k_factor(params, V, t_amb)
    inv_n = 1.0 / params.n
    t_eq = torch.where(dv_mv > 0.0, fmath.pow(dv_mv / K, inv_n),
                       torch.zeros((), dtype=_F32, device=dv_mv.device))
    t_new = t_eq + rates * dt
    return K * fmath.pow(t_new, params.n)


def totals(dv_mv: torch.Tensor):
    """Aggregate per-population shifts into (ΔVth_p, ΔVth_n) in mV."""
    pm = torch.as_tensor(IS_PMOS, dtype=dv_mv.dtype, device=dv_mv.device)
    return (dv_mv * pm).sum(dim=-1), (dv_mv * (1.0 - pm)).sum(dim=-1)


def dc_shift(params: AgingParams, idx: int, V: float, t: float,
             rate: float, t_amb: float = T_AMB) -> float:
    """Closed-form shift of one population after ``t`` at constant ``V``."""
    K = k_factor(params, _f32(V, params.A.device), t_amb)[idx]
    return float(K * (rate * t) ** float(params.n[idx]))
