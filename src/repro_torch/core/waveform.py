"""Equivalent-waveform construction and iterative extrapolation, paper
Fig. 4 f-h (port of ``repro.core.waveform``).

Cycle-by-cycle simulation of BTI trapping and detrapping over a 10-year
lifetime is prohibitive, so one activity cycle (stress at ``V_DD`` for
``duty * period``, recovery at 0 V for the rest) is replaced, again and
again, by one equivalent cycle of twice the horizon whose effective stress
and recovery voltages reproduce the trapping and detrapping endpoints
(:func:`extrapolate`).  Micro-kinetics: an effective-time power law for
trapping (:func:`f_trapping`), universal relaxation for detrapping
(:func:`f_detrapping`).  The closed-form AC factor the lifetime simulator
uses is this procedure's converged limit; :func:`ac_factor_empirical`
measures it from explicit cycles (:func:`simulate_cycles`).

float32 torch arithmetic in the reference's operation order (its
transcendentals are the backend's own, so values agree within float32
rounding, not bit for bit).
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from .constants import KB_EV, T_AMB

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MicroTrapParams:
    """Single trap-population micro-kinetics."""
    A: float = 8.0e-3      # prefactor [mV / s**n]
    B: float = 4.2         # voltage acceleration [1/V]
    Ea: float = 0.08       # activation energy [eV]
    n: float = 0.14        # time exponent
    p_perm: float = 0.35   # permanent (non-recoverable) fraction
    c_rec: float = 0.9     # relaxation strength
    beta: float = 0.45     # relaxation stretch exponent


def _t(x, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=_F32, device=dev)


def _K(mp: MicroTrapParams, V, T=T_AMB) -> torch.Tensor:
    V = _t(V)
    return mp.A * torch.exp(mp.B * V) * torch.exp(
        _t(-mp.Ea / (KB_EV * T), V))


def f_trapping(mp: MicroTrapParams, dv, V, t_stress) -> torch.Tensor:
    """Stress continuation from the current shift ``dv`` (effective-time
    method)."""
    dv = _t(dv)
    K = _K(mp, _t(V, dv))
    t_eq = torch.where(dv > 0, (dv / K) ** (1.0 / mp.n),
                       torch.zeros_like(dv))
    return K * (t_eq + _t(t_stress, dv)) ** mp.n


def f_detrapping(mp: MicroTrapParams, dv, V_recovery, t_recovery,
                 V_stress) -> torch.Tensor:
    """Universal-relaxation detrapping of the recoverable fraction; a
    non-zero effective recovery voltage slows it, scaling the relaxation
    ratio by ``exp(-B * V_recovery)``."""
    dv = _t(dv)
    K = _K(mp, _t(V_stress, dv))
    t_s_eq = torch.where(dv > 0, (dv / K) ** (1.0 / mp.n),
                         torch.full_like(dv, 1e-30))
    xi = (_t(t_recovery, dv) / torch.clamp_min(t_s_eq, 1e-30)) \
        * torch.exp(-mp.B * _t(V_recovery, dv))
    frac = mp.p_perm + (1.0 - mp.p_perm) / (1.0 + mp.c_rec * xi ** mp.beta)
    return dv * frac


def simulate_cycles(mp: MicroTrapParams, V, duty, period, dv0,
                    n_cycles: int, *, device="cuda") -> torch.Tensor:
    """Explicit cycle-by-cycle stress/recovery on ``device``: the shift at
    the end of every recovery phase, ``(n_cycles,)``."""
    dev = resolve_device(device)
    t_s = _t(duty * period).to(dev)
    t_r = _t((1.0 - duty) * period).to(dev)
    V = _t(V).to(dev)
    dv = _t(dv0).to(dev)
    env = []
    for _ in range(n_cycles):
        dv = f_detrapping(mp, f_trapping(mp, dv, V, t_s), 0.0, t_r, V)
        env.append(dv)
    return torch.stack(env)


def equivalent_stress_voltage(mp: MicroTrapParams, dv1, t_stress,
                              T=T_AMB) -> torch.Tensor:
    """Invert ``dv1 = K(V_geff) * t_stress**n`` for ``V_geff`` (Fig. 4f)."""
    dv1 = _t(dv1)
    arr = mp.A * torch.exp(_t(-mp.Ea / (KB_EV * T), dv1))
    return torch.log(dv1 / (arr * _t(t_stress, dv1) ** mp.n)) / mp.B


def equivalent_recovery_voltage(mp: MicroTrapParams, dv1, dv2, t_recovery,
                                V_stress) -> torch.Tensor:
    """Invert the detrapping relation for ``V_geff_recovery`` (Fig. 4g)."""
    dv1 = _t(dv1)
    K = _K(mp, _t(V_stress, dv1))
    t_s_eq = (dv1 / K) ** (1.0 / mp.n)
    frac = _t(dv2, dv1) / dv1
    inner = (1.0 - mp.p_perm) / torch.clamp_min(frac - mp.p_perm, 1e-9) - 1.0
    xi = (torch.clamp_min(inner, 1e-12) / mp.c_rec) ** (1.0 / mp.beta)
    return -torch.log(xi * t_s_eq / _t(t_recovery, dv1)) / mp.B


def extrapolate(mp: MicroTrapParams, V, duty, period, total_time,
                n_base: int = 16, *, device="cuda") -> torch.Tensor:
    """Iterative period-doubling extrapolation (Fig. 4h): ``n_base``
    explicit cycles, then one equivalent (stress, recovery) pair per
    doubling of the horizon until ``total_time``.  The final shift [mV]."""
    env = simulate_cycles(mp, V, duty, period, 0.0, n_base, device=device)
    dv2 = env[-1]
    t = n_base * period
    dv1 = f_trapping(mp, env[-2] if n_base > 1 else torch.zeros_like(dv2),
                     V, duty * period)
    while t < total_time:
        step = min(t, total_time - t)          # double, or finish exactly
        t_s, t_r = duty * step, (1.0 - duty) * step
        v_eff_s = equivalent_stress_voltage(mp, dv1, duty * t)
        v_eff_r = equivalent_recovery_voltage(mp, dv1, dv2, (1.0 - duty) * t,
                                              V)
        dv1 = f_trapping(mp, dv2, torch.clamp_min(v_eff_s, V * 0.5), t_s)
        dv2 = f_detrapping(mp, dv1, v_eff_r, t_r, V)
        t = t + step
    return dv2


def ac_factor_empirical(mp: MicroTrapParams, V, duty, period,
                        n_cycles: int, *, device="cuda") -> torch.Tensor:
    """AC/DC shift ratio after ``n_cycles`` explicit cycles — the check of
    the closed-form AC factor the aging model uses."""
    env = simulate_cycles(mp, V, duty, period, 0.0, n_cycles, device=device)
    dc = _K(mp, _t(V, env)) * _t(n_cycles * period, env) ** mp.n
    return env[-1] / dc
