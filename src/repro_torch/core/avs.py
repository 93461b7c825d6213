"""AVS lifetime simulator (port of ``repro.core.avs``).

A loop over a log-spaced time grid covering t0 .. 10 years.  Each step
advances the six trap populations at the current V_DD, evaluates the
fitted delay polynomial, and raises V_DD in ``v_step`` increments while the
delay exceeds the policy's ``delay_max``.  The reference's per-step
``lax.while_loop`` boost becomes a masked loop of exactly
``max_boosts_per_step`` iterations: a lane leaves the loop for good once
its condition fails (its state no longer changes), so the fixed bound
gives the same voltages, with no host synchronisation on the device.
The reference's ``vmap`` over the flattened scenario batch becomes a batch
axis: every scenario leaf and threshold is broadcast to the joint batch,
each element with its own stress rates and time grid.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .. import fmath
from ..device import resolve_device, true_div
from . import aging
from .aging import AgingParams
from .constants import (DUTY_FACTOR, LIFETIME_S, T_AMB, T_CLK, TOGGLE_RATE,
                        TRANSITION_TIME, V_MAX, V_NOM, V_STEP)
from .delay import DelayPolynomial
from .scenario import LifetimeTrajectory, Scenario

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LifetimeConfig:
    """Scalar mission config (the calibration artifact's ``lifetime_cfg``)."""
    t_clk: float = T_CLK
    v_init: float = V_NOM
    v_step: float = V_STEP
    v_max: float = V_MAX
    duty: float = DUTY_FACTOR
    toggle: float = TOGGLE_RATE
    transition_time: float = TRANSITION_TIME
    t_amb: float = T_AMB
    lifetime_s: float = LIFETIME_S
    t_start: float = 600.0
    n_steps: int = 480
    max_boosts_per_step: int = 4

    def scenario(self, max_loss_pct: float = 0.5, **overrides) -> Scenario:
        return Scenario.from_lifetime_config(self, max_loss_pct, **overrides)


def _log10(x) -> torch.Tensor:
    """float32 ``jnp.log10``: XLA lowers it to ``log(x) * f32(1 / ln 10)``."""
    return torch.log(x) * 0.4342944819032518


def _logspace(start, stop, num: int, device) -> torch.Tensor:
    """``jnp.logspace(log10(start), log10(stop), num, dtype=float32)`` along
    a last axis, for scalar or ``(B, 1)`` bounds.

    jnp's linspace is ``start * (1 - s) + stop * s`` with ``s = i / (num -
    1)``, then the exact endpoint; ``10 ** lin`` is the reference backend's
    float32 power (:func:`repro_torch.fmath.pow`).
    """
    start = _log10(torch.as_tensor(start, dtype=_F32, device=device))
    stop = _log10(torch.as_tensor(stop, dtype=_F32, device=device))
    div = num - 1
    step = true_div(torch.arange(div, dtype=_F32, device=device), div)
    lin = start * (1 - step) + stop * step
    lin = torch.cat([lin, stop.reshape(lin.shape[:-1] + (1,))], dim=-1)
    return fmath.pow(10.0, lin)


def simulate(params: AgingParams, poly: DelayPolynomial,
             scenarios: Scenario, delay_max=None, *, recovery: bool = True,
             avs_enabled: bool = True, device="cuda") -> LifetimeTrajectory:
    """Simulate the lifetimes of a broadcastable batch of scenarios.

    ``delay_max`` (default: the scenario's clock — classical AVS) may have
    any shape; the result's ``batch_shape`` is its broadcast against the
    scenario's batch shape, and every element of that batch runs its own
    mission profile on its own time grid.  As in the reference, a batched
    call does its scalar arithmetic on float32 leaves and an unbatched one
    on Python floats.
    """
    dev = resolve_device(device)
    if delay_max is None:
        delay_max = scenarios.t_clk
    dmax = torch.as_tensor(delay_max, dtype=_F32)
    batch = tuple(torch.broadcast_shapes(scenarios.batch_shape,
                                         tuple(dmax.shape)))

    def leaf(name):
        """Python float (unbatched), else float32 ``(B, 1)``."""
        v = getattr(scenarios, name)
        if not batch:
            return (torch.as_tensor(v, dtype=_F32).reshape(()).to(dev)
                    if isinstance(v, torch.Tensor) else float(v))
        v = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v, dtype=_F32)
        return torch.broadcast_to(v, batch).reshape(-1, 1).to(dev)

    params, poly = params.to(dev), poly.to(dev)
    rates = aging.stress_rates(
        params, duty=leaf("duty"), toggle=leaf("toggle"),
        t_clk=leaf("t_clk"), transition_time=leaf("transition_time"),
        recovery=recovery)                          # (6,) or (B, 6)
    tgrid = _logspace(leaf("t_start"), leaf("lifetime_s"),
                      scenarios.n_steps, dev)       # (T,) or (B, T)
    zero = torch.zeros(tgrid.shape[:-1] + (1,), dtype=_F32, device=dev)
    dts = torch.diff(tgrid, dim=-1, prepend=zero)
    t_amb = leaf("t_amb")
    flat = lambda x: x.reshape(-1) if isinstance(x, torch.Tensor) else x
    v_step, v_ceiling = flat(leaf("v_step")), flat(leaf("v_max")) - 1e-6
    flat_dmax = torch.broadcast_to(dmax, batch).reshape(-1).to(dev)
    B = flat_dmax.shape[0]

    dv = torch.zeros((B, aging.N_POP), dtype=_F32, device=dev)
    v = torch.as_tensor(flat(leaf("v_init")), dtype=_F32,
                        device=dev).expand(B)
    out = {k: [] for k in ("V", "delay", "dvp", "dvn", "dv")}
    for i in range(scenarios.n_steps):
        dv = aging.update_state(params, dv, v[:, None], rates,
                                dts[..., i:i + 1], t_amb)
        dvp, dvn = aging.totals(dv)
        dp_v, dn_v = dvp * 1e-3, dvn * 1e-3
        delay = poly(dp_v, dn_v, v)
        if avs_enabled:
            for _ in range(scenarios.max_boosts_per_step):
                boost = (delay > flat_dmax) & (v < v_ceiling)
                v = torch.where(boost, v + v_step, v)
                delay = torch.where(boost, poly(dp_v, dn_v, v), delay)
        for k, val in (("V", v), ("delay", delay), ("dvp", dvp),
                       ("dvn", dvn), ("dv", dv)):
            out[k].append(val)
    host = {k: torch.stack(vals, dim=1).cpu().numpy()
            for k, vals in out.items()}
    T = scenarios.n_steps
    return LifetimeTrajectory(
        t=np.broadcast_to(tgrid.cpu().numpy(), (B, T)).reshape(batch + (T,)),
        V=host["V"].reshape(batch + (T,)),
        delay=host["delay"].reshape(batch + (T,)),
        dvp=host["dvp"].reshape(batch + (T,)),
        dvn=host["dvn"].reshape(batch + (T,)),
        dv=host["dv"].reshape(batch + (T, aging.N_POP)))


def run_lifetime(params: AgingParams, poly: DelayPolynomial,
                 cfg: LifetimeConfig = LifetimeConfig(), *,
                 delay_max=T_CLK, recovery: bool = True,
                 avs_enabled: bool = True, device="cuda") -> Dict[str, Any]:
    """One scalar config; returns the dict-of-arrays trajectory
    (``t, V, delay, dvp, dvn, dv``)."""
    return simulate(params, poly, cfg.scenario(), delay_max=delay_max,
                    recovery=recovery, avs_enabled=avs_enabled,
                    device=device).to_dict()


def final_shifts(traj) -> Dict[str, float]:
    """End-of-life (ΔVth_p, ΔVth_n) in mV and final V."""
    if isinstance(traj, LifetimeTrajectory):
        traj = traj.to_dict()
    return {"dvp": float(np.asarray(traj["dvp"])[-1]),
            "dvn": float(np.asarray(traj["dvn"])[-1]),
            "v_final": float(np.asarray(traj["V"])[-1])}


def per_population_finals(traj) -> Dict[str, float]:
    """End-of-life shift [mV] of each of the six trap populations."""
    if isinstance(traj, LifetimeTrajectory):
        traj = traj.to_dict()
    dv = np.asarray(traj["dv"])[-1]
    return {name: float(dv[i]) for i, name in enumerate(aging.POPULATIONS)}
