"""Voltage-scaling policies (port of ``repro.core.policy``).

A policy maps a :class:`Scenario` to per-operator ``delay_max`` thresholds,
``thresholds(scenario, operators) -> float32 tensor batch_shape + (O,)``,
so a whole sweep (budgets x mission profiles x operator domains) runs as
one batched :func:`simulate` (:func:`sweep_policy`).

* :class:`BaselinePolicy` — classical AVS: ``delay_max = t_clk`` for every
  operator domain.
* :class:`FaultTolerantPolicy` — per-operator ``delay_max`` from inverting
  the resilience curve at the accuracy budget, then the BER curve.

* :class:`MeasuredResiliencePolicy` — the fault-tolerant policy on
  curves measured in-repo by the fault-injection sweep (the artifact of
  :mod:`repro_torch.calibrate.resilience_sweep`).

Policies register by name (:func:`register_policy`) and are built with
:func:`get_policy`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Protocol, runtime_checkable

import numpy as np
import torch

from .aging import AgingParams
from .avs import LifetimeConfig, simulate
from .ber import BerModel
from .constants import DEFAULT_MAX_LOSS_PCT, T_CLK
from .delay import DelayPolynomial
from .power import PowerModel, batched_lifetime_stats
from .resilience import (OPERATORS, ResilienceCurve, default_curves,
                         measured_curves, tolerable_bers)
from .scenario import LifetimeTrajectory, Scenario

_F32 = torch.float32


def _broadcast_leaf(value, batch_shape) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(value, dtype=_F32),
                              batch_shape)


@runtime_checkable
class Policy(Protocol):
    """Anything that maps scenarios to per-operator delay thresholds."""

    def thresholds(self, scenario: Scenario,
                   operators: tuple = OPERATORS) -> torch.Tensor:
        """Per-operator delay_max [s], shape ``batch_shape + (O,)``."""
        ...


POLICY_REGISTRY: Dict[str, type] = {}


def register_policy(cls):
    """Class decorator: register a policy under its ``name`` attribute."""
    POLICY_REGISTRY[cls.name] = cls
    return cls


def get_policy(name: str, **kw):
    """Instantiate a registered policy by name."""
    try:
        return POLICY_REGISTRY[name](**kw)
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; registered: "
                       f"{sorted(POLICY_REGISTRY)}") from None


@register_policy
@dataclasses.dataclass(frozen=True)
class BaselinePolicy:
    """Classical AVS: the threshold IS the scenario's clock period.  The
    ``t_clk`` field only serves the scenario-free :meth:`delay_max`."""
    name = "baseline"
    t_clk: float = T_CLK

    def thresholds(self, scenario: Scenario,
                   operators: tuple = OPERATORS) -> torch.Tensor:
        t = _broadcast_leaf(scenario.t_clk, scenario.batch_shape)
        return torch.broadcast_to(t[..., None], scenario.batch_shape
                                  + (len(operators),))

    def delay_max(self) -> Dict[str, float]:
        return {op: self.t_clk for op in OPERATORS}


@register_policy
@dataclasses.dataclass(frozen=True)
class FaultTolerantPolicy:
    """``max_loss_pct=None`` takes the budget from the scenario; a float
    pins it (and is the budget of the scenario-free :meth:`delay_max`)."""
    name = "fault_tolerant"
    ber_model: BerModel
    max_loss_pct: float | None = None
    curves: Mapping[str, ResilienceCurve] | None = None

    def _budget_scalar(self) -> float:
        return DEFAULT_MAX_LOSS_PCT if self.max_loss_pct is None \
            else self.max_loss_pct

    def _curves_for(self, operators) -> Mapping[str, ResilienceCurve]:
        return self.curves or default_curves(tuple(operators))

    def tolerable_ber(self) -> Dict[str, float]:
        """Each operator's tolerable BER at the budget (Python floats)."""
        return tolerable_bers(dict(self._curves_for(OPERATORS)),
                              self._budget_scalar())

    def delay_max(self) -> Dict[str, float]:
        """Each operator's delay threshold [s] at the budget."""
        return {op: self.ber_model.delay_max_for_ber(tol)
                for op, tol in self.tolerable_ber().items()}

    def thresholds(self, scenario: Scenario,
                   operators: tuple = OPERATORS) -> torch.Tensor:
        """Invert the resilience curves at the budget, then the BER curve,
        in float32 as the reference does."""
        curves = self._curves_for(tuple(operators))
        f32 = lambda vals: torch.tensor(np.asarray(vals, np.float64),
                                        dtype=_F32)
        log_b50 = f32(np.log10([curves[op].ber50 for op in operators]))
        steep = f32([curves[op].steepness for op in operators])
        lmax = f32([curves[op].l_max for op in operators])
        budget_src = scenario.max_loss_pct if self.max_loss_pct is None \
            else self.max_loss_pct
        batch = scenario.batch_shape
        budget = _broadcast_leaf(budget_src, batch)[..., None]
        frac = torch.clamp(budget / lmax, 1e-9, 1.0 - 1e-9)
        x = torch.log(frac / (1.0 - frac))
        tol = 10.0 ** (log_b50 + x / steep)
        d = self.ber_model.delay_for_ber(tol)
        t_clk = _broadcast_leaf(scenario.t_clk, batch)[..., None]
        return torch.maximum(d, t_clk).to(_F32)


@register_policy
@dataclasses.dataclass(frozen=True)
class MeasuredResiliencePolicy(FaultTolerantPolicy):
    """The fault-tolerant policy driven by curves measured in-repo: the
    per-``model`` fits of the fault-injection sweep, read from the
    measured-resilience artifact (``artifact_path``, default the port's
    ``resilience_calibrated.json``).  Operators the artifact does not
    cover take the published defaults; explicit ``curves`` override the
    artifact entirely."""
    name = "measured"
    model: str = "llama3_8b"
    artifact_path: str | None = None

    def _curves_for(self, operators) -> Mapping[str, ResilienceCurve]:
        if self.curves is not None:
            return FaultTolerantPolicy._curves_for(self, operators)
        measured = measured_curves(self.model, self.artifact_path)
        defaults = default_curves(tuple(operators))
        return {op: measured.get(op, defaults[op]) for op in operators}


def sweep_policy(policy: Policy, params: AgingParams, poly: DelayPolynomial,
                 scenarios: Scenario, *, operators: tuple = OPERATORS,
                 recovery: bool = True, device="cuda") -> LifetimeTrajectory:
    """Run a policy over a scenario batch as one batched simulation: the
    result's batch shape is ``scenarios.batch_shape + (O,)`` (the leaves
    gain a trailing operator axis, matched by the policy's thresholds)."""
    dmax = policy.thresholds(scenarios, operators)
    return simulate(params, poly, scenarios.expand_dims(-1), delay_max=dmax,
                    recovery=recovery, device=device)


def evaluate_policy(policy, params: AgingParams, poly: DelayPolynomial,
                    power: PowerModel,
                    cfg: LifetimeConfig | Scenario = LifetimeConfig(), *,
                    device="cuda") -> Dict[str, Dict]:
    """Lifetime of every operator domain under ``policy`` plus the
    ``baseline`` row (classical AVS), as one batched simulation.

    Returns ``{operator: {v_final, dvp_final, dvn_final, v_eff, p_avg,
    power_saving_pct, delay_max, traj}}``, ``baseline`` and
    ``avg_power_saving_pct`` — the paper's Table I/II numbers.
    """
    if isinstance(cfg, Scenario):
        scn = cfg
    else:
        budget = getattr(policy, "max_loss_pct", None)
        scn = cfg.scenario() if budget is None else cfg.scenario(budget)
    if scn.batch_shape != ():
        raise ValueError("evaluate_policy takes one scenario")
    ops = list(OPERATORS)
    dmax = policy.thresholds(scn, tuple(ops))                # (O,)
    dmax_all = torch.cat([dmax, torch.as_tensor(scn.t_clk,
                                                dtype=_F32).reshape(1)])
    trajs = simulate(params, poly, scn, delay_max=dmax_all, device=device)
    stats = batched_lifetime_stats(power, trajs)

    base_stats = {k: float(v[len(ops)]) for k, v in stats.items()}
    out: Dict[str, Dict] = {"baseline": dict(
        base_stats, traj=trajs[len(ops)].to_dict())}
    for i, op in enumerate(ops):
        st = {k: float(v[i]) for k, v in stats.items()}
        st["power_saving_pct"] = 100.0 * (1.0 - st["p_avg"]
                                          / base_stats["p_avg"])
        st["delay_max"] = float(dmax[i])
        out[op] = dict(st, traj=trajs[i].to_dict())
    out["avg_power_saving_pct"] = float(np.mean(
        [out[op]["power_saving_pct"] for op in ops]))
    return out
