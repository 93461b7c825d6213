"""Voltage-scaling policies (port of ``repro.core.policy``).

A policy maps a :class:`Scenario` to per-operator ``delay_max`` thresholds,
``thresholds(scenario, operators) -> float32 tensor batch_shape + (O,)``.

* :class:`BaselinePolicy` — classical AVS: ``delay_max = t_clk`` for every
  operator domain.
* :class:`FaultTolerantPolicy` — per-operator ``delay_max`` from inverting
  the resilience curve at the accuracy budget, then the BER curve.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from .aging import AgingParams
from .avs import LifetimeConfig, simulate
from .ber import BerModel
from .constants import T_CLK
from .delay import DelayPolynomial
from .power import PowerModel, batched_lifetime_stats
from .resilience import OPERATORS, ResilienceCurve, default_curves
from .scenario import Scenario

_F32 = torch.float32


def _broadcast_leaf(value, batch_shape) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(value, dtype=_F32),
                              batch_shape)


@dataclasses.dataclass(frozen=True)
class BaselinePolicy:
    """Classical AVS: the threshold IS the scenario's clock period."""
    name = "baseline"
    t_clk: float = T_CLK

    def thresholds(self, scenario: Scenario,
                   operators: tuple = OPERATORS) -> torch.Tensor:
        t = _broadcast_leaf(scenario.t_clk, scenario.batch_shape)
        return torch.broadcast_to(t[..., None], scenario.batch_shape
                                  + (len(operators),))


@dataclasses.dataclass(frozen=True)
class FaultTolerantPolicy:
    """``max_loss_pct=None`` takes the budget from the scenario."""
    name = "fault_tolerant"
    ber_model: BerModel
    max_loss_pct: float | None = None
    curves: Mapping[str, ResilienceCurve] | None = None

    def _curves_for(self, operators) -> Mapping[str, ResilienceCurve]:
        return self.curves or default_curves(tuple(operators))

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
