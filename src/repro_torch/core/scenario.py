"""Mission profiles and lifetime trajectories (port of the parts of
``repro.core.scenario`` that ``simulate`` and ``FleetRuntime`` use).

A :class:`Scenario` bundles every knob of one lifetime simulation.  Leaves
are Python floats, numpy arrays or float32 tensors, and may carry batch
dimensions that broadcast against each other: a ``(N,)``-batched scenario
is N mission profiles (per-device duty, temperature, budget, horizon),
which :func:`repro_torch.core.avs.simulate` runs in one batched call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .constants import (DEFAULT_MAX_LOSS_PCT, DUTY_FACTOR, LIFETIME_S, T_AMB,
                        T_CLK, TOGGLE_RATE, TRANSITION_TIME, V_MAX, V_NOM,
                        V_STEP)

SCENARIO_FIELDS = (
    "t_clk", "v_init", "v_step", "v_max",
    "duty", "toggle", "transition_time", "t_amb",
    "lifetime_s", "t_start", "max_loss_pct",
)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One mission profile (or a broadcastable batch of them)."""
    t_clk: Any = T_CLK                  # clock period [s]
    v_init: Any = V_NOM                 # initial supply [V]
    v_step: Any = V_STEP                # AVS increment [V]
    v_max: Any = V_MAX                  # supply ceiling [V]
    duty: Any = DUTY_FACTOR             # BTI duty factor
    toggle: Any = TOGGLE_RATE           # HCI toggle rate
    transition_time: Any = TRANSITION_TIME   # output transition [s]
    t_amb: Any = T_AMB                  # ambient temperature [K]
    lifetime_s: Any = LIFETIME_S        # simulated horizon [s]
    t_start: Any = 600.0                # first grid point [s]
    max_loss_pct: Any = DEFAULT_MAX_LOSS_PCT    # accuracy budget [% loss]
    n_steps: int = 480                  # log-spaced grid points
    max_boosts_per_step: int = 4        # boost loop bound per grid step

    @property
    def batch_shape(self) -> tuple:
        return tuple(torch.broadcast_shapes(
            *(tuple(np.shape(getattr(self, f))) for f in SCENARIO_FIELDS)))

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    def map_leaves(self, fn) -> "Scenario":
        return self.replace(**{
            f: fn(torch.as_tensor(getattr(self, f), dtype=torch.float32))
            for f in SCENARIO_FIELDS})

    def expand_dims(self, axis: int = -1) -> "Scenario":
        """Insert a broadcast axis on every leaf (e.g. the operator axis)."""
        return self.map_leaves(lambda x: x.unsqueeze(axis))

    @classmethod
    def from_lifetime_config(cls, cfg,
                             max_loss_pct: float = DEFAULT_MAX_LOSS_PCT,
                             **overrides) -> "Scenario":
        kw = dict(
            t_clk=cfg.t_clk, v_init=cfg.v_init, v_step=cfg.v_step,
            v_max=cfg.v_max, duty=cfg.duty, toggle=cfg.toggle,
            transition_time=cfg.transition_time, t_amb=cfg.t_amb,
            lifetime_s=cfg.lifetime_s, t_start=cfg.t_start,
            max_loss_pct=max_loss_pct,
            n_steps=cfg.n_steps, max_boosts_per_step=cfg.max_boosts_per_step,
        )
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class LifetimeTrajectory:
    """Result of :func:`repro_torch.core.avs.simulate`, as host numpy
    arrays: series ``batch_shape + (T,)``; ``dv`` has a trailing population
    axis."""
    t: np.ndarray           # wall-clock grid [s]
    V: np.ndarray           # supply voltage [V]
    delay: np.ndarray       # critical-path delay [s]
    dvp: np.ndarray         # PMOS ΔVth [mV]
    dvn: np.ndarray         # NMOS ΔVth [mV]
    dv: np.ndarray          # per-population shifts [mV]

    _FIELDS = ("t", "V", "delay", "dvp", "dvn", "dv")

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.V.shape[:-1])

    def to_dict(self) -> Dict[str, np.ndarray]:
        return {f: getattr(self, f) for f in self._FIELDS}

    def __getitem__(self, idx) -> "LifetimeTrajectory":
        return LifetimeTrajectory(*(getattr(self, f)[idx]
                                    for f in self._FIELDS))

    def age_index(self, age_s) -> np.ndarray:
        """Grid index of wall-clock age(s) per batch cell (vectorised)."""
        t = np.asarray(self.t)
        age = np.asarray(age_s, np.float64)
        age_b = np.broadcast_to(age, self.batch_shape) if self.batch_shape \
            else age
        idx = (t < age_b[..., None]).sum(axis=-1)
        return np.clip(idx, 0, t.shape[-1] - 1)
