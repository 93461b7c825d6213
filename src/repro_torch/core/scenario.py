"""Mission profiles and lifetime trajectories (port of
``repro.core.scenario``).

A :class:`Scenario` bundles every knob of one lifetime simulation.  Leaves
are Python floats, numpy arrays or float32 tensors, and may carry batch
dimensions that broadcast against each other: a ``(N,)``-batched scenario
is N mission profiles (per-device duty, temperature, budget, horizon),
and ``scenario_grid(max_loss_pct=[...], duty=[...])`` a 2-D sweep whose
swept leaves have shapes ``(3, 1)`` and ``(1, 3)``.
:func:`repro_torch.core.avs.simulate` runs any such batch in one batched
call and returns a :class:`LifetimeTrajectory` of the broadcast shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

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
        """Common broadcast shape of all leaves; ``()`` for a single one."""
        return tuple(torch.broadcast_shapes(
            *(tuple(np.shape(getattr(self, f))) for f in SCENARIO_FIELDS)))

    @property
    def n_scenarios(self) -> int:
        return math.prod(self.batch_shape)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    def map_leaves(self, fn) -> "Scenario":
        return self.replace(**{
            f: fn(torch.as_tensor(getattr(self, f), dtype=torch.float32))
            for f in SCENARIO_FIELDS})

    def expand_dims(self, axis: int = -1) -> "Scenario":
        """Insert a broadcast axis on every leaf (e.g. the operator axis)."""
        return self.map_leaves(lambda x: x.unsqueeze(axis))

    def broadcast_leaves(self, shape=None) -> "Scenario":
        """Materialise every leaf at the (given or common) batch shape."""
        shape = self.batch_shape if shape is None else tuple(shape)
        return self.map_leaves(
            lambda x: torch.broadcast_to(x, shape).contiguous())

    def reshape(self, shape) -> "Scenario":
        return self.broadcast_leaves().map_leaves(
            lambda x: x.reshape(tuple(shape)))

    def __getitem__(self, idx) -> "Scenario":
        """Index into the batch (after materialising the broadcast)."""
        return self.broadcast_leaves().map_leaves(lambda x: x[idx])

    @classmethod
    def nominal(cls, **overrides) -> "Scenario":
        """The paper's operating point (Sec. V-A) with optional overrides."""
        return cls(**overrides)

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

    def to_dict(self) -> Dict[str, Any]:
        """Every leaf as (nested) Python floats, and the static fields."""
        d = {f: _host(getattr(self, f)).tolist() for f in SCENARIO_FIELDS}
        d["n_steps"] = self.n_steps
        d["max_boosts_per_step"] = self.max_boosts_per_step
        return d


def _host(leaf) -> np.ndarray:
    return leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)


def stack_scenarios(scenarios: Sequence[Scenario], axis: int = 0) -> Scenario:
    """Stack single (or same-shape) scenarios into one batched Scenario;
    their static structure (grid length, boost bound) must agree."""
    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("need at least one scenario")
    aux0 = (scenarios[0].n_steps, scenarios[0].max_boosts_per_step)
    if any((s.n_steps, s.max_boosts_per_step) != aux0 for s in scenarios):
        raise ValueError("cannot stack scenarios with different static "
                         "structure")
    shape = torch.broadcast_shapes(*(s.batch_shape for s in scenarios))
    mats = [s.broadcast_leaves(shape) for s in scenarios]
    return scenarios[0].replace(**{
        f: torch.stack([getattr(m, f) for m in mats], dim=axis)
        for f in SCENARIO_FIELDS})


def scenario_grid(base: Scenario | None = None, **axes) -> Scenario:
    """Cartesian product of scenario knobs as an N-D broadcastable batch:
    the i-th swept leaf has shape ``(1,)*i + (len_i,) + (1,)*(N-1-i)``, so
    the batch shape is the full grid without materialising any leaf."""
    for name in axes:
        if name not in SCENARIO_FIELDS:
            raise ValueError(f"unknown scenario field {name!r}")
    base = base or Scenario.nominal()
    ndim = len(axes)
    leaves = {}
    for i, (name, values) in enumerate(axes.items()):
        v = torch.as_tensor(np.asarray(values, np.float64),
                            dtype=torch.float32).reshape(-1)
        leaves[name] = v.reshape((1,) * i + (v.shape[0],)
                                 + (1,) * (ndim - 1 - i))
    return base.replace(**leaves)


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

    @property
    def n_steps(self) -> int:
        return int(self.V.shape[-1])

    def to_dict(self) -> Dict[str, np.ndarray]:
        """The ``run_lifetime`` dict layout (keys t/V/delay/dvp/dvn/dv)."""
        return {f: getattr(self, f) for f in self._FIELDS}

    @classmethod
    def from_dict(cls, d) -> "LifetimeTrajectory":
        return cls(*(np.asarray(d[f]) for f in cls._FIELDS))

    def __getitem__(self, idx) -> "LifetimeTrajectory":
        return LifetimeTrajectory(*(getattr(self, f)[idx]
                                    for f in self._FIELDS))

    def reshape(self, batch_shape) -> "LifetimeTrajectory":
        bs, nb = tuple(batch_shape), len(self.batch_shape)
        return LifetimeTrajectory(**{
            f: getattr(self, f).reshape(bs + getattr(self, f).shape[nb:])
            for f in self._FIELDS})

    def final(self) -> Dict[str, np.ndarray]:
        """End-of-life snapshot over the whole batch."""
        return {"v_final": self.V[..., -1], "delay_final": self.delay[..., -1],
                "dvp": self.dvp[..., -1], "dvn": self.dvn[..., -1],
                "dv": self.dv[..., -1, :]}

    def age_index(self, age_s) -> np.ndarray:
        """Grid index of wall-clock age(s) per batch cell (vectorised)."""
        t = np.asarray(self.t)
        age = np.asarray(age_s, np.float64)
        age_b = np.broadcast_to(age, self.batch_shape) if self.batch_shape \
            else age
        idx = (t < age_b[..., None]).sum(axis=-1)
        return np.clip(idx, 0, t.shape[-1] - 1)

    def at_age(self, age_s) -> Dict[str, np.ndarray]:
        """Snapshot every series at the given wall-clock age(s)."""
        idx = self.age_index(age_s)[..., None]
        return {f: np.take_along_axis(getattr(self, f), idx, axis=-1)[..., 0]
                for f in ("V", "delay", "dvp", "dvn")}
