"""Serving-time integration of the AVS policy (port of the one-mission-
profile subset of ``repro.core.fleet``).

:class:`FleetRuntime` holds N devices x O operator voltage domains.  All
O lifetime trajectories come from one batched :func:`simulate` call (lazy,
cached) shared by every device; device ages are a vector and the age ->
state lookup is one vectorised search.  :meth:`FleetRuntime.for_model`
picks the operator domains of a model's family.  :meth:`FleetRuntime.device`
returns the single-device view the serving engine consumes.  Traffic-
driven aging (``apply_load``), mesh shards, resize and state round-trips
are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..device import resolve_device
from .artifacts import Calibration, load_calibration
from .avs import simulate
from .constants import DEFAULT_MAX_LOSS_PCT
from .policy import FaultTolerantPolicy
from .resilience import OPERATORS, default_curves, operators_for
from .scenario import LifetimeTrajectory, Scenario

SECONDS_PER_YEAR = 365.25 * 24 * 3600.0


@dataclasses.dataclass(frozen=True)
class FleetState:
    """Snapshot of the whole fleet; every field has shape ``(N, O)``."""
    v_dd: np.ndarray
    delay: np.ndarray
    dvth_p_mv: np.ndarray
    dvth_n_mv: np.ndarray
    ber: np.ndarray
    power_w: np.ndarray


class FleetRuntime:
    """N aging accelerators x O operator voltage domains, vectorised."""

    def __init__(self, cal: Optional[Calibration] = None, *,
                 n_devices: int = 1, scenario: Optional[Scenario] = None,
                 policy="fault_tolerant",
                 max_loss_pct: float = DEFAULT_MAX_LOSS_PCT,
                 operators: tuple = OPERATORS, curves=None, device="cuda"):
        self.torch_device = resolve_device(device)
        self.cal = cal or load_calibration()
        self.operators = tuple(operators)
        if policy == "fault_tolerant":
            policy = FaultTolerantPolicy(ber_model=self.cal.ber,
                                         curves=curves)
        elif isinstance(policy, str):
            raise KeyError(f"policy {policy!r} is not ported; pass a policy "
                           "object or 'fault_tolerant'")
        self.policy = policy
        if scenario is None:
            scenario = Scenario.from_lifetime_config(self.cal.lifetime_cfg,
                                                     max_loss_pct)
        if scenario.batch_shape:
            raise NotImplementedError("per-device scenario batches are not "
                                      "ported")
        self.scenario = scenario
        self.n_devices = int(n_devices)
        self._power = self.cal.power
        self._ages_s = np.zeros(self.n_devices, np.float64)
        self._traj: Optional[LifetimeTrajectory] = None
        self._snap: Optional[FleetState] = None

    @classmethod
    def for_model(cls, cfg, **kw) -> "FleetRuntime":
        """Fleet with the architecture family's operator-domain set (an MoE
        model adds its ``router`` domain) and those domains' default
        resilience curves."""
        ops = operators_for(cfg.family)
        return cls(operators=ops, curves=default_curves(ops), **kw)

    def _ensure_trajs(self) -> LifetimeTrajectory:
        """(N, O, T) trajectories from one simulation over the O domains."""
        if self._traj is None:
            dmax = self.policy.thresholds(self.scenario, self.operators)
            traj = simulate(self.cal.aging, self.cal.delay_poly,
                            self.scenario.expand_dims(-1), delay_max=dmax,
                            device=self.torch_device)
            target = lambda v: (self.n_devices,) + v.shape
            self._traj = LifetimeTrajectory(**{
                k: np.broadcast_to(v, target(v))
                for k, v in traj.to_dict().items()})
        return self._traj

    def set_age(self, *, years=None, seconds=None, device=None):
        """Set the simulated age of one device (or the whole fleet)."""
        if (years is None) == (seconds is None):
            raise ValueError("pass exactly one of years= and seconds=")
        age = float(seconds if seconds is not None
                    else years * SECONDS_PER_YEAR)
        self._ages_s[slice(None) if device is None else device] = age
        self._snap = None

    def advance(self, seconds, device=None):
        sel = slice(None) if device is None else device
        self._ages_s[sel] = self._ages_s[sel] + np.asarray(seconds,
                                                           np.float64)
        self._snap = None

    @property
    def age_years(self) -> float:
        return float(self._ages_s[0]) / SECONDS_PER_YEAR

    def snapshot(self) -> FleetState:
        """State of every (device, operator) domain at the current ages."""
        if self._snap is None:
            traj = self._ensure_trajs()
            idx = traj.age_index(self._ages_s[:, None])[..., None]
            pick = lambda k: np.take_along_axis(
                np.asarray(getattr(traj, k)), idx, axis=-1)[..., 0]
            v, delay = pick("V"), pick("delay")
            dvp, dvn = pick("dvp"), pick("dvn")
            ber = self.cal.ber.ber_from_delay(delay).numpy()
            power = self._power.power(v, dvp, dvn).numpy()
            self._snap = FleetState(v_dd=v, delay=delay, dvth_p_mv=dvp,
                                    dvth_n_mv=dvn, ber=ber, power_w=power)
        return self._snap

    def op_bers(self, device: int = 0) -> Dict[str, float]:
        ber = self.snapshot().ber[device]
        return {op: float(ber[i]) for i, op in enumerate(self.operators)}

    def total_power(self, device: int = 0) -> float:
        return float(self.snapshot().power_w[device].sum())

    def device(self, i: int = 0) -> "DeviceView":
        if not 0 <= i < self.n_devices:
            raise IndexError(f"device {i} of {self.n_devices}")
        return DeviceView(self, i)


class DeviceView:
    """Single-device facade over a :class:`FleetRuntime` — the protocol the
    serving engine consumes."""

    def __init__(self, fleet: FleetRuntime, index: int):
        self.fleet = fleet
        self.index = index

    @property
    def age_years(self) -> float:
        return float(self.fleet._ages_s[self.index]) / SECONDS_PER_YEAR

    def set_age(self, *, years=None, seconds=None):
        self.fleet.set_age(years=years, seconds=seconds, device=self.index)

    def advance(self, seconds):
        self.fleet.advance(seconds, device=self.index)

    def op_bers(self) -> Dict[str, float]:
        return self.fleet.op_bers(self.index)

    def total_power(self) -> float:
        return self.fleet.total_power(self.index)
