"""Serving-time integration of the AVS policy (port of
``repro.core.fleet`` without traffic, mesh shards and state round-trips).

:class:`FleetRuntime` holds N devices x O operator voltage domains.  All
N x O lifetime trajectories come from one batched :func:`simulate` call
(lazy, cached): devices share one mission profile (a scalar
:class:`Scenario`, whose O trajectories are broadcast over the fleet) or
carry their own (a ``(N,)``-batched scenario: per-device duty,
temperature, budget and time grid).  Device ages are a vector and the age
-> state lookup is one vectorised search.  :meth:`FleetRuntime.for_model`
picks the operator domains of a model's family; :meth:`op_ber_array` is
the ``(N, O)`` BER matrix the fleet serving engine hands its lanes, and
:meth:`FleetRuntime.device` the single-device view the serving engine
consumes.  The BERs stay host floats: the kernels take the upset
probability by value.  Traffic-driven aging (``apply_load``), mesh shards
(``n_shards > 1``), resize and state round-trips are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np

from ..device import resolve_device
from .artifacts import Calibration, load_calibration
from .avs import simulate
from .constants import DEFAULT_MAX_LOSS_PCT
from .policy import BaselinePolicy, FaultTolerantPolicy
from .resilience import OPERATORS, default_curves, operators_for
from .scenario import LifetimeTrajectory, Scenario

SECONDS_PER_YEAR = 365.25 * 24 * 3600.0


@dataclasses.dataclass
class DomainState:
    """Snapshot of one operator voltage domain at the current age."""
    v_dd: float
    delay: float
    dvth_p_mv: float
    dvth_n_mv: float
    ber: float
    power_w: float


@dataclasses.dataclass(frozen=True)
class FleetState:
    """Snapshot of the whole fleet; every field has shape ``(N, O)``."""
    v_dd: np.ndarray
    delay: np.ndarray
    dvth_p_mv: np.ndarray
    dvth_n_mv: np.ndarray
    ber: np.ndarray
    power_w: np.ndarray

    def domain(self, device: int, op_idx: int) -> DomainState:
        return DomainState(**{
            f.name: float(getattr(self, f.name)[device, op_idx])
            for f in dataclasses.fields(self)})


class FleetRuntime:
    """N aging accelerators x O operator voltage domains, vectorised."""

    def __init__(self, cal: Optional[Calibration] = None, *,
                 n_devices: int = 1, n_shards: int = 1,
                 scenario: Optional[Scenario] = None,
                 policy="fault_tolerant",
                 max_loss_pct: float = DEFAULT_MAX_LOSS_PCT,
                 operators: tuple = OPERATORS, curves=None, device="cuda"):
        """``max_loss_pct`` sets the budget of the default scenario; an
        explicit ``scenario`` (scalar or ``(n_devices,)``-batched) brings
        its own ``max_loss_pct`` leaf, and a batched one sets
        ``n_devices``."""
        self.torch_device = resolve_device(device)
        if n_shards != 1:
            raise NotImplementedError("mesh shards (n_shards > 1) are not "
                                      "ported")
        self.cal = cal or load_calibration()
        self.operators = tuple(operators)
        if policy == "fault_tolerant":
            policy = FaultTolerantPolicy(ber_model=self.cal.ber,
                                         curves=curves)
        elif policy == "baseline":
            policy = BaselinePolicy(t_clk=self.cal.lifetime_cfg.t_clk)
        elif isinstance(policy, str):
            raise KeyError(f"policy {policy!r} is not ported; pass a policy "
                           "object, 'fault_tolerant' or 'baseline'")
        self.policy = policy
        if scenario is None:
            scenario = Scenario.from_lifetime_config(self.cal.lifetime_cfg,
                                                     max_loss_pct)
        sbatch = scenario.batch_shape
        if len(sbatch) > 1:
            raise ValueError(f"scenarios must be scalar or (n_devices,)-"
                             f"batched, got batch shape {sbatch}")
        if sbatch:
            if n_devices not in (1, sbatch[0]):
                raise ValueError(f"n_devices={n_devices} conflicts with the "
                                 f"scenario batch {sbatch}")
            n_devices = sbatch[0]
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
        """(N, O, T) trajectories from one simulation over the O domains
        (of every device's profile, when the scenario is batched)."""
        if self._traj is None:
            dmax = self.policy.thresholds(self.scenario, self.operators)
            traj = simulate(self.cal.aging, self.cal.delay_poly,
                            self.scenario.expand_dims(-1), delay_max=dmax,
                            device=self.torch_device)
            target = lambda v: (self.n_devices,) + v.shape[
                len(self.scenario.batch_shape):]
            self._traj = LifetimeTrajectory(**{
                k: np.broadcast_to(v, target(v))
                for k, v in traj.to_dict().items()})
        return self._traj

    @property
    def trajectories(self) -> LifetimeTrajectory:
        """(N, O, T) lifetime trajectories (lazily computed, cached)."""
        return self._ensure_trajs()

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
    def ages_years(self) -> np.ndarray:
        """(N,) device ages in years."""
        return self._ages_s / SECONDS_PER_YEAR

    @property
    def age_years(self) -> float:
        """Device 0's age (a fleet-uniform convenience)."""
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

    def op_index(self, op: str) -> int:
        return self.operators.index(op)

    def domain_state(self, op: str, device: int = 0) -> DomainState:
        return self.snapshot().domain(device, self.op_index(op))

    def op_ber(self, op: str, device: int = 0) -> float:
        return self.op_bers(device)[op]

    def op_bers(self, device: int = 0) -> Dict[str, float]:
        ber = self.snapshot().ber[device]
        return {op: float(ber[i]) for i, op in enumerate(self.operators)}

    def op_ber_array(self) -> np.ndarray:
        """(N, O) BER matrix, columns ordered as ``self.operators``: what
        the fleet serving engine hands its lanes."""
        return self.snapshot().ber

    def fleet_power(self) -> np.ndarray:
        """(N,) per-device array power [W]."""
        return self.snapshot().power_w.sum(axis=-1)

    def total_power(self, device: int = 0) -> float:
        return float(self.fleet_power()[device])

    def summary(self, device: int = 0) -> Mapping[str, Dict]:
        s = self.snapshot()
        return {op: dataclasses.asdict(s.domain(device, i))
                for i, op in enumerate(self.operators)}

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
    def cal(self) -> Calibration:
        return self.fleet.cal

    @property
    def operators(self) -> tuple:
        return self.fleet.operators

    @property
    def policy(self):
        return self.fleet.policy

    @property
    def age_years(self) -> float:
        return float(self.fleet._ages_s[self.index]) / SECONDS_PER_YEAR

    def set_age(self, *, years=None, seconds=None):
        self.fleet.set_age(years=years, seconds=seconds, device=self.index)

    def advance(self, seconds):
        self.fleet.advance(seconds, device=self.index)

    def domain_state(self, op: str) -> DomainState:
        return self.fleet.domain_state(op, device=self.index)

    def op_ber(self, op: str) -> float:
        return self.fleet.op_ber(op, device=self.index)

    def op_bers(self) -> Dict[str, float]:
        return self.fleet.op_bers(self.index)

    def total_power(self) -> float:
        return self.fleet.total_power(self.index)

    def summary(self) -> Mapping[str, Dict]:
        return self.fleet.summary(self.index)
