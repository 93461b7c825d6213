"""Serving-time integration of the AVS policy (port of
``repro.core.fleet``).

:class:`FleetRuntime` holds N devices x O operator voltage domains.  All
N x O lifetime trajectories come from one batched :func:`simulate` call
(lazy, and shared by every runtime of the process that asks for the same
one: :func:`_simulated`): devices share one mission profile (a scalar
:class:`Scenario`, whose O trajectories are broadcast over the fleet) or
carry their own (a ``(N,)``-batched scenario: per-device duty,
temperature, budget and time grid).  Device ages are a vector and the age
-> state lookup is one vectorised search.  :meth:`FleetRuntime.for_model`
picks the operator domains of a model's family; :meth:`op_ber_array` is
the ``(N, O)`` BER matrix the fleet serving engine hands its lanes, and
:meth:`FleetRuntime.device` the single-device view the serving engine
consumes.  The BERs stay host floats: the kernels take the upset
probability by value.

:meth:`FleetRuntime.apply_load` ages the fleet under routed traffic
instead (:func:`repro_torch.sched.lifetime.cosimulate`, on the fleet's
device) and serves from that trajectory; :meth:`trap_state`,
:meth:`state_dict` / :meth:`load_state_dict` and :meth:`resize` carry the
exact aging state across a restart or a retirement.

With ``n_shards=S > 1`` every device is split into S mesh shards (the
tensor-parallel partitions :class:`repro_torch.serve.sharded.
MeshServeEngine` serves), each an aging unit of its own: the fleet holds
``N * S`` units device-major (device ``d``'s shards are units ``d * S ..
d * S + S - 1``) and the machinery above runs over them unchanged.
:meth:`FleetRuntime.op_ber_shard_array` is the ``(N, S, O)`` view the mesh
engine serves; :meth:`FleetRuntime.op_ber_array` and ``op_bers`` take the
per-domain max over a device's shards (a domain is only as reliable as its
worst shard).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from .aging import N_POP
from .artifacts import Calibration, load_calibration
from .avs import simulate
from .constants import DEFAULT_MAX_LOSS_PCT
from .policy import (BaselinePolicy, FaultTolerantPolicy,
                     MeasuredResiliencePolicy, get_policy)
from .resilience import OPERATORS, default_curves, operators_for
from .scenario import LifetimeTrajectory, Scenario

SECONDS_PER_YEAR = 365.25 * 24 * 3600.0

# lifetime trajectories simulated in this process, keyed on all that
# :func:`simulate` reads (a simulation is ~500 host-driven steps)
_TRAJECTORIES: Dict[tuple, Any] = {}


def _leaf_key(x) -> tuple:
    a = np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)
    return a.dtype.str, a.shape, a.tobytes()


def _simulated(cal: Calibration, scenario: Scenario, delay_max, device):
    """``simulate`` of ``scenario`` (its O domains on the last axis) under
    ``cal``'s aging and delay models and ``delay_max``, on ``device``;
    made once per process for equal inputs (the cached result is never
    written: runtimes take read-only views of it)."""
    key = (str(device), json.dumps(cal.aging.to_dict()),
           json.dumps(cal.delay_poly.to_dict()), _leaf_key(delay_max),
           tuple((f.name, _leaf_key(getattr(scenario, f.name)))
                 for f in dataclasses.fields(scenario)))
    if key not in _TRAJECTORIES:
        _TRAJECTORIES[key] = simulate(cal.aging, cal.delay_poly,
                                      scenario.expand_dims(-1),
                                      delay_max=delay_max, device=device)
    return _TRAJECTORIES[key]


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
    """Snapshot of the whole fleet; every field has shape ``(N*S, O)``
    (aging units x operators; units are devices when unsharded)."""
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
        if int(n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.cal = cal or load_calibration()
        self.operators = tuple(operators)
        if policy == "fault_tolerant":
            # the budget is not pinned: thresholds read the scenario's
            # max_loss_pct, so per-device budgets batch
            policy = FaultTolerantPolicy(ber_model=self.cal.ber,
                                         curves=curves)
        elif policy == "baseline":
            policy = BaselinePolicy(t_clk=self.cal.lifetime_cfg.t_clk)
        elif policy == "measured":
            # the artifact's curves for the policy's default model; pass a
            # MeasuredResiliencePolicy (or use for_model) to pick another
            policy = get_policy("measured", ber_model=self.cal.ber,
                                curves=curves)
        elif isinstance(policy, str):
            policy = get_policy(policy)
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
        self.n_shards = int(n_shards)
        self._n_units = self.n_devices * self.n_shards
        if sbatch and self.n_shards > 1:
            # unit-granular scenario: every shard of a device inherits the
            # device's mission profile (device-major repeat)
            self._unit_scenario = scenario.map_leaves(
                lambda v: torch.repeat_interleave(v, self.n_shards, dim=0)
                if v.dim() else v)
        else:
            self._unit_scenario = scenario
        self._power = self.cal.power
        self._ages_s = np.zeros(self._n_units, np.float64)
        self._traj: Optional[LifetimeTrajectory] = None
        self._snap: Optional[FleetState] = None
        self._ber_shard: Optional[np.ndarray] = None
        # the relaxed-pool series of the last traffic co-sim ((N, O, T, P);
        # None for a monotone run), and an exact trap state staged by
        # load_state_dict / resize for the next apply_load to resume from
        self._rec_nop: Optional[np.ndarray] = None
        self._pending: Optional[Dict[str, np.ndarray]] = None

    @classmethod
    def for_model(cls, cfg, **kw) -> "FleetRuntime":
        """Fleet with the architecture family's operator-domain set (an MoE
        model adds its ``router`` domain) and those domains' default
        resilience curves; with ``policy="measured"``, the measured curves
        of this model (``cfg.name``), the defaults for any domain the
        artifact lacks."""
        ops = operators_for(cfg.family)
        if kw.get("policy") == "measured":
            cal = kw.setdefault("cal", load_calibration())
            kw["policy"] = MeasuredResiliencePolicy(ber_model=cal.ber,
                                                    model=cfg.name)
            return cls(operators=ops, **kw)
        return cls(operators=ops, curves=default_curves(ops), **kw)

    def _ensure_trajs(self) -> LifetimeTrajectory:
        """(N*S, O, T) trajectories from one simulation over the O domains
        (of every unit's profile, when the scenario is batched)."""
        if self._traj is None:
            scn = self._unit_scenario
            dmax = self.policy.thresholds(scn, self.operators)
            traj = _simulated(self.cal, scn, dmax, self.torch_device)
            target = lambda v: (self._n_units,) + v.shape[
                len(scn.batch_shape):]
            self._traj = LifetimeTrajectory(**{
                k: np.broadcast_to(v, target(v))
                for k, v in traj.to_dict().items()})
        return self._traj

    @property
    def trajectories(self) -> LifetimeTrajectory:
        """(N*S, O, T) lifetime trajectories (lazily computed, cached)."""
        return self._ensure_trajs()

    @property
    def unit_scenario(self) -> Scenario:
        """The per-aging-unit scenario: the device scenario when
        unsharded, its device-major shard repeat when ``n_shards > 1``."""
        return self._unit_scenario

    def health(self, **kw):
        """Fleet "aging odometer" snapshot
        (:func:`repro_torch.obs.health.fleet_health`)."""
        from ..obs.health import fleet_health
        return fleet_health(self, **kw)

    def apply_load(self, loads=None, *, workload="diurnal",
                   router="wear_level", util_trace=None,
                   n_epochs: int = 480, horizon_s: Optional[float] = None,
                   utilization: float = 0.5, key: int = 0,
                   capacity: float = 1.0,
                   heat_per_util: Optional[float] = None,
                   recovery=None, thermal=None):
        """Age the fleet under routed traffic instead of static stress.

        Runs :func:`repro_torch.sched.lifetime.cosimulate` on the fleet's
        device and replaces the cached trajectories with the
        traffic-driven ones, so ``snapshot``, ``op_ber_array`` and the
        serving engines see BERs of traffic-dependent age.

        ``loads`` is an ``(E,)`` offered-load trace; otherwise
        ``workload`` names a registered arrival model (or is a
        :class:`repro_torch.sched.workload.Workload`) sized by
        ``utilization`` and drawn from ``key``.  ``util_trace`` (``(E,
        N)`` measured utilization) bypasses the router and replays the
        measured duty.  The co-simulation resumes from the fleet's current
        state: a state staged by :meth:`load_state_dict` / :meth:`resize`,
        else the trajectory at the devices' ages (staggered ``set_age``
        ages included).  Afterwards the age clock counts service time
        under the routed traffic over ``[0, horizon_s]`` (default: the
        scenario's horizon) and sits at its end, so serving right away
        uses the traffic-aged BERs and a chained call resumes from the
        accumulated wear.  ``recovery`` (``True`` or a
        :class:`repro_torch.core.aging.RecoveryParams`) adds the
        short-term recoverable pool, ``thermal`` the routed-power
        temperature loop.  Returns the trajectory, also kept on
        ``self.last_cosim``.
        """
        from ..sched import lifetime as sched_lifetime
        from ..sched.workload import Workload, get_workload

        if util_trace is not None:
            util_trace = np.asarray(util_trace, np.float32)
            if self.n_shards > 1 and util_trace.shape[-1] == self.n_devices:
                # a device-granular duty replayed onto every shard of it
                util_trace = np.repeat(util_trace, self.n_shards, axis=-1)
            n_epochs = util_trace.shape[0]
            if loads is None:
                loads = util_trace.sum(axis=-1)
        elif loads is None:
            wl = workload if isinstance(workload, Workload) else \
                get_workload(workload, n_devices=self._n_units,
                             utilization=utilization, n_epochs=n_epochs)
            loads = wl.loads(key, device=self.torch_device)
        loads = loads.cpu().numpy() if hasattr(loads, "cpu") else \
            np.asarray(loads, np.float32)
        dmax = self.policy.thresholds(self._unit_scenario, self.operators)

        dv0 = v0 = rec0 = None
        if self._pending is not None:       # exact staged state, consumed
            dv0 = self._pending["dv"]
            v0 = self._pending["v"]
            rec0 = self._pending["rec"]
            self._pending = None
        elif np.any(self._ages_s > 0):      # resume from the aged state
            st = self.trap_state()
            dv0, v0 = st["dv"], st["v"]
            rec0 = st["rec"] if self._rec_nop is not None else None

        if horizon_s is None:
            horizon_s = float(np.mean(np.asarray(
                self.scenario.lifetime_s, np.float64)))
        kw = {} if heat_per_util is None else \
            {"heat_per_util": heat_per_util}
        cos = sched_lifetime.cosimulate(
            self.cal.aging, self.cal.delay_poly, self._unit_scenario, dmax,
            loads, router=router, util_trace=util_trace,
            n_devices=self._n_units, epoch_s=horizon_s / loads.shape[0],
            capacity=capacity, dv0=dv0, v0=v0, recovery_dynamics=recovery,
            thermal=thermal, rec0=rec0, device=self.torch_device, **kw)
        self._traj = cos.as_lifetime_trajectory()
        self._rec_nop = (np.moveaxis(cos.rec, 0, 2)
                         if cos.rec is not None else None)
        self._invalidate()
        # service-time clock, positioned at the end of the routed horizon
        self._ages_s[:] = float(cos.t[-1])
        self.last_cosim = cos
        return cos

    def _invalidate(self):
        self._snap = None
        self._ber_shard = None

    def _unit_sel(self, device, shard):
        """Index of the addressed aging units: a device's shards, one
        shard of a device, that shard of every device, or all."""
        S = self.n_shards
        if device is None:
            return slice(None) if shard is None else slice(shard, None, S)
        if shard is None:
            return slice(device * S, (device + 1) * S)
        return device * S + shard

    def set_age(self, *, years=None, seconds=None, device=None, shard=None):
        """Set the simulated age of one device or shard (``shard`` within
        ``device``, or that shard of every device when ``device`` is None),
        or of the whole fleet; an explicit age overrides a staged trap
        state."""
        if (years is None) == (seconds is None):
            raise ValueError("pass exactly one of years= and seconds=")
        age = float(seconds if seconds is not None
                    else years * SECONDS_PER_YEAR)
        self._ages_s[self._unit_sel(device, shard)] = age
        self._pending = None
        self._invalidate()

    def advance(self, seconds, device=None, shard=None):
        sel = self._unit_sel(device, shard)
        self._ages_s[sel] = self._ages_s[sel] + np.asarray(seconds,
                                                           np.float64)
        self._pending = None
        self._invalidate()

    @property
    def ages_years(self) -> np.ndarray:
        """(N,) device ages in years, or (N, S) shard ages when
        sharded."""
        yrs = self._ages_s / SECONDS_PER_YEAR
        if self.n_shards == 1:
            return yrs
        return yrs.reshape(self.n_devices, self.n_shards)

    @property
    def age_years(self) -> float:
        """Device 0's age (a fleet-uniform convenience)."""
        return float(self._ages_s[0]) / SECONDS_PER_YEAR

    def snapshot(self) -> FleetState:
        """State of every (unit, operator) domain at the current ages,
        ``(N*S, O)`` arrays (cached between age changes)."""
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

    def trap_state(self) -> Dict[str, np.ndarray]:
        """Exact per-(unit, operator) aging state at the current ages:
        ``{"ages_s": (N*S,), "dv": (N*S, O, P) monotone shifts [mV],
        "rec": the recoverable pool (zeros unless a recovery run), "v":
        (N*S, O) supplies [V]}`` — what a co-sim resume consumes, gathered by the
        same age lookup ``apply_load`` uses."""
        if self._pending is not None:
            return {"ages_s": self._ages_s.copy(),
                    "dv": self._pending["dv"].copy(),
                    "rec": self._pending["rec"].copy(),
                    "v": self._pending["v"].copy()}
        traj = self._ensure_trajs()
        idx = traj.age_index(self._ages_s[:, None])[..., None]  # (N, O, 1)
        v = np.take_along_axis(np.asarray(traj.V), idx, axis=-1)[..., 0]
        dv = np.take_along_axis(np.asarray(traj.dv), idx[..., None],
                                axis=-2)[..., 0, :]
        rec = (np.take_along_axis(self._rec_nop, idx[..., None],
                                  axis=-2)[..., 0, :]
               if self._rec_nop is not None else np.zeros_like(dv))
        return {"ages_s": self._ages_s.copy(), "dv": dv, "rec": rec,
                "v": v}

    def state_dict(self) -> Dict[str, Any]:
        """JSON-able snapshot of the aging state (round-trips through
        :meth:`load_state_dict`, the recoverable pool included)."""
        st = self.trap_state()
        return {"version": 1,
                "operators": list(self.operators),
                "n_shards": self.n_shards,
                "ages_s": np.asarray(st["ages_s"], np.float64).tolist(),
                "dv_mv": np.asarray(st["dv"], np.float64).tolist(),
                "rec_mv": np.asarray(st["rec"], np.float64).tolist(),
                "v": np.asarray(st["v"], np.float64).tolist()}

    def load_state_dict(self, d: Mapping[str, Any]) -> None:
        """Restore a :meth:`state_dict` snapshot (one without ``rec_mv``
        loads an empty recoverable pool).  The state is staged for the
        next ``apply_load`` to resume from."""
        ops = tuple(d.get("operators", self.operators))
        if ops != self.operators:
            raise ValueError(f"operator mismatch: {ops} vs "
                             f"{self.operators}")
        if int(d.get("n_shards", self.n_shards)) != self.n_shards:
            raise ValueError(f"n_shards mismatch: {d['n_shards']} vs "
                             f"{self.n_shards}")
        dv = np.asarray(d["dv_mv"], np.float32)
        v = np.asarray(d["v"], np.float32)
        rec = (np.asarray(d["rec_mv"], np.float32) if "rec_mv" in d
               else np.zeros_like(dv))
        want = (self._n_units, len(self.operators), N_POP)
        if dv.shape != want or rec.shape != want or v.shape != want[:2]:
            raise ValueError(f"state shapes {dv.shape}/{rec.shape}/"
                             f"{v.shape} do not fit {want}")
        self._ages_s[:] = np.asarray(d["ages_s"], np.float64)
        self._pending = {"dv": dv, "rec": rec, "v": v}
        self._invalidate()

    def resize(self, keep, n_fresh: int = 0) -> "FleetRuntime":
        """Trap-state-preserving resize: retirement and hot-swap.

        ``keep`` lists the surviving device indices (in their new order);
        ``n_fresh`` appends factory-fresh devices.  Survivors carry their
        exact state (monotone shifts, recoverable pool, boosted supplies,
        service clocks), staged for the next ``apply_load``; fresh devices
        start at zero.  On a batched-scenario fleet each fresh device
        takes the mission profile of a retired slot (the same rack seat).
        Resizing is device-granular: a sharded fleet is refused.
        """
        if self.n_shards != 1:
            raise ValueError("resize is device-granular; reshape sharded "
                             "fleets upstream")
        keep = np.asarray(keep, int)
        if keep.size != np.unique(keep).size or \
                not ((keep >= 0) & (keep < self.n_devices)).all():
            raise ValueError(f"keep {keep.tolist()} must list distinct "
                             f"devices of {self.n_devices}")
        kept = set(keep.tolist())
        retired = np.asarray([i for i in range(self.n_devices)
                              if i not in kept], int)
        n_new = int(keep.size + n_fresh)
        if n_new < 1:
            raise ValueError("a resized fleet needs at least one device")
        if self.scenario.batch_shape:
            slots = retired if retired.size else keep
            fresh_slots = np.resize(slots, n_fresh) if n_fresh else \
                np.empty(0, int)
            scn = self.scenario[np.concatenate([keep, fresh_slots])]
        else:
            scn = self.scenario
        new = FleetRuntime(self.cal, n_devices=n_new, scenario=scn,
                           policy=self.policy, operators=self.operators,
                           device=self.torch_device)
        st = self.trap_state()
        O = len(self.operators)
        dv = np.zeros((n_new, O, N_POP), np.float32)
        rec = np.zeros_like(dv)
        v = np.broadcast_to(np.asarray(scn.v_init, np.float32).reshape(
            -1, 1), (n_new, O)).copy()
        dv[:keep.size] = st["dv"][keep]
        rec[:keep.size] = st["rec"][keep]
        v[:keep.size] = st["v"][keep]
        new._ages_s[:keep.size] = self._ages_s[keep]
        new._pending = {"dv": dv, "rec": rec, "v": v}
        return new

    def op_index(self, op: str) -> int:
        return self.operators.index(op)

    def domain_state(self, op: str, device: int = 0,
                     shard: int = 0) -> DomainState:
        return self.snapshot().domain(device * self.n_shards + shard,
                                      self.op_index(op))

    def op_ber(self, op: str, device: int = 0, shard=None) -> float:
        return self.op_bers(device, shard)[op]

    def op_bers(self, device: int = 0, shard=None) -> Dict[str, float]:
        """Per-operator BERs of one device (its worst shard) or of one
        shard."""
        if shard is None and self.n_shards > 1:
            ber = self.op_ber_array()[device]
        else:
            ber = self.snapshot().ber[device * self.n_shards + (shard or 0)]
        return {op: float(ber[i]) for i, op in enumerate(self.operators)}

    def op_ber_array(self) -> np.ndarray:
        """(N, O) BER matrix, columns ordered as ``self.operators``: what
        the fleet serving engine hands its lanes.  A sharded device's row
        is the per-domain max over its shards."""
        ber = self.snapshot().ber
        if self.n_shards == 1:
            return ber
        return ber.reshape(self.n_devices, self.n_shards, -1).max(axis=1)

    def op_ber_shard_array(self) -> np.ndarray:
        """(N, S, O) per-shard BERs, the mesh engine's view; the same
        array object until the ages change."""
        if self._ber_shard is None:
            self._ber_shard = self.snapshot().ber.reshape(
                self.n_devices, self.n_shards, len(self.operators))
        return self._ber_shard

    def fleet_power(self) -> np.ndarray:
        """(N,) per-device array power [W]; a sharded device draws the
        mean of its shards' whole-array figures (each shard is 1/S of the
        array)."""
        p = self.snapshot().power_w.sum(axis=-1)
        if self.n_shards == 1:
            return p
        return p.reshape(self.n_devices, self.n_shards).mean(axis=-1)

    def total_power(self, device: int = 0) -> float:
        return float(self.fleet_power()[device])

    def summary(self, device: int = 0, shard: int = 0) -> Mapping[str, Dict]:
        s = self.snapshot()
        unit = device * self.n_shards + shard
        return {op: dataclasses.asdict(s.domain(unit, i))
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
        return float(self.fleet._ages_s[
            self.index * self.fleet.n_shards]) / SECONDS_PER_YEAR

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
