"""Piecewise lifetime co-simulation: traffic drives the aging recursion
(port of ``repro.sched.lifetime``).

:func:`repro_torch.core.avs.simulate` ages a device under one static
stress profile.  :func:`cosimulate` instead recomputes each scheduling
epoch's stress from routed load: the router assigns the epoch's offered
traffic, the assignment scales every device's duty cycle, toggle rate and
load-induced heating, the six trap populations advance with the
history-aware effective-time update, and the AVS policy boosts each
(device, operator-domain) supply against its ``delay_max``:

    routing -> stress -> ΔVth -> policy voltage -> power,  closed per epoch.

The reference runs this as one jitted ``lax.scan``; here it is a loop over
epochs of tensor operations on the fleet's device.  Nothing in the loop
reads a value back to the host (the routers bisect with ``torch.where``,
the boost loop runs a fixed ``max_boosts_per_step`` rounds), so on the
card the epochs queue without waiting; the trajectory comes back to the
host once, at the end.  Every step rounds alike on the card and on the
CPU (the routers sum in index order; ``exp`` and ``pow`` are
device-independent, :mod:`repro_torch.core.aging`), which the
wear-levelling routers need: they turn an ulp of wear into a visible
share of load.  The reference counts its jax traces
(``TRACE_COUNTS``); the port compiles nothing per call and has no
counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import fmath
from ..core import aging
from ..core.aging import AgingParams, RecoveryParams
from ..core.avs import simulate
from ..core.constants import V_NOM
from ..core.delay import DelayPolynomial
from ..core.scenario import LifetimeTrajectory, Scenario
from ..device import resolve_device
from .router import get_router

# Default scheduling resolution: a 24-epoch diurnal period repeats ~20x.
DEFAULT_EPOCHS = 480
# Load-induced heating [K] at full utilization (rack level, on top of the
# V^2 self-heating of the aging model).
HEAT_PER_UTIL_K = 12.0

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ThermalParams:
    """Per-device thermal RC node closing temperature on routed power:

        P_dev  = sum_ops( util * dyn(V) + leak(V, dVth) )   [W]
        T_ss   = t_amb + r_th * P_dev                       [K]
        T'     = T_ss + (T - T_ss) * exp(-epoch_s / tau_s)

    and the epoch's stress temperature is ``T'``.  The power coefficients
    mirror :class:`repro_torch.core.power.PowerModel`.
    """
    r_th: Any = 2.5          # node thermal resistance [K/W]
    tau_s: Any = 21600.0     # node RC time constant [s]
    p_dyn0: Any = 0.70       # dynamic power / operator at v0 [W]
    p_leak0: Any = 0.15      # leakage / operator at (v0, fresh) [W]
    v0: Any = V_NOM
    s_slope: Any = 0.085     # subthreshold slope [V/decade]
    k_dibl: Any = 1.5        # supply sensitivity of leakage

    _FIELDS = ("r_th", "tau_s", "p_dyn0", "p_leak0", "v0", "s_slope",
               "k_dibl")

    @classmethod
    def from_power_model(cls, pm, *, r_th: float = 2.5,
                         tau_s: float = 21600.0) -> "ThermalParams":
        """Lift a calibrated power model into the thermal node."""
        return cls(r_th=r_th, tau_s=tau_s, p_dyn0=pm.p_dyn0,
                   p_leak0=pm.p_leak0, v0=pm.v0, s_slope=pm.s_slope,
                   k_dibl=pm.k_dibl)

    def replace(self, **kw) -> "ThermalParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CoSimTrajectory:
    """Result of :func:`cosimulate`, as host float32 numpy arrays.

    ``E`` epochs x ``N`` devices x ``O`` operator domains, epoch axis
    first.  With short-term recovery ``dv`` stays the monotone state while
    ``dvp``/``dvn`` (and delay, supply, wear) are the effective totals
    ``sum(dv - rec)``; ``rec`` is the relaxed pool and ``t_node`` the
    thermal-node temperature, ``None`` when those dynamics are off.
    """
    t: np.ndarray           # (E,) epoch-end wall clock [s]
    load: np.ndarray        # (E,) offered load [device-equivalents]
    util: np.ndarray        # (E, N) routed utilization
    V: np.ndarray           # (E, N, O) supply voltage [V]
    delay: np.ndarray       # (E, N, O) critical-path delay [s]
    dvp: np.ndarray         # (E, N, O) PMOS ΔVth [mV] (effective)
    dvn: np.ndarray         # (E, N, O) NMOS ΔVth [mV] (effective)
    dv: np.ndarray          # (E, N, O, P) monotone per-population shifts
    rec: Any = None         # (E, N, O, P) relaxed (recovered) pool [mV]
    t_node: Any = None      # (E, N) thermal-node temperature [K]
    boosts: Any = None      # (E, N) AVS boost events this epoch

    _FIELDS = ("t", "load", "util", "V", "delay", "dvp", "dvn", "dv",
               "rec", "t_node", "boosts")

    @property
    def n_epochs(self) -> int:
        return int(self.V.shape[0])

    @property
    def n_devices(self) -> int:
        return int(self.V.shape[1])

    def device_wear(self) -> np.ndarray:
        """(E, N) per-device wear signal: ΔVth_p of the worst domain."""
        return np.asarray(self.dvp).max(axis=-1)

    def as_lifetime_trajectory(self) -> LifetimeTrajectory:
        """Re-lay to the fleet's ``(N, O, T)`` series convention."""
        E, N, O = self.V.shape
        move = lambda x: np.moveaxis(np.asarray(x), 0, 2)
        return LifetimeTrajectory(
            t=np.broadcast_to(np.asarray(self.t), (N, O, E)),
            V=move(self.V), delay=move(self.delay),
            dvp=move(self.dvp), dvn=move(self.dvn),
            dv=np.moveaxis(np.asarray(self.dv), 0, 2))


def _pop_totals(dv: torch.Tensor):
    """(ΔVth_p, ΔVth_n) over the population axis, each summed in
    population order as the reference reduces it."""
    return (((dv[..., 0] + dv[..., 1]) + dv[..., 2]) + dv[..., 3],
            dv[..., 4] + dv[..., 5])


def _to_dev(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=_F32)
    return torch.as_tensor(np.array(x, np.float32), device=dev)


def _recovery(recovery_dynamics) -> Optional[RecoveryParams]:
    if recovery_dynamics is True:
        return RecoveryParams.default()
    if recovery_dynamics is False:
        return None
    return recovery_dynamics


def _thermal(thermal) -> Optional[ThermalParams]:
    if thermal is True:
        return ThermalParams()
    if thermal is False:
        return None
    return thermal


def cosimulate(params: AgingParams, poly: DelayPolynomial,
               scenario: Scenario, delay_max, loads,
               router="wear_level", *, util_trace=None,
               n_devices: Optional[int] = None,
               epoch_s: Optional[float] = None, capacity: float = 1.0,
               heat_per_util: float = HEAT_PER_UTIL_K,
               dv0=None, v0=None, util0=None, recovery: bool = True,
               avs_enabled: bool = True, recovery_dynamics=None,
               thermal=None, rec0=None, t_node0=None,
               device="cuda") -> CoSimTrajectory:
    """Run the traffic-driven lifetime co-simulation for one fleet.

    ``scenario`` holds per-device full-utilization stress knobs (scalar
    leaves broadcast over the fleet; ``(N,)``-batched leaves give a
    heterogeneous fleet).  ``delay_max`` is ``(O,)`` or ``(N, O)``;
    ``loads`` the offered-load trace ``(E,)``.  ``epoch_s`` defaults to
    ``scenario.lifetime_s / E``.  ``dv0 / v0 / util0`` resume from an
    existing fleet state.

    ``util_trace`` (``(E, N)`` measured utilization) switches to replay:
    the trace drives the stress recursion and ``router`` is ignored
    (``loads`` then defaults to the trace's per-epoch sum).  Replaying a
    routed run's own ``util`` reproduces it bit for bit.

    ``recovery_dynamics`` (``True`` or a :class:`RecoveryParams`) threads
    the short-term recoverable pool, resumed from ``rec0``; ``thermal``
    (``True`` or a :class:`ThermalParams`) closes the temperature loop on
    routed power, resumed from ``t_node0``.  ``recovery`` is the separate
    long-term capture/emission rate scaling.  Runs on ``device``.
    """
    dev = resolve_device(device)
    rparams = _recovery(recovery_dynamics)
    tparams = _thermal(thermal)
    short_term = rparams is not None
    replay = util_trace is not None
    if replay:
        util_trace = _to_dev(util_trace, dev)
        if util_trace.dim() != 2:
            raise ValueError(f"util_trace must be (E, N), got "
                             f"{tuple(util_trace.shape)}")
        if n_devices is None:
            n_devices = util_trace.shape[1]
        if util_trace.shape[1] != n_devices:
            raise ValueError(f"util_trace device dim {util_trace.shape[1]} "
                             f"!= {n_devices}")
        if loads is None:
            loads = util_trace.sum(dim=-1)
    else:
        router = get_router(router)
    loads = _to_dev(loads, dev)
    if loads.dim() != 1:
        raise ValueError(f"loads must be (E,), got {tuple(loads.shape)}")
    if replay and loads.shape[0] != util_trace.shape[0]:
        raise ValueError(f"loads epochs {loads.shape[0]} != util_trace "
                         f"{util_trace.shape[0]}")
    dmax = _to_dev(delay_max, dev)
    sbatch = scenario.batch_shape
    if len(sbatch) > 1:
        raise ValueError("cosimulate scenarios must be scalar or "
                         "(n_devices,)-batched")
    if n_devices is None:
        n_devices = sbatch[0] if sbatch else (
            dmax.shape[0] if dmax.dim() == 2 else 1)
    N, O, E = int(n_devices), int(dmax.shape[-1]), int(loads.shape[0])
    if epoch_s is None:
        ls = torch.as_tensor(np.asarray(scenario.lifetime_s, np.float32)
                             if not isinstance(scenario.lifetime_s,
                                               torch.Tensor)
                             else scenario.lifetime_s, dtype=_F32).reshape(-1)
        epoch_s = float(ls.sum() / ls.shape[0]) / E

    def per_device(name):
        v = getattr(scenario, name)
        return torch.broadcast_to(_to_dev(v, dev).reshape(-1), (N,))

    duty0, toggle0 = per_device("duty"), per_device("toggle")
    t_amb0, t_clk = per_device("t_amb"), per_device("t_clk")
    tt = per_device("transition_time")
    v_max = per_device("v_max")[:, None]
    v_step = per_device("v_step")[:, None]
    dmax = torch.broadcast_to(dmax, (N, O))
    epoch = torch.full((), float(epoch_s), dtype=_F32, device=dev)
    cap = torch.full((), float(capacity), dtype=_F32, device=dev)
    heat = torch.full((), float(heat_per_util), dtype=_F32, device=dev)
    params, poly = params.to(dev), poly.to(dev)
    if short_term:
        rparams = rparams.to(dev)
    if tparams is not None:
        tp = {f: torch.full((), float(np.asarray(getattr(tparams, f))),
                            dtype=_F32, device=dev)
              for f in ThermalParams._FIELDS}
        decay = fmath.exp(-epoch / tp["tau_s"])

    zeros = lambda *s: torch.zeros(s, dtype=_F32, device=dev)
    dv = zeros(N, O, aging.N_POP) if dv0 is None else _to_dev(dv0, dev)
    v = (torch.broadcast_to(per_device("v_init")[:, None], (N, O))
         if v0 is None else _to_dev(v0, dev))
    util_prev = zeros(N) if util0 is None else _to_dev(util0, dev)
    rec = zeros(N, O, aging.N_POP) if rec0 is None else _to_dev(rec0, dev)
    tn = t_amb0.clone() if t_node0 is None else torch.broadcast_to(
        _to_dev(t_node0, dev).reshape(-1), (N,))

    keys = ("util", "V", "delay", "dvp", "dvn", "dv", "boosts") \
        + (("rec",) if short_term else ()) \
        + (("t_node",) if tparams is not None else ())
    out = {k: [] for k in keys}
    for e in range(E):
        load = loads[e]
        if replay:
            util = util_trace[e]
        else:
            # route on the wear the traffic created (the effective wear
            # when recovery is modelled: a rested device looks younger)
            eff = dv - rec if short_term else dv
            wear = _pop_totals(eff)[0].amax(dim=-1)              # (N,)
            util = router.assign(load, wear, util_prev, cap)
        duty = duty0 * util
        toggle = toggle0 * util
        if tparams is not None:
            eff_c = dv - rec if short_term else dv
            dvp_c, dvn_c = _pop_totals(eff_c)                    # (N, O)
            dvm = 0.5 * (dvp_c + dvn_c) * 1e-3
            r = v / tp["v0"]
            dyn = tp["p_dyn0"] * (r * r)
            # the multiply-adds the reference backend fuses, each rounded
            # once (fmath.fma); its sum over the operators folds both of an
            # operator's products into the running total:
            # p = fma(util, dyn, fma(p_leak0 * r, 10**x, p))
            lead = tp["p_leak0"] * r
            scale = fmath.pow(10.0, fmath.fma(tp["k_dibl"], v - tp["v0"],
                                              -dvm) / tp["s_slope"])
            p_dev = zeros(N)
            for i in range(O):
                p_dev = fmath.fma(util, dyn[:, i],
                                  fmath.fma(lead[:, i], scale[:, i], p_dev))
            t_ss = fmath.fma(tp["r_th"], p_dev, t_amb0)
            tn = fmath.fma(tn - t_ss, decay, t_ss)
            t_amb = tn
        else:
            t_amb = fmath.fma(heat, util, t_amb0)
        rates = aging.stress_rates(
            params, duty=duty[:, None], toggle=toggle[:, None],
            t_clk=t_clk[:, None], transition_time=tt[:, None],
            recovery=recovery)                                   # (N, P)
        dv = aging.update_state(params, dv, v[..., None], rates[:, None, :],
                                epoch, t_amb[:, None, None])     # (N, O, P)
        if short_term:
            rec = aging.relax_step(rparams, dv, rec, util[:, None, None],
                                   epoch)
            dvp, dvn = _pop_totals(dv - rec)                     # effective
        else:
            dvp, dvn = _pop_totals(dv)                           # (N, O)
        dp_v, dn_v = dvp * 1e-3, dvn * 1e-3
        delay = poly(dp_v, dn_v, v)
        if avs_enabled:
            v_pre = v
            zero = zeros()
            for _ in range(scenario.max_boosts_per_step):
                need = (delay > dmax) & (v < v_max - 1e-6)
                v = v + torch.where(need, v_step, zero)
                delay = poly(dp_v, dn_v, v)
            boosts = ((v - v_pre) / v_step).sum(dim=-1)
        else:
            boosts = zeros(N)
        for k, val in (("util", util), ("V", v), ("delay", delay),
                       ("dvp", dvp), ("dvn", dvn), ("dv", dv),
                       ("boosts", boosts)):
            out[k].append(val)
        if short_term:
            out["rec"].append(rec)
        if tparams is not None:
            out["t_node"].append(tn)
        util_prev = util
    host = {k: torch.stack(vals).cpu().numpy() for k, vals in out.items()}
    t = ((np.arange(E, dtype=np.float64) + 1.0)
         * float(epoch_s)).astype(np.float32)
    return CoSimTrajectory(t=t, load=loads.cpu().numpy(), util=host["util"],
                           V=host["V"], delay=host["delay"], dvp=host["dvp"],
                           dvn=host["dvn"], dv=host["dv"],
                           rec=host.get("rec"), t_node=host.get("t_node"),
                           boosts=host["boosts"])


def initial_state_at_ages(params: AgingParams, poly: DelayPolynomial,
                          scenario: Scenario, delay_max, ages_s,
                          device="cuda"):
    """Per-device ``(dv0, v0)`` after ``ages_s`` of static-stress service:
    the classic :func:`simulate` over the scenario, gathered at each
    device's age (a staggered deployment's starting state)."""
    traj = simulate(params, poly, scenario.expand_dims(-1),
                    delay_max=delay_max, device=device)
    t, dv, V = traj.t, traj.dv, traj.V
    ages = np.atleast_1d(np.asarray(ages_s, np.float64))
    n = ages.shape[0]
    if t.ndim == 2:                       # scalar scenario: (O, T) series
        t = np.broadcast_to(t, (n,) + t.shape)
        V = np.broadcast_to(V, (n,) + V.shape)
        dv = np.broadcast_to(dv, (n,) + dv.shape)
    idx = np.clip((t < ages[:, None, None]).sum(-1), 0, t.shape[-1] - 1)
    v0 = np.take_along_axis(V, idx[..., None], axis=-1)[..., 0]
    dv0 = np.take_along_axis(dv, idx[..., None, None], axis=-2)[..., 0, :]
    return dv0.astype(np.float32), v0.astype(np.float32)


def cosim_stats(power_model, cos: CoSimTrajectory) -> Dict[str, Any]:
    """Fleet-level lifetime summary of one co-simulation: end-of-life
    fleet-max / mean / spread of the wear signal, lifetime-average fleet
    power at the routed activity, final max supply, served fraction and
    mean utilization (plus the recovered pool and node temperatures when
    those dynamics ran)."""
    wear = cos.device_wear()                      # (E, N)
    p = np.asarray(power_model.power_at_activity(
        cos.V, cos.dvp, cos.dvn, np.asarray(cos.util)[..., None]).numpy(),
        np.float64)
    load = np.asarray(cos.load, np.float64)
    served = np.asarray(cos.util, np.float64).sum(axis=-1)
    out = {
        "fleet_max_dvp_mv": float(wear[-1].max()),
        "fleet_mean_dvp_mv": float(wear[-1].mean()),
        "wear_spread_mv": float(wear[-1].max() - wear[-1].min()),
        "p_avg_w": float(p.mean(axis=0).sum()),
        "v_final_max": float(np.asarray(cos.V)[-1].max()),
        "served_frac": float(served.sum() / max(load.sum(), 1e-12)),
        "util_mean": float(np.asarray(cos.util).mean()),
    }
    if cos.rec is not None:
        pm = np.asarray(aging.IS_PMOS, np.float64)
        rec_p = (np.asarray(cos.rec, np.float64) * pm).sum(axis=-1)
        out["recovered_mv_final"] = float(rec_p[-1].max())
    if cos.t_node is not None:
        tn = np.asarray(cos.t_node, np.float64)
        out["t_node_peak_k"] = float(tn.max())
        out["t_node_final_k"] = float(tn[-1].max())
    return out


def compare_routers(cal, scenario: Scenario, policy, loads, *,
                    routers=("round_robin", "least_loaded", "least_aged",
                             "wear_level"),
                    operators=None, n_devices: Optional[int] = None,
                    epoch_s: Optional[float] = None,
                    heat_per_util: float = HEAT_PER_UTIL_K,
                    ages_s=None, dv0=None, v0=None, capacity: float = 1.0,
                    recovery_dynamics=None, thermal=None,
                    device="cuda") -> Dict[str, Dict[str, Any]]:
    """Co-simulate one fleet and one traffic trace under each router.

    The policy's thresholds are evaluated once and shared, so the
    comparison isolates the routing decision; ``ages_s`` pre-ages the fleet
    (:func:`initial_state_at_ages`), explicit ``dv0 / v0`` override it.
    Returns ``{router_name: cosim_stats + {"traj": trajectory}}``.
    """
    from ..core.resilience import OPERATORS
    ops = tuple(operators or OPERATORS)
    dmax = policy.thresholds(scenario, ops)
    if ages_s is not None and dv0 is None:
        ages_s = np.atleast_1d(np.asarray(ages_s, np.float64))
        if n_devices is None and not scenario.batch_shape:
            n_devices = ages_s.shape[0]
        dv0, v0 = initial_state_at_ages(cal.aging, cal.delay_poly,
                                        scenario, dmax, ages_s,
                                        device=device)
    out: Dict[str, Dict[str, Any]] = {}
    for name in routers:
        cos = cosimulate(cal.aging, cal.delay_poly, scenario, dmax, loads,
                         router=name, n_devices=n_devices, epoch_s=epoch_s,
                         heat_per_util=heat_per_util, dv0=dv0, v0=v0,
                         capacity=capacity,
                         recovery_dynamics=recovery_dynamics,
                         thermal=thermal, device=device)
        out[name] = dict(cosim_stats(cal.power, cos), traj=cos)
    return out
