"""Disruption scenarios: the events a serving fleet actually survives
(port of ``repro.sched.disruption``).

The router comparison in :mod:`repro_torch.sched.lifetime` ages a fleet under
*well-behaved* traffic.  This module drives the co-simulation through the
disruptions a production fleet faces, exercising the short-term recovery
dynamics (:class:`repro_torch.core.aging.RecoveryParams`) and the closed
thermal loop (:class:`repro_torch.sched.lifetime.ThermalParams`) end to
end:

* :func:`run_flash_crowd` — a sustained overload window
  (``flash_crowd`` workload) with temperature derived from *routed
  power* via the thermal RC node instead of a fixed ``t_amb`` leaf: the
  surge saturates the fleet, boosted supplies burn more per request, the
  node heats, aging accelerates — and relaxes back after the crowd
  passes.
* :func:`run_retirement` — mid-horizon device retirement (and optional
  hot-swap): the worn devices leave, the surviving fleet's trap state is
  carried bit-exactly across the resize
  (:meth:`repro_torch.core.fleet.FleetRuntime.resize`), and the
  accompanying serving-mesh change is planned through
  :func:`repro_torch.distributed.elastic.plan_remesh_shape`.
* :func:`run_rest_to_recover` — the ``rest_to_recover`` router idles the
  most-worn devices whenever capacity headroom allows, harvesting the
  recoverable trap component that plain wear-leveling can only
  redistribute.

Every scenario runs one co-simulation per fleet segment on ``device``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.aging import IS_PMOS, RecoveryParams
from ..core.artifacts import Calibration, load_calibration
from ..core.constants import T_AMB
from ..core.fleet import FleetRuntime
from ..core.policy import get_policy
from ..core.resilience import OPERATORS
from ..core.scenario import Scenario
from ..distributed.elastic import plan_remesh_shape

from .lifetime import (DEFAULT_EPOCHS, ThermalParams, compare_routers,
                       cosim_stats, cosimulate)
from .workload import get_workload

YEAR_S = 365.25 * 24 * 3600.0


def _fleet_scenario(cal: Calibration, n_devices: int, *,
                    horizon_years: float, t_amb_spread: float,
                    budget: float = 0.5) -> Scenario:
    """Heterogeneous rack scenario shared by the disruption scenarios."""
    scn = Scenario.from_lifetime_config(cal.lifetime_cfg,
                                        max_loss_pct=budget).replace(
        lifetime_s=horizon_years * YEAR_S)
    if t_amb_spread and n_devices > 1:
        scn = scn.replace(t_amb=torch.as_tensor(
            T_AMB + np.linspace(0.0, t_amb_spread, n_devices),
            dtype=torch.float32))
    return scn


def _resolve(cal, policy):
    cal = cal or load_calibration()
    if policy is None:
        policy = get_policy("fault_tolerant", ber_model=cal.ber)
    return cal, policy


# --------------------------------------------------------------------------- #
# (a) flash crowd with closed thermal feedback
# --------------------------------------------------------------------------- #
def run_flash_crowd(cal: Optional[Calibration] = None, *,
                    n_devices: int = 8, epochs: int = DEFAULT_EPOCHS,
                    horizon_years: float = 1.0, utilization: float = 0.6,
                    surge_gain: float = 4.0, router: str = "wear_level",
                    recovery=True, thermal=True,
                    t_amb_spread: float = 20.0, policy=None,
                    seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Sustained overload under the closed thermal loop.

    The ``flash_crowd`` workload multiplies the offered load by
    ``surge_gain`` over a contiguous window; with ``thermal`` enabled
    the epoch stress temperature is the RC-node response to *routed
    power* — overload drives every device to capacity, dissipation
    peaks, the node temperature rises toward its (bounded) fixed point
    and relaxes after the window.  Returns the trajectory plus thermal
    diagnostics (peak/steady node temperature, surge-window wear rate).
    """
    cal, policy = _resolve(cal, policy)
    scn = _fleet_scenario(cal, n_devices, horizon_years=horizon_years,
                          t_amb_spread=t_amb_spread)
    if thermal is True:
        thermal = ThermalParams.from_power_model(cal.power)
    wl = get_workload("flash_crowd", n_devices=n_devices,
                      utilization=utilization, n_epochs=epochs,
                      surge_gain=surge_gain)
    loads = wl.loads(seed, device=device)
    dmax = policy.thresholds(scn, OPERATORS)
    cos = cosimulate(cal.aging, cal.delay_poly, scn, dmax, loads,
                     router=router, n_devices=n_devices,
                     recovery_dynamics=recovery, thermal=thermal,
                     device=device)
    stats = cosim_stats(cal.power, cos)
    surge = np.zeros(epochs, bool)
    s0 = int(float(np.asarray(wl.surge_start)))
    s1 = s0 + int(float(np.asarray(wl.surge_len)))
    surge[s0:min(s1, epochs)] = True
    tn = np.asarray(cos.t_node, np.float64) if cos.t_node is not None \
        else None
    report = dict(stats)
    report.update({
        "surge_start": s0, "surge_end": min(s1, epochs),
        "surge_served_frac": float(
            np.asarray(cos.util, np.float64)[surge].sum()
            / max(np.asarray(cos.load, np.float64)[surge].sum(), 1e-12)),
    })
    if cos.boosts is not None:
        # odometer tap (:attr:`CoSimTrajectory.boosts`): the surge shows
        # up as a burst of AVS boost events — overload heats the node,
        # delays blow through ``dmax``, supplies climb
        bo = np.asarray(cos.boosts, np.float64)
        report.update({
            "boost_events": float(bo.sum()),
            "boost_events_surge": float(bo[surge].sum()),
        })
    if tn is not None:
        # fleet-MEAN temperature carries the surge signature: individual
        # devices already hit their full-load steady state in normal
        # operation (the wear-level router concentrates load), but only
        # the overload pins the whole fleet there at once
        fm = tn.mean(axis=1)
        report.update({
            "t_peak_k": float(tn.max()),
            "t_steady_k": float(tn[~surge][-8:].mean()),
            "t_surge_rise_k": float(fm[surge].max()
                                    - fm[:max(s0, 1)].mean()),
        })
    return {"cos": cos, "workload": wl, "stats": report,
            "scenario": scn, "thermal": thermal}


# --------------------------------------------------------------------------- #
# (b) mid-horizon retirement / hot-swap
# --------------------------------------------------------------------------- #
def run_retirement(cal: Optional[Calibration] = None, *,
                   n_devices: int = 8, retire=(0,), hot_swap: int = 0,
                   retire_epoch: Optional[int] = None,
                   epochs: int = DEFAULT_EPOCHS,
                   horizon_years: float = 5.0, utilization: float = 0.5,
                   workload: str = "diurnal", router: str = "wear_level",
                   recovery=True, thermal=None,
                   t_amb_spread: float = 20.0, tp: int = 1,
                   global_batch: int = 64, policy=None,
                   seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Retire devices mid-horizon; survivors keep their trap state.

    Two co-sim segments around the retirement epoch: the full fleet ages
    under routed traffic, then ``retire`` (device indices) leave the
    rotation, ``hot_swap`` factory-fresh replacements take their rack
    slots, and the resized fleet — survivors resuming *bit-exactly* from
    their accumulated monotone + recoverable state via
    :meth:`repro_torch.core.fleet.FleetRuntime.resize` — serves the
    remaining horizon.  The matching serving-mesh change is planned with
    :func:`repro_torch.distributed.elastic.plan_remesh_shape` (each fleet
    lane is one ``tp``-chip model-parallel group on a ("data", "model")
    mesh).  Returns both segment trajectories, the degraded and restored
    :class:`repro_torch.distributed.elastic.RemeshPlan`, and before/after
    fleet wear stats.
    """
    cal, policy = _resolve(cal, policy)
    if retire_epoch is None:
        retire_epoch = epochs // 2
    if not 0 < retire_epoch < epochs:
        raise ValueError(f"retire_epoch {retire_epoch} outside (0, "
                         f"{epochs})")
    retire = tuple(int(i) for i in retire)
    keep = [i for i in range(n_devices) if i not in set(retire)]
    if not keep:
        raise ValueError("cannot retire the whole fleet")
    scn = _fleet_scenario(cal, n_devices, horizon_years=horizon_years,
                          t_amb_spread=t_amb_spread)
    fleet = FleetRuntime(cal, n_devices=n_devices, scenario=scn,
                         policy=policy, device=device)
    wl = get_workload(workload, n_devices=n_devices,
                      utilization=utilization, n_epochs=epochs)
    loads = wl.loads(seed, device=device).cpu().numpy()
    epoch_s = horizon_years * YEAR_S / epochs

    cos1 = fleet.apply_load(loads=loads[:retire_epoch], router=router,
                            horizon_s=retire_epoch * epoch_s,
                            recovery=recovery, thermal=thermal)
    pre_wear = cos1.device_wear()[-1]                      # (N,)

    fleet2 = fleet.resize(keep, n_fresh=hot_swap)
    n_after = len(keep) + hot_swap
    plan_degraded = plan_remesh_shape(
        ("data", "model"), {"data": n_devices, "model": tp},
        len(keep) * tp, global_batch=global_batch)
    plan_restored = plan_remesh_shape(
        ("data", "model"), {"data": n_devices, "model": tp},
        n_after * tp, global_batch=global_batch) if hot_swap else None

    cos2 = fleet2.apply_load(loads=loads[retire_epoch:], router=router,
                             horizon_s=(epochs - retire_epoch) * epoch_s,
                             recovery=recovery, thermal=thermal)
    stats = cosim_stats(cal.power, cos2)
    stats.update({
        "n_before": n_devices, "n_after": n_after,
        "retired": list(retire), "retire_epoch": int(retire_epoch),
        "pre_retire_max_dvp_mv": float(pre_wear.max()),
        "survivor_pre_max_dvp_mv": float(pre_wear[keep].max()),
    })
    return {"fleet": fleet2, "cos_before": cos1, "cos_after": cos2,
            "plan_degraded": plan_degraded, "plan_restored": plan_restored,
            "keep": keep, "stats": stats}


# --------------------------------------------------------------------------- #
# (c) rest-to-recover vs round-robin
# --------------------------------------------------------------------------- #
def run_rest_to_recover(cal: Optional[Calibration] = None, *,
                        n_devices: int = 8, epochs: int = DEFAULT_EPOCHS,
                        horizon_years: float = 5.0,
                        utilization: float = 0.55,
                        workload: str = "diurnal",
                        t_amb_spread: float = 30.0,
                        stagger_years: float = 7.0,
                        recovery=True, thermal=None, policy=None,
                        seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Quantify the recovery harvest of deliberate idling.

    Same fleet + traffic under ``round_robin``, ``wear_level`` and
    ``rest_to_recover`` with the short-term recoverable pool enabled:
    resting the most-worn devices lets their fast traps relax, so the
    rest router's fleet-max *effective* ΔVth undercuts both the blind
    baseline and pure steering.  Returns per-router stats plus the
    headline delta vs round-robin.
    """
    cal, policy = _resolve(cal, policy)
    if recovery is True:
        recovery = RecoveryParams.default()
    scn = _fleet_scenario(cal, n_devices, horizon_years=horizon_years,
                          t_amb_spread=t_amb_spread)
    wl = get_workload(workload, n_devices=n_devices,
                      utilization=utilization, n_epochs=epochs)
    loads = wl.loads(seed, device=device)
    ages = np.linspace(0.0, stagger_years, n_devices) * YEAR_S
    res = compare_routers(
        cal, scn, policy, loads,
        routers=("round_robin", "wear_level", "rest_to_recover"),
        n_devices=n_devices, ages_s=ages, recovery_dynamics=recovery,
        thermal=thermal, device=device)
    rr = res["round_robin"]["fleet_max_dvp_mv"]
    rest = res["rest_to_recover"]["fleet_max_dvp_mv"]
    res["headline"] = {
        "rest_vs_round_robin_pct": 100.0 * (1.0 - rest / rr),
        "recovered_mv_final":
            res["rest_to_recover"].get("recovered_mv_final", 0.0),
    }
    return res


def recovered_totals(cos) -> np.ndarray:
    """(E, N) fleet view of the relaxed PMOS pool of a recovery run."""
    if cos.rec is None:
        raise ValueError("run had no recovery dynamics")
    pm = np.asarray(IS_PMOS, np.float64)
    return (np.asarray(cos.rec, np.float64) * pm).sum(axis=-1).max(axis=-1)
