"""Traffic-driven fleet scheduling (port of ``repro.sched``).

A :class:`~repro_torch.sched.workload.Workload` emits per-epoch offered
load, a :class:`~repro_torch.sched.router.Router` assigns it across the
fleet, and :func:`~repro_torch.sched.lifetime.cosimulate` closes routing
-> stress -> ΔVth -> policy voltage -> power epoch by epoch on the fleet's
device.  ``FleetRuntime.apply_load`` replays the result into the serving
stack, so served BERs reflect traffic-dependent age.
"""
from .disruption import (recovered_totals, run_flash_crowd,
                         run_rest_to_recover, run_retirement)
from .lifetime import (DEFAULT_EPOCHS, HEAT_PER_UTIL_K, CoSimTrajectory,
                       ThermalParams, compare_routers, cosim_stats,
                       cosimulate, initial_state_at_ages)
from .router import (LeastAgedRouter, LeastLoadedRouter, ROUTER_REGISTRY,
                     RestToRecoverRouter, RoundRobinRouter, Router,
                     WearLevelRouter, get_router, register_router,
                     waterfill)
from .workload import (WORKLOADS, Workload, bursty, diurnal, flash_crowd,
                       get_workload, poisson)

__all__ = [
    "DEFAULT_EPOCHS", "HEAT_PER_UTIL_K",
    "CoSimTrajectory", "ThermalParams", "compare_routers", "cosim_stats",
    "cosimulate", "initial_state_at_ages",
    "recovered_totals", "run_flash_crowd", "run_rest_to_recover",
    "run_retirement",
    "LeastAgedRouter", "LeastLoadedRouter", "ROUTER_REGISTRY",
    "RestToRecoverRouter", "RoundRobinRouter", "Router", "WearLevelRouter",
    "get_router", "register_router", "waterfill",
    "WORKLOADS", "Workload", "bursty", "diurnal", "flash_crowd",
    "get_workload", "poisson",
]
