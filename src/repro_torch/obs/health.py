"""Fleet "aging odometer" health snapshot (port of ``repro.obs.health``).

The serving-side answer to the paper's on-chip monitors: given a
:class:`repro_torch.core.fleet.FleetRuntime`, produce one structured,
renderable snapshot per aging unit —

* **ΔVth** (worst operator domain) — the aging-monitor readout;
* **guardband headroom** — ``t_clk − delay`` of the worst domain, the
  timing-margin sensor the AVS loop guards;
* **ETA-to-threshold** — remaining margin converted to *time*: the first
  trajectory epoch at which a domain's delay exceeds its ``delay_max``
  with the supply already pinned at ``v_max`` (no boost left to spend),
  read off the fleet's existing lifetime extrapolation — minus the unit's
  current age;
* **admitted BER** and the AVS-chosen supply;
* plus process-level context: cache statistics and span timings from
  :data:`repro_torch.obs.metrics.REGISTRY`.

Everything here is host-side numpy over arrays the fleet has already
computed (trajectories are cached; the snapshot is cached between age
changes), so a reading perturbs nothing.  Folding an online-serving run
into the reading (``online_result=``) waits for the port of online
serving.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np

from . import metrics as obs_metrics

SECONDS_PER_YEAR = 365.25 * 24 * 3600.0

__all__ = ["FleetHealth", "fleet_health", "eta_to_threshold_s"]


def eta_to_threshold_s(fleet, eps: float = 1e-6) -> np.ndarray:
    """Per-unit seconds of service left before AVS runs out of guardband.

    A unit is *exhausted* at the first trajectory grid time where some
    operator domain's delay exceeds its policy ``delay_max`` while the
    supply sits at ``v_max`` (within ``eps``) — the boost ladder has no
    rung left.  Returns ``(N*S,)`` seconds from each unit's current age
    to that point; ``inf`` for units whose horizon never reaches it, 0.0
    for units already past it.
    """
    traj = fleet.trajectories                          # (U, O, T) series
    scn = fleet.unit_scenario
    U = np.asarray(traj.V).shape[0]
    dmax = np.asarray(fleet.policy.thresholds(scn, fleet.operators),
                      np.float64)
    dmax = np.broadcast_to(dmax, np.asarray(traj.delay).shape[:2])
    v_max = np.broadcast_to(
        np.asarray(scn.v_max, np.float64).reshape(-1, 1),
        np.asarray(traj.V).shape[:2])
    exhausted = (np.asarray(traj.delay) > dmax[..., None]) \
        & (np.asarray(traj.V) >= v_max[..., None] - eps)
    hit = exhausted.any(axis=1)                        # (U, T) any domain
    t = np.broadcast_to(np.asarray(traj.t, np.float64),
                        exhausted.shape)[:, 0, :]      # (U, T) grid times
    first = np.where(hit.any(axis=-1),
                     t[np.arange(U), hit.argmax(axis=-1)], np.inf)
    ages = np.asarray(fleet.ages_years, np.float64).reshape(-1) \
        * SECONDS_PER_YEAR
    return np.maximum(first - ages, 0.0)


@dataclasses.dataclass
class FleetHealth:
    """One health reading of a fleet: per-unit arrays plus process context.

    Per-unit fields are ``(N*S,)`` in the fleet's device-major unit order
    (units == devices when unsharded).  ``cache_stats`` / ``spans`` come
    from the metrics registry at snapshot time; ``extra`` carries
    run-specific scalars (e.g. online-serving latency percentiles).
    """

    operators: tuple
    n_shards: int
    age_years: np.ndarray            # (U,)
    dvth_p_mv: np.ndarray            # (U,) worst-domain ΔVth_p
    headroom_s: np.ndarray           # (U,) worst-domain t_clk - delay
    v_dd: np.ndarray                 # (U,) max-domain supply
    ber: np.ndarray                  # (U,) worst-domain admitted BER
    eta_s: np.ndarray                # (U,) seconds to threshold (inf ok)
    cache_stats: Dict[str, Dict[str, int]]
    spans: Dict[str, Dict[str, float]]
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def n_units(self) -> int:
        return int(self.age_years.shape[0])

    def to_dict(self) -> Dict:
        """JSON-able form (inf ETAs become None)."""
        eta = [None if math.isinf(v) else float(v) for v in self.eta_s]
        return {
            "operators": list(self.operators),
            "n_shards": self.n_shards,
            "units": [{
                "unit": i,
                "age_years": float(self.age_years[i]),
                "dvth_p_mv": float(self.dvth_p_mv[i]),
                "headroom_ps": float(self.headroom_s[i] * 1e12),
                "v_dd": float(self.v_dd[i]),
                "ber": float(self.ber[i]),
                "eta_years": (None if eta[i] is None
                              else eta[i] / SECONDS_PER_YEAR),
            } for i in range(self.n_units)],
            "cache_stats": self.cache_stats,
            "spans": self.spans,
            "extra": dict(self.extra),
        }

    def render(self) -> str:
        """Plain-text per-unit health table (+ cache / span footers)."""
        hdr = (f"{'unit':>5} {'age[yr]':>8} {'dVth[mV]':>9} "
               f"{'margin[ps]':>11} {'Vdd[V]':>7} {'BER':>9} "
               f"{'ETA[yr]':>8}")
        lines = ["fleet health — aging odometer", hdr, "-" * len(hdr)]
        for i in range(self.n_units):
            eta = self.eta_s[i] / SECONDS_PER_YEAR
            eta_s = "   inf" if math.isinf(eta) else f"{eta:6.2f}"
            label = (f"{i // self.n_shards}.{i % self.n_shards}"
                     if self.n_shards > 1 else f"{i}")
            lines.append(
                f"{label:>5} {self.age_years[i]:8.2f} "
                f"{self.dvth_p_mv[i]:9.2f} "
                f"{self.headroom_s[i] * 1e12:11.1f} "
                f"{self.v_dd[i]:7.3f} {self.ber[i]:9.2e} {eta_s:>8}")
        if self.extra:
            lines.append("")
            lines.append("run metrics:")
            for k in sorted(self.extra):
                lines.append(f"  {k:<24} {self.extra[k]:.6g}")
        if self.cache_stats:
            lines.append("")
            lines.append("compile caches (hit/miss/evict):")
            for name, s in sorted(self.cache_stats.items()):
                lines.append(f"  {name:<20} {s['hits']:>6} {s['misses']:>6} "
                             f"{s['evictions']:>6}  ({s['currsize']}"
                             f"/{s['maxsize']} entries)")
        if self.spans:
            lines.append("")
            lines.append("span timings [s] (count / p50 / p99):")
            for name, s in sorted(self.spans.items()):
                lines.append(f"  {name:<26} {s['count']:>5.0f} "
                             f"{s['p50']:.4g} {s['p99']:.4g}")
        return "\n".join(lines)


def _span_summaries(registry) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for name in registry.names():
        m = registry.get(name)
        if isinstance(m, obs_metrics.StreamingHistogram) and \
                (name.endswith("_s") and m.count):
            out[name] = {"count": float(m.count), "p50": m.p50,
                         "p99": m.p99, "mean": m.mean}
    return out


def fleet_health(fleet, *, online_result=None,
                 registry=None) -> FleetHealth:
    """Take one health reading of ``fleet``.

    ``registry`` defaults to the process-global
    :data:`repro_torch.obs.metrics.REGISTRY` (cache stats and span timings
    are read from it, never mutated).  ``online_result`` (the reference's
    online-serving queue metrics) is refused until online serving is
    ported.
    """
    if online_result is not None:
        raise NotImplementedError("online_result= needs online serving "
                                  "(repro.serve.online), which is not "
                                  "ported yet")
    registry = registry or obs_metrics.REGISTRY
    snap = fleet.snapshot()
    t_clk = np.broadcast_to(
        np.asarray(fleet.unit_scenario.t_clk, np.float64).reshape(-1, 1),
        snap.delay.shape)
    return FleetHealth(
        operators=fleet.operators,
        n_shards=fleet.n_shards,
        age_years=np.asarray(fleet.ages_years, np.float64).reshape(-1),
        dvth_p_mv=np.asarray(snap.dvth_p_mv, np.float64).max(axis=-1),
        headroom_s=(t_clk - np.asarray(snap.delay, np.float64)).min(axis=-1),
        v_dd=np.asarray(snap.v_dd, np.float64).max(axis=-1),
        ber=np.asarray(snap.ber, np.float64).max(axis=-1),
        eta_s=eta_to_threshold_s(fleet),
        cache_stats=obs_metrics.cache_stats(),
        spans=_span_summaries(registry),
        extra={},
    )
