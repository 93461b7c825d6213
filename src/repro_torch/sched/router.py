"""Routing policies: who serves this epoch's traffic (port of
``repro.sched.router``).

A router maps one epoch's offered load (in device-equivalents) and the
fleet's per-device state onto a per-device utilization vector, the stress
input of the aging model.  The protocol mirrors
:class:`repro_torch.core.policy.Policy`::

    assign(load, wear, util_prev, capacity) -> tensor (N,)

with ``load`` a 0-d tensor (or number), ``wear`` the per-device wear signal
(ΔVth_p in mV, worst operator domain), ``util_prev`` the previous epoch's
assignment and ``capacity`` the per-device ceiling.  Every router is a
vectorised assignment over the device axis on the tensors' device: sorts,
clips and a fixed 40-step waterfill bisection, with no host
synchronisation, so the co-simulation can run an epoch on the card
without waiting for it.

* ``round_robin`` — uniform spread, aging-blind (the baseline);
* ``least_loaded`` — waterfill on the previous epoch's utilization;
* ``least_aged`` — fill the least-worn devices to capacity first;
* ``wear_level`` — waterfill on the wear signal (minimises fleet-max ΔVth);
* ``rest_to_recover`` — wear-level steering plus idling the most-worn
  devices while the rest can carry the load.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Protocol, runtime_checkable

import torch

_F32 = torch.float32


@runtime_checkable
class Router(Protocol):
    """Anything that maps (load, fleet state) to per-device utilization."""

    def assign(self, load, wear, util_prev, capacity=1.0) -> torch.Tensor:
        """Per-device utilization for this epoch, shape ``(N,)``."""
        ...


ROUTER_REGISTRY: Dict[str, type] = {}


def register_router(cls):
    """Class decorator: register a router under its ``name`` attribute."""
    ROUTER_REGISTRY[cls.name] = cls
    return cls


def get_router(name_or_router, **kw) -> "Router":
    """Resolve a registered router by name (instances pass through)."""
    if not isinstance(name_or_router, str):
        return name_or_router
    try:
        return ROUTER_REGISTRY[name_or_router](**kw)
    except KeyError:
        raise KeyError(f"unknown router {name_or_router!r}; registered: "
                       f"{sorted(ROUTER_REGISTRY)}") from None


def _f32(x, device) -> torch.Tensor:
    """``x`` as float32 on ``device``; a number is filled there (a host
    tensor copied over would make the caller wait for the device)."""
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=_F32, device=device)
    return torch.as_tensor(x, dtype=_F32, device=device)


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the device axis (0) in index order, as the reference
    backend reduces a short vector; ``Tensor.sum`` may pair the terms
    otherwise, and one ulp of a bisection's total can move its water
    level."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Running sum over axis 0 in index order, in float32 (the reference
    lowers ``cumsum`` to a sequential window reduction; CPU
    ``torch.cumsum`` accumulates float32 in float64)."""
    acc, out = x[0], [x[0]]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
        out.append(acc)
    return torch.stack(out)


def _servable(load, n, capacity, device):
    """Load the fleet can serve this epoch (the rest is dropped), and the
    per-device capacity ``(n,)``."""
    cap = torch.broadcast_to(_f32(capacity, device), (n,))
    return torch.minimum(_f32(load, device), seq_sum(cap)), cap


def waterfill(levels, load, capacity, *, gain=1.0, n_iter: int = 40
              ) -> torch.Tensor:
    """Allocate ``load`` by flooding the lowest ``levels`` first.

    Solves ``sum_i clip((lam - levels_i) * gain, 0, capacity_i) = load``
    for the water level ``lam`` by ``n_iter`` bisection steps, each a
    ``torch.where`` on the device (no data-dependent exit).  Identical
    levels give the uniform split; zero load gives exactly zero.
    """
    levels = torch.as_tensor(levels, dtype=_F32)
    dev = levels.device
    load, cap = _servable(load, levels.shape[0], capacity, dev)
    gain = _f32(gain, dev)
    lo = levels.min()
    hi = levels.max() + cap.max() / torch.clamp_min(gain, 1e-9)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        under = seq_sum(torch.minimum(
            torch.clamp_min((mid - levels) * gain, 0.0), cap)) < load
        lo, hi = torch.where(under, mid, lo), torch.where(under, hi, mid)
    u = torch.minimum(torch.clamp_min((0.5 * (lo + hi) - levels) * gain,
                                      0.0), cap)
    return torch.where(load > 0.0, u, torch.zeros((), dtype=_F32,
                                                  device=dev))


def _wear_levels(wear: torch.Tensor) -> torch.Tensor:
    """Wear normalised to [0, 1] over the fleet's spread."""
    spread = torch.clamp_min(wear.max() - wear.min(), 1e-6)
    return (wear - wear.min()) / spread


@register_router
@dataclasses.dataclass(frozen=True)
class RoundRobinRouter:
    """Uniform spread (``load / N`` each), with a saturated device's
    overflow redistributed: waterfill on flat levels."""
    name = "round_robin"

    def assign(self, load, wear, util_prev, capacity=1.0) -> torch.Tensor:
        return waterfill(torch.zeros_like(wear), load, capacity)


@register_router
@dataclasses.dataclass(frozen=True)
class LeastLoadedRouter:
    """Waterfill on the previous epoch's utilization (queue balancing)."""
    name = "least_loaded"

    def assign(self, load, wear, util_prev, capacity=1.0) -> torch.Tensor:
        return waterfill(util_prev, load, capacity)


@register_router
@dataclasses.dataclass(frozen=True)
class LeastAgedRouter:
    """Fill the least-worn devices to capacity first."""
    name = "least_aged"

    def assign(self, load, wear, util_prev, capacity=1.0) -> torch.Tensor:
        load, cap = _servable(load, wear.shape[0], capacity, wear.device)
        order = torch.argsort(wear, stable=True)         # least aged first
        cap_sorted = cap[order]
        before_sorted = seq_cumsum(cap_sorted) - cap_sorted
        before = before_sorted[torch.argsort(order, stable=True)]
        return torch.minimum(torch.clamp_min(load - before, 0.0), cap)


@register_router
@dataclasses.dataclass(frozen=True)
class WearLevelRouter:
    """Waterfill on the wear signal: devices below the fleet's wear level
    take ``gain`` utilization per normalised-wear unit of headroom."""
    name = "wear_level"
    gain: float = 4.0           # steering aggressiveness

    def assign(self, load, wear, util_prev, capacity=1.0) -> torch.Tensor:
        return waterfill(_wear_levels(wear), load, capacity, gain=self.gain)


@register_router
@dataclasses.dataclass(frozen=True)
class RestToRecoverRouter:
    """Idle the most-worn devices to harvest short-term recovery.

    The ``rest_frac`` most-worn devices rest while the capacity left
    covers the servable load (the longest most-worn-first prefix that
    keeps ``sum(capacity[active]) >= load``); the active set is
    wear-levelled.  Ranks come from a stable sort, so tied wear (a fresh
    fleet) ranks by device index, as the reference's ``argsort`` does.
    """
    name = "rest_to_recover"
    rest_frac: float = 0.25     # fraction of the fleet eligible to rest
    gain: float = 4.0           # wear-level steering for the active set

    def assign(self, load, wear, util_prev, capacity=1.0) -> torch.Tensor:
        n = wear.shape[0]
        load, cap = _servable(load, n, capacity, wear.device)
        k_max = int(min(n - 1, round(self.rest_frac * n)))
        order = torch.argsort(-wear, stable=True)        # most worn first
        rank = torch.argsort(order, stable=True)         # 0 == most worn
        remaining = seq_sum(cap) - seq_cumsum(cap[order])
        can_rest = (rank < k_max) & (remaining[rank] >= load)
        cap_active = torch.where(can_rest, 0.0, cap)
        return waterfill(_wear_levels(wear), load, cap_active, gain=self.gain)
