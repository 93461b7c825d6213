"""Synthetic request-arrival models (port of ``repro.sched.workload``).

A :class:`Workload` describes how much traffic the fleet is offered per
scheduling epoch.  Its leaves (mean load, diurnal depth/period/phase,
burst probability/gain, Poisson grain, surge window) may carry
broadcastable batch dimensions, like :class:`repro_torch.core.scenario.
Scenario` leaves; :meth:`Workload.loads` draws the whole trace over the
epoch grid at once: the diurnal envelope, Poisson counting noise and
Bernoulli flash crowds.

Units: offered load is in *device-equivalents* — ``1.0`` keeps one device
busy for a whole epoch.  The traces equal the reference's bit for bit:
the envelope's ``sin`` and the Poisson sampler's ``log``/``lgamma`` are the
reference backend's (:mod:`repro_torch.fmath`), and the draws are its
threefry streams (:mod:`repro_torch.random`).

* ``poisson`` — stationary mean with Poisson counting noise;
* ``diurnal`` — sinusoidal day/night envelope on the Poisson noise;
* ``bursty`` — Poisson base plus Bernoulli flash crowds;
* ``flash_crowd`` — a sustained overload window (``surge_gain`` x the mean
  over a contiguous stretch of epochs).

``get_workload(name, n_devices=N)`` sizes a registered shape's mean to the
fleet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from .. import fmath
from .. import random as prandom
from ..device import resolve_device

WORKLOAD_FIELDS = ("mean_load", "amplitude", "period", "phase",
                   "burst_prob", "burst_gain", "quanta",
                   "surge_start", "surge_len", "surge_gain")

_F32 = torch.float32


def _leaf(v, device) -> torch.Tensor:
    """A float32 leaf with a trailing epoch axis."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=_F32)[..., None]
    return torch.as_tensor(np.asarray(v, np.float32), device=device)[..., None]


@dataclasses.dataclass(frozen=True)
class Workload:
    """One request-arrival process (or a broadcastable batch of them)."""
    mean_load: Any = 4.0       # mean offered load [device-equivalents]
    amplitude: Any = 0.0       # diurnal modulation depth (0 = flat)
    period: Any = 24.0         # diurnal period [epochs]
    phase: Any = 0.0           # phase offset [epochs]
    burst_prob: Any = 0.0      # per-epoch flash-crowd probability
    burst_gain: Any = 3.0      # load multiplier inside a burst epoch
    quanta: Any = 64.0         # requests per device-epoch (Poisson grain)
    surge_start: Any = 0.0     # flash-crowd window start [epochs]
    surge_len: Any = 0.0       # flash-crowd window length (0 = no surge)
    surge_gain: Any = 1.0      # load multiplier inside the window
    n_epochs: int = 480        # length of the emitted trace
    kind: str = "poisson"      # registry label (provenance only)

    @property
    def batch_shape(self) -> tuple:
        return tuple(torch.broadcast_shapes(
            *(tuple(np.shape(getattr(self, f))) for f in WORKLOAD_FIELDS)))

    def replace(self, **kw) -> "Workload":
        return dataclasses.replace(self, **kw)

    def envelope(self, device="cuda") -> torch.Tensor:
        """Deterministic mean-load trace, ``batch_shape + (E,)``, float32
        on ``device``, each operation rounded as the reference's eager ops
        round it."""
        device = resolve_device(device)
        leaf = lambda f: _leaf(getattr(self, f), device)
        e = torch.arange(self.n_epochs, dtype=_F32, device=device)
        two_pi = torch.full((), 2.0 * math.pi, dtype=_F32, device=device)
        day = 1.0 + leaf("amplitude") * fmath.sin(
            two_pi * (e + leaf("phase")) / leaf("period"))
        start, length = leaf("surge_start"), leaf("surge_len")
        surge = torch.where((e >= start) & (e < start + length),
                            leaf("surge_gain"),
                            torch.ones((), dtype=_F32, device=device))
        return leaf("mean_load") * torch.clamp_min(day, 0.0) * surge

    def loads(self, key=None, device="cuda") -> torch.Tensor:
        """Sample the offered-load trace, ``batch_shape + (E,)``.

        The envelope is quantised into Poisson request counts at
        ``quanta`` requests per device-epoch, then flash-crowd epochs
        multiply their load by ``burst_gain``.  ``key=None`` or an int seed
        ``s`` is the stream of ``PRNGKey(s)``; two calls with one key are
        bit-identical, on every device.  Every field broadcasts against
        the full ``batch_shape`` before sampling, and a zero envelope stays
        exactly zero.
        """
        device = resolve_device(device)
        if key is None or isinstance(key, int):
            key = prandom.PRNGKey(0 if key is None else key)
        k_noise, k_burst = prandom.split(key)
        shape = self.batch_shape + (self.n_epochs,)
        env = torch.broadcast_to(self.envelope(device), shape)
        q = torch.broadcast_to(_leaf(self.quanta, device), shape)
        counts = prandom.poisson(k_noise, env * q, shape, device=device)
        load = counts.to(_F32) / q
        p = _leaf(self.burst_prob, device)
        gain = _leaf(self.burst_gain, device)
        burst = prandom.bernoulli(k_burst, torch.broadcast_to(p, shape),
                                  device=device)
        return torch.where(burst, load * gain, load)

    def to_dict(self) -> Dict[str, Any]:
        d = {f: np.asarray(getattr(self, f).cpu() if isinstance(
            getattr(self, f), torch.Tensor) else getattr(self, f)).tolist()
            for f in WORKLOAD_FIELDS}
        d.update(n_epochs=self.n_epochs, kind=self.kind)
        return d


def poisson(mean_load: float = 4.0, **kw) -> Workload:
    """Stationary Poisson traffic at ``mean_load`` device-equivalents."""
    return Workload(mean_load=mean_load, amplitude=0.0, burst_prob=0.0,
                    kind="poisson", **kw)


def diurnal(mean_load: float = 4.0, amplitude: float = 0.6,
            period: float = 24.0, **kw) -> Workload:
    """Day/night sinusoid (depth ``amplitude``) on Poisson noise."""
    return Workload(mean_load=mean_load, amplitude=amplitude, period=period,
                    burst_prob=0.0, kind="diurnal", **kw)


def bursty(mean_load: float = 3.0, burst_prob: float = 0.05,
           burst_gain: float = 3.0, **kw) -> Workload:
    """Poisson base plus Bernoulli flash crowds multiplying the epoch."""
    return Workload(mean_load=mean_load, amplitude=0.0,
                    burst_prob=burst_prob, burst_gain=burst_gain,
                    kind="bursty", **kw)


def flash_crowd(mean_load: float = 4.0, surge_gain: float = 4.0,
                surge_start=None, surge_len=None, *,
                n_epochs: int = 480, **kw) -> Workload:
    """Sustained overload: ``surge_gain`` x the mean over a contiguous
    window (default: 8%% of the horizon starting at 40%%)."""
    if surge_start is None:
        surge_start = 0.4 * n_epochs
    if surge_len is None:
        surge_len = max(1.0, 0.08 * n_epochs)
    return Workload(mean_load=mean_load, amplitude=0.0, burst_prob=0.0,
                    surge_start=surge_start, surge_len=surge_len,
                    surge_gain=surge_gain, n_epochs=n_epochs,
                    kind="flash_crowd", **kw)


WORKLOADS = {"poisson": poisson, "diurnal": diurnal, "bursty": bursty,
             "flash_crowd": flash_crowd}


def get_workload(name: str, *, n_devices: int = 1, utilization: float = 0.5,
                 **kw) -> Workload:
    """Named workload with its mean sized for an ``n_devices`` fleet
    (``mean_load = utilization * n_devices`` unless given)."""
    try:
        factory = WORKLOADS[name]
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; registered: "
                       f"{sorted(WORKLOADS)}") from None
    kw.setdefault("mean_load", utilization * n_devices)
    return factory(**kw)
