"""One-device runtime (port of ``repro.core.runtime``).

:class:`AgingAwareRuntime` is the one-device API — one voltage domain per
operator class (the paper's Table II rows), with simulated age,
per-operator supply voltage, aging state, BER and power draw — as a
:class:`~repro_torch.core.fleet.DeviceView` over a one-device
:class:`~repro_torch.core.fleet.FleetRuntime`.
"""
from __future__ import annotations

from typing import Optional

from .artifacts import Calibration, load_calibration
from .constants import DEFAULT_MAX_LOSS_PCT
from .fleet import DeviceView, FleetRuntime
from .resilience import OPERATORS, default_curves, operators_for


class AgingAwareRuntime(DeviceView):
    def __init__(self, cal: Optional[Calibration] = None, *,
                 fault_tolerant: bool = True,
                 max_loss_pct: float = DEFAULT_MAX_LOSS_PCT,
                 operators: tuple = OPERATORS, curves=None, device="cuda"):
        fleet = FleetRuntime(
            cal or load_calibration(), n_devices=1,
            policy="fault_tolerant" if fault_tolerant else "baseline",
            max_loss_pct=max_loss_pct, operators=operators, curves=curves,
            device=device)
        super().__init__(fleet, 0)

    @classmethod
    def for_model(cls, cfg, **kw) -> "AgingAwareRuntime":
        """Runtime with the architecture family's operator-domain set (an
        MoE model adds its ``router`` domain)."""
        ops = operators_for(cfg.family)
        return cls(operators=ops, curves=default_curves(ops), **kw)
