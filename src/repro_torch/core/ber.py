"""Timing-error / BER model (port of ``repro.core.ber``).

``log10 BER(d) = log10(BER_sat) - a * exp(-(d - t_clk) / tau)``: steep just
past the clock edge, saturating as the violating-path population thins
out; analytically invertible, which the fault-tolerant policy uses.
:func:`solve_ber_model` fits the curve through three (delay, BER) anchors
(the physics calibration's step 3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..device import true_div
from .constants import T_CLK

# Threshold for operators whose tolerable BER exceeds BER_sat: any delay
# beyond the end-of-life delay works; kept finite.
DELAY_MAX_CAP = 2.2e-9


@dataclasses.dataclass
class BerModel:
    log10_sat: float = -4.7     # log10 saturation BER
    a: float = 7.0              # dynamic range [decades]
    tau: float = 30.0e-12       # delay scale [s]
    t_clk: float = T_CLK

    def log10_ber_from_delay(self, d) -> torch.Tensor:
        d = torch.as_tensor(d, dtype=torch.float32)
        return self.log10_sat - self.a * torch.exp(
            true_div(-(d - self.t_clk), self.tau))

    def ber_from_delay(self, d) -> torch.Tensor:
        """BER (float32) of the aged critical-path delay ``d`` [s]."""
        return 10.0 ** self.log10_ber_from_delay(d)

    def delay_max_for_ber(self, ber_tol: float) -> float:
        """Invert BER(d) -> delay threshold [s] for one tolerance, in
        Python floats (clamped to [t_clk, CAP])."""
        gap = self.log10_sat - math.log10(max(ber_tol, 1e-30))
        if gap <= 0.0:          # tolerance above saturation: never reached
            return DELAY_MAX_CAP
        d = self.t_clk - self.tau * math.log(gap / self.a)
        return float(min(max(d, self.t_clk), DELAY_MAX_CAP))

    def delay_for_ber(self, ber_tol) -> torch.Tensor:
        """Invert BER(d) -> delay threshold [s], clamped to [t_clk, CAP]
        (CAP where the tolerance is above saturation), in float32."""
        ber_tol = torch.as_tensor(ber_tol, dtype=torch.float32)
        gap = self.log10_sat - torch.log10(torch.clamp_min(ber_tol, 1e-30))
        d = self.t_clk - self.tau * torch.log(
            true_div(torch.clamp_min(gap, 1e-30), self.a))
        return torch.where(gap <= 0.0, DELAY_MAX_CAP,
                           torch.clamp(d, self.t_clk, DELAY_MAX_CAP))

    def to_dict(self) -> Dict[str, Any]:
        return {"log10_sat": float(self.log10_sat), "a": float(self.a),
                "tau": float(self.tau), "t_clk": float(self.t_clk)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BerModel":
        return cls(**d)


def solve_ber_model(anchors: Dict[float, float], *, t_clk: float = T_CLK,
                    sat_cap: float | None = None) -> BerModel:
    """Solve ``(log10_sat, a, tau)`` through three (delay [s], BER)
    anchors: the ``tau`` ratio equation by 200 geometric bisection steps
    in Python floats, then ``a`` and ``log10_sat`` linearly.  ``sat_cap``
    (a BER) raises if the saturation BER exceeds it."""
    (d1, b1), (d2, b2), (d3, b3) = sorted(anchors.items())
    l1, l2, l3 = (math.log10(b) for b in (b1, b2, b3))
    x1, x2, x3 = (d - t_clk for d in (d1, d2, d3))
    target = (l2 - l1) / (l3 - l2)

    def ratio(tau):
        e1, e2, e3 = (math.exp(-x / tau) for x in (x1, x2, x3))
        return (e1 - e2) / max(e2 - e3, 1e-300)

    lo, hi = 1e-12, 5e-9
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if ratio(mid) > target:
            lo = mid
        else:
            hi = mid
    tau = math.sqrt(lo * hi)
    e1, e2 = math.exp(-x1 / tau), math.exp(-x2 / tau)
    a = (l2 - l1) / (e1 - e2)
    log10_sat = l1 + a * e1
    if sat_cap is not None and log10_sat > math.log10(sat_cap):
        raise ValueError(
            f"BER saturation 1e{log10_sat:.2f} exceeds cap {sat_cap:g}")
    return BerModel(log10_sat=log10_sat, a=a, tau=tau, t_clk=t_clk)
