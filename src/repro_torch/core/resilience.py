"""DNN error-resilience curves (port of ``repro.core.resilience``, the
published-heterogeneity defaults).

Per-operator accuracy loss is a log-BER logistic,
``loss(ber) = L_max / (1 + exp(-k * (log10(ber) - log10(ber50))))``;
:meth:`ResilienceCurve.tolerable_ber` inverts it, and so does the
fault-tolerant policy (:mod:`repro_torch.core.policy`).  The
measured-curve artifact and its fitting stay in the reference for now.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

# Operator domains of the paper's Table II.
OPERATORS = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down")

# BER at which accuracy loss hits 50% of L_max: sensitive O/Down,
# intermediate K, tolerant rest (REALM-style heterogeneity).
DEFAULT_BER50: Dict[str, float] = {
    "q": 3.2e-3, "k": 1.1e-4, "v": 3.2e-3, "qkt": 3.2e-3, "sv": 3.2e-3,
    "o": 7.0e-7, "gate": 3.2e-3, "up": 3.2e-3, "down": 6.0e-6,
    "r": 3.2e-3, "g": 3.2e-3, "router": 1.1e-4, "embed": 3.2e-3,
}
DEFAULT_STEEPNESS = 5.0     # logistic slope in decades^-1
DEFAULT_LMAX = 100.0        # accuracy collapses to chance at high BER [%]

# Operator-domain sets per architecture family: the paper's 9 attention-LM
# rows apply to dense/MoE/hybrid/encdec/vlm archs (MoE adds its router);
# attention-free families degenerate to their projection set.
FAMILY_OPERATORS: Dict[str, tuple] = {
    "dense": OPERATORS,
    "moe": OPERATORS + ("router",),
    "hybrid": OPERATORS + ("r", "g"),              # rg-lru gates + local attn
    "encdec": OPERATORS,
    "vlm": OPERATORS,
    "ssm": ("q", "k", "v", "g", "o", "up", "down", "r"),   # rwkv projections
}


def operators_for(family: str) -> tuple:
    return FAMILY_OPERATORS.get(family, OPERATORS)


@dataclasses.dataclass(frozen=True)
class ResilienceCurve:
    ber50: float
    steepness: float = DEFAULT_STEEPNESS
    l_max: float = DEFAULT_LMAX

    def accuracy_loss(self, ber: float) -> float:
        """Accuracy loss [%] at a given BER."""
        if ber <= 0.0:
            return 0.0
        x = self.steepness * (math.log10(ber) - math.log10(self.ber50))
        return self.l_max / (1.0 + math.exp(-min(max(x, -60.0), 60.0)))

    def tolerable_ber(self, max_loss_pct: float = 0.5) -> float:
        """Largest BER with accuracy loss <= max_loss_pct [%]."""
        frac = min(max(max_loss_pct / self.l_max, 1e-9), 1.0 - 1e-9)
        x = math.log(frac / (1.0 - frac))
        return 10.0 ** (math.log10(self.ber50) + x / self.steepness)


def default_curves(ops: tuple = OPERATORS) -> Dict[str, ResilienceCurve]:
    return {op: ResilienceCurve(ber50=DEFAULT_BER50[op]) for op in ops}


def tolerable_bers(curves: Mapping[str, ResilienceCurve] | None = None,
                   max_loss_pct: float = 0.5) -> Dict[str, float]:
    """Each curve's tolerable BER at ``max_loss_pct`` (default curves of
    the paper's nine operators when none are given)."""
    curves = curves or default_curves()
    return {op: c.tolerable_ber(max_loss_pct) for op, c in curves.items()}
