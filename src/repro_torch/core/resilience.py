"""DNN error-resilience curves (port of ``repro.core.resilience``).

Per-operator accuracy loss is a log-BER logistic,
``loss(ber) = L_max / (1 + exp(-k * (log10(ber) - log10(ber50))))``;
:meth:`ResilienceCurve.tolerable_ber` inverts it, and so does the
fault-tolerant policy (:mod:`repro_torch.core.policy`).

Two sources of curves: the published heterogeneity (:data:`DEFAULT_BER50`,
which reproduces Table II), and curves measured in-repo by the batched
fault-injection sweep
(:func:`repro_torch.calibrate.resilience_sweep.empirical_resilience`),
fitted by :func:`fit_curve` and kept in ``resilience_calibrated.json``
(the port's byte-identical copy of the reference's artifact), which the
``"measured"`` policy reads through :func:`measured_curves`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from functools import lru_cache
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


# --------------------------------------------------------------------------- #
# the measured-resilience artifact (the counterpart of calibrated.json)
# --------------------------------------------------------------------------- #
MEASURED_PATH = os.path.join(os.path.dirname(__file__),
                             "resilience_calibrated.json")
_REGEN_HINT = (
    "The artifact is written by the batched fault-injection "
    "characterisation sweep.  Regenerate it with:\n"
    "    PYTHONPATH=src python -m repro_torch.launch.calibrate_resilience "
    "--archs all\n"
    "(``--archs <id>`` re-measures one model and merges, ``--quick`` is "
    "the small single-model variant, ``--out`` writes elsewhere)")


def curve_to_dict(c: ResilienceCurve) -> Dict[str, float]:
    return {"ber50": float(c.ber50), "steepness": float(c.steepness),
            "l_max": float(c.l_max)}


def curve_from_dict(d: Mapping[str, float]) -> ResilienceCurve:
    return ResilienceCurve(ber50=float(d["ber50"]),
                           steepness=float(d["steepness"]),
                           l_max=float(d["l_max"]))


@lru_cache(maxsize=None)
def load_measured(path: str = MEASURED_PATH) -> Dict:
    """The raw measured-resilience artifact (cached per path)."""
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"measured-resilience artifact not found: {path}\n"
            + _REGEN_HINT) from None


def measured_curves(model: str,
                    path: str | None = None) -> Dict[str, ResilienceCurve]:
    """Fitted per-operator curves measured for one model.

    Config-name spellings (``"llama3-8b"``) find the arch-id keys
    (``"llama3_8b"``) the sweep CLI writes; a model the artifact does not
    cover raises ``KeyError`` with the command that characterises it.
    """
    models = load_measured(path or MEASURED_PATH).get("models", {})
    if model not in models:
        norm = model.replace("-", "_")
        for key, entry in models.items():
            if norm in (key, str(entry.get("config_name",
                                           "")).replace("-", "_")):
                model = key
                break
    if model not in models:
        raise KeyError(
            f"no measured resilience curves for {model!r}; characterised "
            f"models: {sorted(models)}.  Characterise it with:\n"
            f"    PYTHONPATH=src python -m "
            f"repro_torch.launch.calibrate_resilience --archs {model}")
    return {op: curve_from_dict(d)
            for op, d in models[model]["curves"].items()}


def fit_curve(bers, losses, l_max: float = DEFAULT_LMAX) -> ResilienceCurve:
    """Fit the logistic to measured ``(BER, loss %)`` pairs: a grid search
    over ``log10(ber50)`` in [-9, -1] (81 points) and six steepnesses, in
    float64 numpy (the first minimum of the summed squared error wins)."""
    import numpy as np
    bers = np.asarray(bers, np.float64)
    losses = np.asarray(losses, np.float64)
    lb = np.log10(np.maximum(bers, 1e-12))

    def sse(log_ber50, k):
        x = k * (lb - log_ber50)
        pred = l_max / (1.0 + np.exp(-np.clip(x, -60, 60)))
        return float(((pred - losses) ** 2).sum())

    best = (math.inf, -4.0, DEFAULT_STEEPNESS)
    for log_b50 in np.linspace(-9, -1, 81):
        for k in (1.0, 2.0, 3.5, 5.0, 8.0, 12.0):
            e = sse(log_b50, k)
            if e < best[0]:
                best = (e, log_b50, k)
    return ResilienceCurve(ber50=10.0 ** best[1], steepness=best[2],
                           l_max=l_max)
