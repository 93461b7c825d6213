"""Serving-health and co-sim telemetry taps (port of ``repro.obs.taps``).

The taps are cheap scalars computed beside the primary result: the
per-step logit health of generation (:func:`logit_taps`) and the
per-epoch aging odometer of a traffic co-sim (:func:`cosim_taps`).  The
toggle (:func:`enable_taps` / :func:`taps_enabled`) is host state only:
it decides whether the serving engines return the taps and record them
into :data:`repro_torch.obs.metrics.REGISTRY`, never what the forward
computes, so tokens with taps on equal tokens with taps off.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["Telemetry", "taps_enabled", "enable_taps", "logit_taps",
           "cosim_taps", "telemetry_to_host"]


class Telemetry:
    """A named bundle of telemetry series, ``{signal name: array}``."""

    def __init__(self, series: Optional[Dict[str, Any]] = None):
        self.series: Dict[str, Any] = dict(series or {})

    def __getitem__(self, key: str):
        return self.series[key]

    def __contains__(self, key: str) -> bool:
        return key in self.series

    def keys(self):
        return self.series.keys()

    def items(self):
        return self.series.items()

    def __repr__(self):
        return f"Telemetry({sorted(self.series)})"


# host-side toggle: read by the engines, never by the forward
_ENABLED = [False]


def taps_enabled() -> bool:
    """Whether the engines return telemetry and record it."""
    return _ENABLED[0]


@contextlib.contextmanager
def enable_taps(on: bool = True):
    """Context manager flipping the host-side taps toggle."""
    prev = _ENABLED[0]
    _ENABLED[0] = bool(on)
    try:
        yield
    finally:
        _ENABLED[0] = prev


def logit_taps(logits: torch.Tensor, lanes: Optional[int] = None,
               active: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """Batch-mean max logit and top1-top2 margin of a ``(batch, vocab)``
    slab — both fall as admitted BER corrupts the forward pass.  With
    ``lanes=N`` the batch folds N lanes lane-major and each tap is ``(N,)``,
    every lane's mean over its own rows (the reference's taps under
    ``jax.vmap``).  ``active`` (``(batch,)`` bool, online serving) weighs
    out the idle slots, whose logits are garbage: the means are over the
    live rows, and 0 where no row is live."""
    top2 = torch.topk(logits, 2, dim=-1).values
    peak, margin = top2[..., 0], top2[..., 0] - top2[..., 1]
    if lanes is not None:
        peak, margin = peak.reshape(lanes, -1), margin.reshape(lanes, -1)
    if active is None:
        return {"logit_max": peak.mean(dim=-1),
                "logit_margin": margin.mean(dim=-1)}
    w = active.to(logits.dtype).reshape(peak.shape)
    denom = torch.clamp(w.sum(dim=-1), min=1.0)
    return {"logit_max": (peak * w).sum(dim=-1) / denom,
            "logit_margin": (margin * w).sum(dim=-1) / denom}


def cosim_taps(cos, scenario) -> Telemetry:
    """The per-epoch aging odometer of a co-sim trajectory.

    ``cos`` is a :class:`repro_torch.sched.lifetime.CoSimTrajectory`
    (epoch axis first, fields ``(E, N, O)``); every series comes out
    device-leading, ``(N, E)``: ``dvth_eff_mv`` (effective PMOS ΔVth of
    the worst domain), ``dvth_mono_mv`` (the monotone PMOS total of the
    per-population state), ``headroom_s`` (``t_clk`` minus the worst
    delay), ``vdd_v`` (the highest supply), ``util``, and ``t_node_k`` /
    ``boosts`` when the co-sim ran them.  float32 host arithmetic on the
    trajectory's host arrays, in the reference's order.
    """
    from ..core.aging import IS_PMOS
    f32 = lambda x: np.asarray(x, np.float32)
    dvp, dv = f32(cos.dvp), f32(cos.dv)                 # (E,N,O), (E,N,O,P)
    mono_p = np.sum(dv * IS_PMOS.astype(np.float32), axis=-1,
                    dtype=np.float32)
    t_clk = f32(scenario.t_clk).reshape(-1)             # (N,) or (1,)
    dev = lambda x: np.ascontiguousarray(np.moveaxis(x, 0, 1))
    series = {
        "dvth_eff_mv": dev(dvp.max(axis=-1)),
        "dvth_mono_mv": dev(mono_p.max(axis=-1)),
        "headroom_s": dev(t_clk - f32(cos.delay).max(axis=-1)),
        "vdd_v": dev(f32(cos.V).max(axis=-1)),
        "util": dev(f32(cos.util)),
    }
    if getattr(cos, "t_node", None) is not None:
        series["t_node_k"] = dev(f32(cos.t_node))
    if getattr(cos, "boosts", None) is not None:
        series["boosts"] = dev(np.asarray(cos.boosts))
    return Telemetry(series)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def telemetry_to_host(telem) -> Optional[Dict[str, Any]]:
    """Every series of a :class:`Telemetry` (or ``{name: array}``) as a
    host numpy array; ``None`` stays ``None``."""
    if telem is None:
        return None
    return {k: _host(v) for k, v in telem.items()}
