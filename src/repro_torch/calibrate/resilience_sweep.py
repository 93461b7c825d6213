"""Batched fault-injection resilience characterisation (port of
``repro.calibrate.resilience_sweep``).

The fault-tolerant policy is only as good as its per-operator
BER -> accuracy-loss curves.  This module measures them on a model, with
the fault machinery the serving engines use: a lane
:class:`repro_torch.models.layers.FaultConfig` over L = |BER grid| x
|operator domains| fault lanes, lane ``b * O + j`` injecting
``ber_grid[b]`` into ``operators[j]`` and nothing anywhere else.  The
lanes fold lane-major into the batch of one teacher-forced
:func:`repro_torch.models.transformer.forward_logits` per chunk of
``chunk`` lanes, so every faulted weight GEMM makes one launch of the
lane-mode fused kernel per :data:`repro_torch.kernels._cuda.MAX_LANES`
lanes and the qkt/sv domains one lane-mode draw launch, reading each
weight once for the whole chunk.  A lane's result does not depend on the
chunk it runs in: its upsets are drawn over its own rows from its own
key.

Metric: top-1 disagreement [%] against the quantised-but-error-free
execution of the same route (every BER 0), in float32, averaged over
seeds in numpy, as the reference computes it.  The reference's
``TRACE_COUNTS`` has no counterpart: the port traces nothing.

Entry points: :func:`run_sweep` (measure), :func:`fit_sweep` (fit),
:func:`empirical_resilience` (both), :func:`write_artifact` (the JSON
artifact the ``"measured"`` policy reads).  CLI:
``python -m repro_torch.launch.calibrate_resilience``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import random as prandom
from ..configs import ModelConfig
from ..core.resilience import (DEFAULT_LMAX, MEASURED_PATH, ResilienceCurve,
                               curve_to_dict, fit_curve, load_measured,
                               operators_for)
from ..device import resolve_device
from ..kernels import _cuda
from ..models import family
from ..models import transformer as tf
from ..models.layers import FaultConfig

# log10-uniform BER grids: the published curves' range (1e-7 .. 1e-3) with
# headroom on both sides; the quick grid is the small-run variant
DEFAULT_BER_GRID: Tuple[float, ...] = tuple(
    float(b) for b in np.logspace(-7.0, -1.5, 12))
QUICK_BER_GRID: Tuple[float, ...] = tuple(
    float(b) for b in np.logspace(-6.0, -2.0, 5))

# The default chunk's memory budget: a share of the card's free memory at
# the call (torch.cuda.mem_get_info), or a fixed size on the CPU.  A lane
# holds its float32 logits (rows x vocab) and, at the widest point of a
# layer, about six float32 (rows x d_ff) activations (gate, up, their
# product and its quantisation's temporaries).
CHUNK_MEMORY_FRACTION = 0.5
CPU_CHUNK_BUDGET_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Measured loss surface of one model: ``loss_pct[b, j]`` is the top-1
    disagreement [%] at ``ber_grid[b]`` injected into ``operators[j]``."""
    model: str
    family: str
    operators: Tuple[str, ...]
    ber_grid: np.ndarray           # (n_bers,)
    loss_pct: np.ndarray           # (n_bers, n_ops), seed-averaged
    n_seeds: int
    metric: str = "top1_disagreement_pct"


def lane_bytes(cfg: ModelConfig, rows: int) -> int:
    """Device bytes one lane of ``rows`` token rows holds at its peak in a
    sweep forward (its float32 logits and a layer's widest activations)."""
    return rows * 4 * (cfg.vocab + 6 * max(cfg.d_ff, cfg.d_model))


def default_chunk(cfg: ModelConfig, rows: int, n_lanes: int,
                  device) -> int:
    """Lanes per forward: as many as fit the memory budget, at most
    :data:`repro_torch.kernels._cuda.MAX_LANES` (the lanes one GEMM launch
    takes: a wider chunk would read each weight once more per 32 lanes
    and hold more logits for nothing), at least 1."""
    device = torch.device(device)
    if device.type == "cuda":
        budget = CHUNK_MEMORY_FRACTION * torch.cuda.mem_get_info(device)[0]
    else:
        budget = CPU_CHUNK_BUDGET_BYTES
    fit = int(budget // lane_bytes(cfg, rows))
    return max(1, min(fit, _cuda.MAX_LANES, n_lanes))


def grid_fault_config(operators: Tuple[str, ...], ber_grid, key, *,
                      use_kernel: bool = False,
                      fused: bool = False) -> FaultConfig:
    """One lane :class:`FaultConfig` for the whole (BER, operator) grid:
    lane ``b * O + j`` has BER ``ber_grid[b]`` (rounded through float32,
    as the reference's float32 leaves) on ``operators[j]`` and 0 on the
    others, and key ``split(key, L)[b * O + j]``."""
    n_ops = len(operators)
    ber = [float(b) for b in np.asarray(ber_grid, np.float32)]
    n_lanes = len(ber) * n_ops
    bers = {op: tuple(ber[lane // n_ops] if lane % n_ops == j else 0.0
                      for lane in range(n_lanes))
            for j, op in enumerate(operators)}
    return FaultConfig(bers=bers, key=prandom.split(key, n_lanes), step=0,
                       use_systolic_kernel=use_kernel, fused=fused)


def _reference_fault_config(operators: Tuple[str, ...], key, *,
                            use_kernel: bool, fused: bool) -> FaultConfig:
    """The accuracy reference: the same route with every BER 0 (the key is
    never consumed at BER 0)."""
    return FaultConfig(bers={op: 0.0 for op in operators}, key=key, step=0,
                       use_systolic_kernel=use_kernel, fused=fused)


def chunk_of(fi: FaultConfig, l0: int, l1: int) -> FaultConfig:
    """Lanes ``[l0, l1)`` of a lane config."""
    return dataclasses.replace(
        fi, bers={op: tuple(v[l0:l1]) for op, v in fi.bers.items()},
        key=fi.key[l0:l1], seeds=None)


def _lane_rows(x: torch.Tensor, lanes) -> torch.Tensor:
    """``x``'s rows repeated lane-major, once per lane."""
    return x if lanes is None else x.repeat(lanes, *([1] * (x.dim() - 1)))


@torch.no_grad()
def predict(params, cfg: ModelConfig, tokens: torch.Tensor,
            fi: FaultConfig, extras: tuple = ()) -> torch.Tensor:
    """Top-1 predictions of a teacher-forced forward, ``(B, S)`` (lane
    config: ``(lanes * B, S)`` for ``tokens`` repeated lane-major; a
    VLM's prefix embeddings or an enc-dec model's frames in ``extras``,
    repeated alike).  Ties go to the first maximal index, as
    ``jnp.argmax``."""
    lanes = fi.lanes
    kw = {}
    if extras:
        kw[family.extra_name(cfg)] = _lane_rows(extras[0], lanes)
    logits, _ = family.text_logits(params, cfg, _lane_rows(tokens, lanes),
                                   fi=fi.with_seeds(), **kw)
    return logits.argmax(dim=-1)


def lane_losses(params, cfg: ModelConfig, tokens: torch.Tensor,
                ref_pred: np.ndarray, fi: FaultConfig,
                extras: tuple = ()) -> np.ndarray:
    """float32 loss [%] of every lane of ``fi`` in one forward:
    ``100 * (1 - mean(pred == ref_pred))`` over the lane's ``(B, S)``."""
    pred = predict(params, cfg, tokens, fi, extras).cpu().numpy()
    agree = (pred.reshape((fi.lanes,) + ref_pred.shape) == ref_pred)
    n = np.float32(ref_pred.size)
    mean = agree.reshape(fi.lanes, -1).sum(axis=1).astype(np.float32) / n
    return np.float32(100.0) * (np.float32(1.0) - mean)


def grid_losses(params, cfg: ModelConfig, tokens: torch.Tensor,
                ref_pred: np.ndarray, fi: FaultConfig,
                chunk: int, extras: tuple = ()) -> np.ndarray:
    """Every lane's loss, ``chunk`` lanes a forward; ``(L,)`` float32."""
    n = fi.lanes
    return np.concatenate([
        lane_losses(params, cfg, tokens, ref_pred,
                    chunk_of(fi, l0, min(n, l0 + chunk)), extras)
        for l0 in range(0, n, chunk)])


def run_sweep(cfg: ModelConfig, params, tokens, *,
              ber_grid=DEFAULT_BER_GRID,
              operators: Optional[Tuple[str, ...]] = None,
              n_seeds: int = 2, seed: int = 0, extras: tuple = (),
              use_kernel: bool = False, fused: bool = False,
              chunk: Optional[int] = 0, model: Optional[str] = None,
              device="cuda") -> SweepResult:
    """Measure the (BER x operator) loss surface of one model.

    Each seed ``s`` draws the grid's lane keys from ``fold_in(PRNGKey(seed),
    s)`` and evaluates every lane teacher-forced on ``tokens`` against the
    error-free reference of the same route.  ``use_kernel=True`` runs the
    weight matmuls on the kernels (``fused=True``: the fused GEMM, the
    serving path; else the three-pass route), and the qkt/sv domains on
    the draw bitflip; otherwise the plain route.  ``chunk`` is the lanes a
    forward (0 or ``None``: :func:`default_chunk`); it changes no loss.
    ``params`` must live on ``device``.  ``extras`` is ``(prefix_embeds,)``
    for a VLM and ``(frames,)`` for an enc-dec model (broadcast to every
    lane), unused otherwise, as in the reference.
    """
    tf.check_supported(cfg)
    device = resolve_device(device)
    if params["embed"].device.type != device.type:
        raise ValueError(f"params live on {params['embed'].device}, the "
                         f"sweep on {device}")
    operators = tuple(operators or operators_for(cfg.family))
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device=device)
    if family.extra_name(cfg):
        extras = tuple(torch.as_tensor(np.asarray(e, np.float32),
                                       device=device) for e in extras[:1])
    else:
        extras = ()
    key = prandom.PRNGKey(seed)
    ref_fi = _reference_fault_config(operators, key, use_kernel=use_kernel,
                                     fused=fused)
    ref_pred = predict(params, cfg, tokens, ref_fi, extras).cpu().numpy()
    n_lanes = len(ber_grid) * len(operators)
    if not chunk:
        chunk = default_chunk(cfg, tokens.numel(), n_lanes, device)
    chunk = max(1, min(int(chunk), n_lanes))
    per_seed = []
    for s in range(n_seeds):
        fi = grid_fault_config(operators, ber_grid, prandom.fold_in(key, s),
                               use_kernel=use_kernel, fused=fused)
        per_seed.append(grid_losses(params, cfg, tokens, ref_pred, fi,
                                    chunk, extras))
    loss = np.mean(per_seed, axis=0).reshape(len(ber_grid), len(operators))
    return SweepResult(model=model or cfg.name, family=cfg.family,
                       operators=operators,
                       ber_grid=np.asarray(ber_grid, np.float64),
                       loss_pct=loss.astype(np.float64), n_seeds=n_seeds)


def fit_sweep(result: SweepResult,
              l_max: float = DEFAULT_LMAX) -> Dict[str, ResilienceCurve]:
    """Logistic fit per operator column of a measured loss surface."""
    return {op: fit_curve(result.ber_grid, result.loss_pct[:, j],
                          l_max=l_max)
            for j, op in enumerate(result.operators)}


def empirical_resilience(cfg: ModelConfig, params, tokens, *,
                         ber_grid=DEFAULT_BER_GRID, n_seeds: int = 2,
                         seed: int = 0, extras: tuple = (),
                         use_kernel: bool = False, fused: bool = False,
                         model: Optional[str] = None, chunk=0,
                         device="cuda",
                         ) -> Tuple[Dict[str, ResilienceCurve], SweepResult]:
    """Measure and fit: ``(curves, sweep_result)``.  Feed ``curves`` to
    :class:`repro_torch.core.policy.MeasuredResiliencePolicy`, or persist
    them with :func:`write_artifact` for ``policy="measured"``."""
    res = run_sweep(cfg, params, tokens, ber_grid=ber_grid, n_seeds=n_seeds,
                    seed=seed, extras=extras, use_kernel=use_kernel,
                    fused=fused, model=model, chunk=chunk, device=device)
    return fit_sweep(res), res


def write_artifact(entries: Dict[str, Tuple[SweepResult,
                                            Dict[str, ResilienceCurve]]],
                   meta: Dict, path: str = MEASURED_PATH) -> Dict:
    """Merge measured models into the artifact at ``path``.

    ``entries`` maps arch id -> (sweep result, fitted curves); models
    already in the file and not measured now are kept.  The raw measured
    points are stored beside the fits.  Clears :func:`load_measured`'s
    cache so the next read sees the new file.
    """
    try:
        with open(path) as f:
            blob = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        blob = {}
    blob["_meta"] = dict(
        meta, generator="PYTHONPATH=src python -m "
                        "repro_torch.launch.calibrate_resilience",
        metric="top1_disagreement_pct")
    models = blob.setdefault("models", {})
    for arch, (res, curves) in entries.items():
        models[arch] = {
            "config_name": res.model,
            "family": res.family,
            "ber_grid": [float(b) for b in res.ber_grid],
            "n_seeds": res.n_seeds,
            "curves": {op: curve_to_dict(curves[op])
                       for op in res.operators},
            "loss_pct": {op: [float(v) for v in res.loss_pct[:, j]]
                         for j, op in enumerate(res.operators)},
        }
    with open(path, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
        f.write("\n")
    load_measured.cache_clear()
    return blob
