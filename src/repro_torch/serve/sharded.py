"""Mesh serving: one model over ``tp`` tensor-parallel shards, each shard
an aging unit of its own (port of ``repro.serve.sharded``).

The reference serves one model too big for a device over a ``("data",
"model")`` mesh with the exact serve layout of
:mod:`repro_torch.distributed.sharding` (weights shard only on output
dimensions, so the sharded tokens equal the single-device ones) and ages
each shard on its own: with a shard-granular
:class:`repro_torch.core.fleet.FleetRuntime` (``n_shards == tp``) the
fault config holds ``(S,)`` per-operator BER vectors, and every weight
matmul's output-column block (the columns shard ``s`` owns under the serve
layout) and every qkt/sv head block flips at shard ``s``'s admitted rate,
from a shard-distinct counter stream.

Here the shards of the device run on one torch device, as the fleet lanes
run several devices on one card: each faulted weight matmul is one launch
of the fused GEMM's shard mode and each qkt/sv injection one launch of the
counter-upset kernel (``use_fused_kernel=True``), or the plain product and
:func:`repro_torch.kernels.ops.inject_bitflips_sharded` with the same draws
(``False``), so the tokens equal the reference's on both routes.  Float
params are cast to ``serve_dtype`` (bfloat16) once, as the reference casts
them.  Placing the shards over several processes is ROADMAP A.8c.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import random as prandom
from ..configs import ModelConfig
from ..core.fleet import FleetRuntime
from ..device import resolve_device
from ..distributed import sharding as shrules
from ..launch.mesh import make_serve_mesh
from ..models import transformer as tf
from ..models.layers import FaultConfig
from ..obs import metrics as obs_metrics
from ..obs.taps import taps_enabled
from ..tree import tree_map
from . import steps
from .engine import ServeEngine, _extras, _ServedShapes

_MESH_GENERATE = _ServedShapes("mesh_generate")


@dataclasses.dataclass
class MeshGenerateResult:
    tokens: np.ndarray           # (B, steps) generated ids
    bers: np.ndarray             # (S, O) per-shard BERs served ((1, O) uniform)
    operators: tuple             # column order of ``bers``
    ages_years: np.ndarray       # (S,) per-shard ages
    power_w: float
    telemetry: Optional[Dict[str, np.ndarray]] = None   # {name: (steps,)}
    # host-clock phase times of the call: {"prefill_s", "decode_s"}
    timings: Optional[Dict[str, float]] = None


def default_serve_mesh(tp: Optional[int] = None, device="cuda"):
    """``("data", "model")`` mesh of shape ``(1, tp)``, tp defaulting to
    the visible devices."""
    return make_serve_mesh(tp, device=device)


class MeshServeEngine:
    """Serve one model over ``tp`` shards with per-shard aging."""

    def __init__(self, cfg: ModelConfig, params, *, mesh=None,
                 tp: Optional[int] = None,
                 fleet: Optional[FleetRuntime] = None, fleet_device: int = 0,
                 runtime=None, max_len: int = 512, seed: int = 0,
                 serve_dtype=torch.bfloat16, use_fused_kernel: bool = True,
                 device="cuda"):
        """``fleet`` (shard-granular, ``n_shards == tp``) gives fleet device
        ``fleet_device``'s per-shard BERs (the reference's ``device=``);
        alternatively a single-device ``runtime`` serves shard-uniform
        scalar BERs on the kernel-free route (the reference's legacy
        threefry streams); neither serves clean.  ``params`` may live
        anywhere: float leaves are cast to ``serve_dtype`` on ``device``
        once.  ``use_fused_kernel`` (fleet path) runs the shard-mode fused
        GEMM and the counter-upset kernel; ``False`` the plain product and
        injection, with the same tokens."""
        tf.check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        if mesh is None:
            mesh = default_serve_mesh(tp, device=self.device)
        if shrules._dp(mesh) != 1:
            raise NotImplementedError(
                "a mesh with more than one data replica needs its shards "
                "placed over several processes: ROADMAP A.8c")
        self.mesh = mesh
        self.tp = shrules._tp(mesh)
        if fleet is not None and runtime is not None:
            raise ValueError("pass a shard-granular fleet= or a uniform "
                             "runtime=, not both")
        if fleet is not None:
            if fleet.n_shards != self.tp:
                raise ValueError(f"fleet n_shards={fleet.n_shards} != mesh "
                                 f"tp={self.tp}")
            if not 0 <= fleet_device < fleet.n_devices:
                raise IndexError(f"device {fleet_device} of "
                                 f"{fleet.n_devices}")
        self.fleet = fleet
        self.fleet_device = fleet_device
        if isinstance(runtime, FleetRuntime):
            runtime = runtime.device(fleet_device)
        self.runtime = runtime
        self.use_fused_kernel = bool(use_fused_kernel)
        self.max_len = max_len
        self._key = prandom.PRNGKey(seed)
        # the per-op BERs of the fleet's last shard-BER table (the array
        # object is the fleet's until its ages change)
        self._ber_cache: Optional[tuple] = None
        self.params = tree_map(
            lambda x: x.to(self.device, serve_dtype)
            if x.is_floating_point() else x.to(self.device), params)
        self.specs = shrules.param_specs(self.params, cfg, mesh,
                                         layout="serve")

    def _fault_config(self) -> Optional[FaultConfig]:
        """(S,)-vector BERs from the fleet's shard rows, or the runtime's
        scalars on the kernel-free route; None serves clean."""
        if self.fleet is None and self.runtime is None:
            return None
        self._key, sub = prandom.split(self._key)
        if self.fleet is not None:
            tab = self.fleet.op_ber_shard_array()
            if self._ber_cache is None or self._ber_cache[0] is not tab:
                ber = tab[self.fleet_device]                     # (S, O)
                self._ber_cache = (tab, {
                    op: tuple(float(b) for b in ber[:, i])
                    for i, op in enumerate(self.fleet.operators)})
            fused = self.use_fused_kernel
            return FaultConfig(bers=self._ber_cache[1], key=sub, step=0,
                               use_systolic_kernel=fused, fused=fused)
        return FaultConfig(bers=dict(self.runtime.op_bers()), key=sub,
                           step=0, use_systolic_kernel=False, fused=False)

    @torch.no_grad()
    def generate(self, prompts, n_steps: int, *, prefix_embeds=None,
                 frames=None, greedy: bool = True,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None) -> MeshGenerateResult:
        """prompts: (B, S) int -> ``n_steps`` tokens (greedy, or sampled
        with ``temperature`` / ``top_k``), with the ``(S, O)`` BERs the
        shards served."""
        cfg = self.cfg
        fi = self._fault_config()
        self._key, call_key = prandom.split(self._key)
        extras = _extras(cfg, prefix_embeds, frames, self.device)
        temp = ServeEngine._temperature(greedy, temperature)
        cold = _MESH_GENERATE(cfg, self.max_len, int(n_steps), top_k,
                              self.mesh)
        t0 = time.perf_counter()
        tokens, telemetry, timings = steps.generate(
            self.params, cfg, torch.as_tensor(np.asarray(prompts),
                                              dtype=torch.int64,
                                              device=self.device),
            fi, call_key, max_len=self.max_len, n_steps=int(n_steps),
            temperature=temp, top_k=top_k, **extras)
        span = time.perf_counter() - t0
        if taps_enabled():
            obs_metrics.REGISTRY.counter(
                "mesh_generate_calls", "sharded generate() dispatches").inc()
            obs_metrics.observe_span("mesh_generate_compile_s" if cold
                                     else "mesh_generate_warm_s", span)
        else:
            telemetry = None
        if self.fleet is not None:
            fl = self.fleet
            ops = fl.operators
            bers = np.asarray(fl.op_ber_shard_array()[self.fleet_device])
            ages = np.asarray(fl.ages_years).reshape(
                fl.n_devices, fl.n_shards)[self.fleet_device]
            power = float(fl.fleet_power()[self.fleet_device])
        elif self.runtime is not None:
            d = self.runtime.op_bers()
            ops = tuple(d)
            bers = np.asarray([[d[o] for o in ops]])
            ages = np.asarray([self.runtime.age_years])
            power = float(self.runtime.total_power())
        else:
            ops, bers = (), np.zeros((1, 0))
            ages, power = np.zeros(1), 0.0
        return MeshGenerateResult(tokens=tokens, bers=bers, operators=ops,
                                  ages_years=ages, power_w=power,
                                  telemetry=telemetry, timings=timings)
