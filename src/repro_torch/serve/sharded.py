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

On a one-process mesh the shards of the device run on one torch device,
as the fleet lanes run several devices on one card: each faulted weight
matmul is one launch of the fused GEMM's shard mode and each qkt/sv
injection one launch of the counter-upset kernel (``use_fused_kernel=
True``), or the plain product and
:func:`repro_torch.kernels.ops.inject_bitflips_sharded` with the same draws
(``False``), so the tokens equal the reference's on both routes.  Float
params are cast to ``serve_dtype`` (bfloat16) once, as the reference casts
them.

On a mesh over the ranks of a process group
(:func:`repro_torch.launch.mesh.make_serve_mesh` under a started group,
``(world // tp, tp)``), rank ``(r, s)`` holds shard ``s``'s blocks of every
weight the serve layout shards (:func:`repro_torch.distributed.sharding.
shard_tree`; :func:`init_mesh_params` builds them a layer at a time, so no
rank holds the whole tree) and ages them at shard ``s``'s BERs: each
faulted weight matmul is one launch of the fused GEMM on the rank's column
block, the blocks are all-gathered at every op boundary, and the
replicated products (the divisibility fallbacks, the qkt/sv heads with
every shard's streams) run whole on every rank, as on one device.  Keys,
BERs, sampling and the fleet run identically on every rank; each data
replica serves the same prompts, and the engine checks that every rank
returns the same tokens.
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
from ..distributed import collectives
from ..distributed import sharding as shrules
from ..launch.mesh import make_serve_mesh
from ..models import family
from ..models import transformer as tf
from ..models.layers import FaultConfig
from ..obs import metrics as obs_metrics
from ..obs.taps import taps_enabled
from ..tree import leaves, tree_map
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
    # on a mesh over ranks: this rank's all-gathers of the call
    # ({"calls", "bytes", "staged_bytes"}: the "gather" kind of
    # collectives.collective_counts)
    gathers: Optional[Dict[str, int]] = None


def default_serve_mesh(tp: Optional[int] = None, device="cuda"):
    """``("data", "model")`` mesh: one process's ``(1, tp)``, tp
    defaulting to the visible devices; under a started process group its
    ranks, ``(world // tp, tp)``, tp defaulting to the world."""
    return make_serve_mesh(tp, device=device)


def init_mesh_params(cfg: ModelConfig, mesh, seed: int = 0,
                     dtype=torch.bfloat16):
    """Random params of ``cfg`` as :func:`repro_torch.models.family.
    init_params` draws them from ``seed`` on ``mesh.device``, each
    top-level leaf and layer cut to this rank's blocks as soon as it is
    drawn (the serve layout's :func:`~repro_torch.distributed.sharding.
    shard_tree`): a rank holds its blocks, the replicated leaves and one
    leaf's or layer's whole draw at a time, never the whole tree."""
    def place(tree):
        return shrules.shard_tree(tree, shrules.param_specs(
            tree, cfg, mesh, layout="serve"), mesh)
    return family.init_params(cfg, seed, dtype, device=mesh.device,
                              place=place)


def held_bytes(params) -> int:
    """Bytes of the storages ``params``' tensors hold (each storage once):
    a block cut from a whole leaf counts only itself."""
    seen = {}
    for t in leaves(params):
        st = shrules.held(t).untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


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
        GEMM and the counter-upset kernel (on a mesh over ranks: the fused
        GEMM on each rank's blocks); ``False`` the plain product and
        injection, with the same tokens.

        ``mesh`` (default :func:`default_serve_mesh`) may span the ranks of
        a process group: ``params`` is then the whole tree, of which this
        rank keeps its blocks, or a tree of this rank's blocks already
        (:func:`init_mesh_params`); ``device`` is this rank's.  The data
        replicas of a one-process mesh serve the same prompts on the one
        device, so one computation gives them all."""
        tf.check_supported(cfg)
        tf.refuse_quantized(params, "mesh serving")
        self.device = resolve_device(device)
        self.cfg = cfg
        if mesh is None:
            mesh = default_serve_mesh(tp, device=self.device)
        self.mesh = mesh
        self.tp = shrules._tp(mesh)
        self.ranked = getattr(mesh, "model_group", None) is not None
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

        def cast(x):
            return x.to(self.device, serve_dtype) if x.is_floating_point() \
                else x.to(self.device)

        cast_params = tree_map(
            lambda x: x.map(cast) if isinstance(x, shrules.RankBlock)
            else cast(x), params)
        # a placed block's shape is its whole leaf's, so the specs are
        self.specs = shrules.param_specs(cast_params, cfg, mesh,
                                         layout="serve")
        self.params = shrules.shard_tree(cast_params, self.specs, mesh)
        del cast_params
        self.held_bytes = held_bytes(self.params)

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
        before = collectives.collective_counts()["gather"]
        t0 = time.perf_counter()
        with shrules.serve_mesh_scope(self.mesh):
            tokens, telemetry, timings = steps.generate(
                self.params, cfg, torch.as_tensor(np.asarray(prompts),
                                                  dtype=torch.int64,
                                                  device=self.device),
                fi, call_key, max_len=self.max_len, n_steps=int(n_steps),
                temperature=temp, top_k=top_k, **extras)
        span = time.perf_counter() - t0
        gathers = None
        if self.ranked:
            gathers = {k: v - before[k] for k, v in
                       collectives.collective_counts()["gather"].items()}
            if self.mesh.size > 1:
                self._check_same_tokens(tokens)
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
                                  telemetry=telemetry, timings=timings,
                                  gathers=gathers)

    def _check_same_tokens(self, tokens: np.ndarray) -> None:
        """Raise unless every rank of the mesh's group generated
        ``tokens``: the replicas serve the same prompts, and the shards of
        one replica sample from the same gathered logits."""
        mine = torch.as_tensor(tokens, device=self.device)[None]
        every = collectives.all_gather_cat(mine, 0, self.mesh.group)
        if not bool((every == mine).all()):
            bad = [r for r in range(every.shape[0])
                   if not torch.equal(every[r], mine[0])]
            raise RuntimeError(f"rank {self.mesh.rank}: ranks {bad} "
                               f"generated other tokens")
