"""Aging-aware serving engine — the paper's technique as a runtime feature.

Serves one device of an AVS runtime (a :class:`repro_torch.core.fleet.
FleetRuntime` device, or any object exposing ``op_bers / age_years /
total_power``).  Before each generation call it snapshots the runtime's
per-operator BERs into a :class:`FaultConfig`, so every matmul executes at
the error rate the fault-tolerant policy admits at the device's current
age.  Key handling is the reference's: one ``split`` of the engine key for
the fault config, one for the call's sampling key.

Routes: ``use_systolic_kernel=False`` is kernel-free (plain int8 matmul +
plain injection); ``use_systolic_kernel=True`` runs the weight matmuls
through the fused CUDA kernel (``use_fused_kernel=True``) or the
three-pass route (int8 GEMM kernel -> bitflip kernel, which draws its own
threefry randoms), and the qkt/sv domains through the bitflip kernel.
:meth:`ServeEngine.score` is the mean next-token NLL of a token batch
under the same aged device.

:class:`FleetServeEngine` serves every device of a :class:`FleetRuntime`
at once — the reference's ``vmap`` of the generation function over fleet
lanes — as one lane-batched forward per step: the lanes fold into the
batch axis lane-major, each faulted op makes one launch for all lanes (the
lane modes of the fused GEMM and of the draw-mode bitflip) and reads each
weight once, and every lane runs at its own row of the fleet's BER matrix
with its own fault and sampling streams.  Built with ``router=``, it first
ages the fleet under routed traffic (:meth:`FleetRuntime.apply_load`), so
the lanes serve traffic-aged BERs.

Telemetry is the reference's: ``generate`` returns the logit taps, and
records the call into :data:`repro_torch.obs.metrics.REGISTRY`, only
under :func:`repro_torch.obs.taps.enable_taps`; the tokens are the same
either way.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import random as prandom
from ..configs import ModelConfig
from ..core.fleet import FleetRuntime
from ..device import resolve_device
from ..models import family
from ..models import transformer as tf
from ..models.layers import FaultConfig
from ..obs import metrics as obs_metrics
from ..obs.taps import taps_enabled
from ..train.steps import softmax_xent
from . import steps


class _ServedShapes:
    """The keys a generate function has served in this process, counted
    as the reference counts its compile cache (registered with
    :func:`repro_torch.obs.metrics.register_cache` under the reference's
    cache name).  The port compiles nothing per shape: a call is "cold"
    (recorded as ``*_compile_s``) the first time its key is served, which
    is also when kernels are built and libraries load."""

    def __init__(self, name: str):
        self.name = name
        self._keys: set = set()
        self.hits = self.misses = self.evictions = 0
        obs_metrics.register_cache(self)

    def __call__(self, *key) -> bool:
        """Count one call of ``key``; True when it is the first."""
        if key in self._keys:
            self.hits += 1
            return False
        self.misses += 1
        self._keys.add(key)
        return True

    def clear(self) -> None:
        self._keys.clear()

    def stats(self) -> Dict[str, int]:
        return {"currsize": len(self._keys), "maxsize": -1,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


_GENERATE = _ServedShapes("generate")
_FLEET_GENERATE = _ServedShapes("fleet_generate")


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray           # (B, steps) generated ids
    bers: Dict[str, float]       # per-operator BER used
    age_years: float
    power_w: float
    # per-step serving-health series {name: (n_steps,)} (logit taps),
    # None unless taps are enabled
    telemetry: Optional[Dict[str, np.ndarray]] = None
    # host-clock phase times of the call: {"prefill_s", "decode_s"}
    timings: Optional[Dict[str, float]] = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, runtime=None,
                 runtime_device: int = 0, max_len: int = 512,
                 use_systolic_kernel: bool = False,
                 use_fused_kernel: bool = True, seed: int = 0,
                 device="cuda"):
        """``runtime`` is a :class:`FleetRuntime` (served from its device
        ``runtime_device`` — the reference's ``device=`` index) or any
        object exposing ``op_bers / age_years / total_power``.  ``params``
        must already live on ``device`` (``init_params(device=...)`` or
        :func:`repro_torch.convert.params_from_reference`)."""
        tf.check_supported(cfg)
        self.device = _check_params(cfg, params, device)
        self.cfg = cfg
        self.params = params
        if isinstance(runtime, FleetRuntime):
            runtime = runtime.device(runtime_device)
        self.runtime = runtime
        self.max_len = max_len
        self.use_kernel = use_systolic_kernel
        self.use_fused = use_fused_kernel
        self._key = prandom.PRNGKey(seed)

    def _fault_config(self) -> Optional[FaultConfig]:
        if self.runtime is None:
            return None
        self._key, sub = prandom.split(self._key)
        return FaultConfig(bers=dict(self.runtime.op_bers()), key=sub,
                           step=0, use_systolic_kernel=self.use_kernel,
                           fused=self.use_fused)

    @staticmethod
    def _temperature(greedy: bool, temperature: Optional[float]) -> float:
        """Resolve the legacy ``greedy`` flag against ``temperature``."""
        if temperature is None:
            temperature = 0.0 if greedy else 1.0
        return float(temperature)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=self.device)

    @torch.no_grad()
    def generate(self, prompts, n_steps: int, *, prefix_embeds=None,
                 frames=None, greedy: bool = True,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None) -> GenerateResult:
        """prompts: (B, S) int.  Returns ``n_steps`` generated tokens.
        A VLM takes ``prefix_embeds`` (B, prefix_tokens, d), an enc-dec
        model ``frames`` (B, encoder_seq, d).

        ``temperature=0`` (or the legacy ``greedy=True``) is the exact
        argmax; a positive temperature samples ``softmax(logits / T)``
        restricted to the ``top_k`` highest logits when given."""
        extras = _extras(self.cfg, prefix_embeds, frames, self.device)
        fi = self._fault_config()
        self._key, call_key = prandom.split(self._key)
        temperature = self._temperature(greedy, temperature)
        cold = _GENERATE(self.cfg, self.max_len, int(n_steps), top_k)
        t0 = time.perf_counter()
        tokens, telemetry, timings = steps.generate(
            self.params, self.cfg, self._tokens(prompts), fi, call_key,
            max_len=self.max_len, n_steps=int(n_steps),
            temperature=temperature, top_k=top_k, **extras)
        span = time.perf_counter() - t0
        if taps_enabled():
            self._record(tokens, telemetry, span, cold)
        else:
            telemetry = None
        rt = self.runtime
        bers = rt.op_bers() if rt else {}
        return GenerateResult(
            tokens=tokens, bers={k: float(v) for k, v in bers.items()},
            age_years=rt.age_years if rt else 0.0,
            power_w=rt.total_power() if rt else 0.0,
            telemetry=telemetry, timings=timings)

    def _record(self, tokens, telemetry, span_s: float, cold: bool) -> None:
        """Fold one generate call into the metrics registry, as the
        reference's engine does."""
        reg = obs_metrics.REGISTRY
        reg.counter("serve_generate_calls", "generate() dispatches").inc()
        reg.counter("serve_tokens", "tokens generated").inc(tokens.size)
        obs_metrics.observe_span("serve_generate_compile_s" if cold
                                 else "serve_generate_warm_s", span_s)
        for sig in ("logit_max", "logit_margin"):
            if telemetry and sig in telemetry:
                reg.histogram("serve_" + sig, "per-step serving health") \
                   .observe_many(np.asarray(telemetry[sig]).ravel())
        if self.runtime is not None:
            bers = self.runtime.op_bers()
            if bers:
                reg.gauge("serve_admitted_ber_max",
                          "worst per-operator BER served") \
                   .set(max(float(v) for v in bers.values()))

    @torch.no_grad()
    def score(self, tokens, *, prefix_embeds=None, frames=None) -> float:
        """Mean next-token NLL of a token batch (B, S) under the aged
        device: one forward over ``tokens[:, :-1]`` against
        ``tokens[:, 1:]``, with a fault config of its own (an enc-dec
        model encodes ``frames`` first; a VLM's prefix logits are
        dropped)."""
        fi = self._fault_config()
        tokens = self._tokens(tokens)
        extras = _extras(self.cfg, prefix_embeds, frames, self.device)
        logits, _ = family.text_logits(self.params, self.cfg,
                                       tokens[:, :-1], fi=fi, **extras)
        return float(softmax_xent(logits, tokens[:, 1:]))


def _check_params(cfg: ModelConfig, params, device) -> torch.device:
    """The engine's device, which the params must live on; an int8 tree
    (:func:`repro_torch.models.transformer.quantize_params`) serves every
    decoder family, and the enc-dec family refuses it."""
    device = resolve_device(device)
    if cfg.n_encoder_layers:
        tf.refuse_quantized(params, "the enc-dec family")
    on = tf.params_device(params)
    if on.type != device.type:
        raise ValueError(f"params live on {on}, the engine on {device}")
    return device


def _extras(cfg: ModelConfig, prefix_embeds, frames, device) -> Dict:
    """``{"frames": ...}`` for an enc-dec model, ``{"prefix_embeds":
    ...}`` for a prefix model (float32 tensors on ``device``), ``{}``
    otherwise; raises when the family's extra is missing."""
    name = family.extra_name(cfg)
    if name is None:
        return {}
    x = frames if name == "frames" else prefix_embeds
    if x is None:
        raise ValueError(f"the {cfg.family} family needs {name}=")
    return {name: torch.as_tensor(np.asarray(x, np.float32)
                                  if not isinstance(x, torch.Tensor) else x,
                                  dtype=torch.float32, device=device)}


def refuse_sharded_fleet(fleet, engine: str) -> None:
    """The lane engines serve whole devices; a shard-granular fleet is the
    mesh engine's."""
    if getattr(fleet, "n_shards", 1) != 1:
        raise ValueError(f"{engine} serves whole devices; a shard-granular "
                         f"fleet (n_shards > 1) is served by "
                         f"repro_torch.serve.sharded.MeshServeEngine")


@dataclasses.dataclass
class FleetGenerateResult:
    tokens: np.ndarray           # (N, B, steps) generated ids per lane
    bers: np.ndarray             # (N, O) per-operator BER served per lane
    operators: Tuple[str, ...]   # column order of ``bers``
    ages_years: np.ndarray       # (N,)
    power_w: np.ndarray          # (N,)
    # per-lane serving-health series {name: (N, steps)} (logit taps),
    # None unless taps are enabled
    telemetry: Optional[Dict[str, np.ndarray]] = None
    # host-clock phase times of the call: {"prefill_s", "decode_s"}
    timings: Optional[Dict[str, float]] = None


class FleetServeEngine:
    """Serve the whole fleet in one lane-batched forward per step.

    Device ``i`` of the :class:`FleetRuntime` is lane ``i``: it generates
    its slice of the prompt batch at its own policy-admitted per-operator
    BERs (row ``i`` of ``fleet.op_ber_array()``), with fault and sampling
    streams of its own, exactly as the reference's vmapped dispatch.
    Defaults are the reference's (``use_systolic_kernel=False``,
    ``use_fused_kernel=True``, greedy).
    """

    def __init__(self, cfg: ModelConfig, params, fleet: FleetRuntime, *,
                 max_len: int = 512, use_systolic_kernel: bool = False,
                 use_fused_kernel: bool = True, seed: int = 0, router=None,
                 workload="diurnal", loads=None, apply_load_kw=None,
                 device="cuda"):
        """``router`` (a registered router name or a Router) ages the
        fleet under routed traffic before serving, once, here: the lanes
        then serve BERs of traffic-dependent age.  ``workload`` /
        ``loads`` pick the arrival trace and ``apply_load_kw`` passes
        further knobs (``utilization``, ``n_epochs``, ``horizon_s``,
        ``key``, ``recovery``, ...) to :meth:`FleetRuntime.apply_load`.  A
        shard-granular fleet (``n_shards > 1``) is refused: it is served
        by :class:`repro_torch.serve.sharded.MeshServeEngine`.  ``params``
        must already live on ``device``."""
        refuse_sharded_fleet(fleet, "FleetServeEngine")
        tf.check_supported(cfg)
        self.device = _check_params(cfg, params, device)
        self.cfg = cfg
        self.params = params
        self.fleet = fleet
        self.max_len = max_len
        self.use_kernel = use_systolic_kernel
        self.use_fused = use_fused_kernel
        self._key = prandom.PRNGKey(seed)
        if router is not None:
            fleet.apply_load(loads=loads, workload=workload, router=router,
                             **(apply_load_kw or {}))

    @property
    def n_devices(self) -> int:
        return self.fleet.n_devices

    def _fleet_fault_config(self, call_key: torch.Tensor) -> FaultConfig:
        """The lane config: each lane's BERs from the fleet's (N, O)
        matrix, and a key of its own, ``split(call_key, N)[i]``."""
        ber = self.fleet.op_ber_array()
        bers = {op: tuple(float(b) for b in ber[:, i])
                for i, op in enumerate(self.fleet.operators)}
        return FaultConfig(bers=bers,
                           key=prandom.split(call_key, self.n_devices),
                           step=0, use_systolic_kernel=self.use_kernel,
                           fused=self.use_fused)

    def _shard(self, x, name: str, lane_ndim: int) -> torch.Tensor:
        """A per-lane input (rank ``lane_ndim``, leading N) passes through;
        a flat batch (one rank lower) is split over the lanes.  Dispatch
        is by rank: a flat ``(N, S)`` prompt batch is one prompt per
        lane."""
        N = self.n_devices
        x = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x)
        if x.dim() == lane_ndim:
            if x.shape[0] != N:
                raise ValueError(f"{name} lane dim {x.shape[0]} != fleet "
                                 f"size {N}")
            return x
        if x.dim() != lane_ndim - 1 or x.shape[0] % N:
            raise ValueError(f"{name} must be rank {lane_ndim} (per lane) "
                             f"or a flat rank-{lane_ndim - 1} batch that "
                             f"splits over N = {N} lanes, got "
                             f"{tuple(x.shape)}")
        return x.reshape(N, x.shape[0] // N, *x.shape[1:])

    @torch.no_grad()
    def generate(self, prompts, n_steps: int, *, prefix_embeds=None,
                 frames=None, temperature: float = 0.0,
                 top_k: Optional[int] = None) -> FleetGenerateResult:
        """prompts: ``(N, B, S)`` per lane, or ``(N * B, S)`` sharded over
        the lanes; a VLM's ``prefix_embeds`` and an enc-dec model's
        ``frames`` likewise ``(N, B, ...)`` or ``(N * B, ...)``.  Returns
        each lane's ``n_steps`` tokens and the ``(N, O)`` BER matrix
        served."""
        N = self.n_devices
        self._key, call_key = prandom.split(self._key)
        prompts = self._shard(prompts, "prompts", lane_ndim=3).to(
            torch.int64)
        extras = {k: self._shard(v, k, lane_ndim=4).flatten(0, 1)
                  for k, v in _extras(self.cfg, prefix_embeds, frames,
                                      "cpu").items()}
        extras = {k: v.to(self.device) for k, v in extras.items()}
        fi = self._fleet_fault_config(call_key)
        keys = prandom.split(prandom.fold_in(call_key, 1), N)
        cold = _FLEET_GENERATE(self.cfg, self.max_len, int(n_steps), top_k)
        t0 = time.perf_counter()
        tokens, telemetry, timings = steps.generate(
            self.params, self.cfg,
            prompts.reshape(-1, prompts.shape[-1]).to(self.device), fi, keys,
            max_len=self.max_len, n_steps=int(n_steps),
            temperature=float(temperature), top_k=top_k, lanes=N, **extras)
        span = time.perf_counter() - t0
        if taps_enabled():
            reg = obs_metrics.REGISTRY
            reg.counter("fleet_generate_calls",
                        "fleet generate() dispatches").inc()
            reg.counter("serve_tokens", "tokens generated").inc(tokens.size)
            obs_metrics.observe_span("fleet_generate_compile_s" if cold
                                     else "fleet_generate_warm_s", span)
        else:
            telemetry = None
        return FleetGenerateResult(
            tokens=tokens, bers=self.fleet.op_ber_array(),
            operators=self.fleet.operators,
            ages_years=np.asarray(self.fleet.ages_years),
            power_w=self.fleet.fleet_power(), telemetry=telemetry,
            timings=timings)
