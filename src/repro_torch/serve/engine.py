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
under the same aged device.  ``FleetServeEngine`` is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import random as prandom
from ..configs import ModelConfig
from ..core.fleet import FleetRuntime
from ..device import resolve_device
from ..models import transformer as tf
from ..models.layers import FaultConfig
from ..train.steps import softmax_xent
from . import steps


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray           # (B, steps) generated ids
    bers: Dict[str, float]       # per-operator BER used
    age_years: float
    power_w: float
    # per-step serving-health series {name: (n_steps,)} (logit taps)
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
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
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
    def generate(self, prompts, n_steps: int, *, greedy: bool = True,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None) -> GenerateResult:
        """prompts: (B, S) int.  Returns ``n_steps`` generated tokens.

        ``temperature=0`` (or the legacy ``greedy=True``) is the exact
        argmax; a positive temperature samples ``softmax(logits / T)``
        restricted to the ``top_k`` highest logits when given."""
        fi = self._fault_config()
        self._key, call_key = prandom.split(self._key)
        temperature = self._temperature(greedy, temperature)
        tokens, telemetry, timings = steps.generate(
            self.params, self.cfg, self._tokens(prompts), fi, call_key,
            max_len=self.max_len, n_steps=int(n_steps),
            temperature=temperature, top_k=top_k)
        rt = self.runtime
        bers = rt.op_bers() if rt else {}
        return GenerateResult(
            tokens=tokens, bers={k: float(v) for k, v in bers.items()},
            age_years=rt.age_years if rt else 0.0,
            power_w=rt.total_power() if rt else 0.0,
            telemetry=telemetry, timings=timings)

    @torch.no_grad()
    def score(self, tokens) -> float:
        """Mean next-token NLL of a token batch (B, S) under the aged
        device: one forward over ``tokens[:, :-1]`` against
        ``tokens[:, 1:]``, with a fault config of its own."""
        fi = self._fault_config()
        tokens = self._tokens(tokens)
        logits, _, _ = tf.forward_logits(self.params, self.cfg,
                                         tokens[:, :-1], fi=fi)
        return float(softmax_xent(logits, tokens[:, 1:]))
