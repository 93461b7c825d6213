"""Shared set-up of the family parity tests (``test_torch_families*.py``):
reduced configs from the reference's ``init_params`` (float32) carried
across by repro_torch.convert, fault configs at one BER on every domain,
each family's extra input, and the teacher-forced logits of both packages.

The enc-dec reference runs op by op (``jax.disable_jit``, see
:data:`EAGER`): its compiled encoder turns some upset-blown score rows
into NaN at BER 1e-3 (XLA CPU's fused softmax) where its op-by-op
evaluation, like the port, stays finite.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import encdec as jax_encdec
from repro.models import transformer as jax_tf
from repro.models.layers import FaultConfig as JaxFaultConfig
from repro_torch import random as prandom
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models import family
from repro_torch.models.layers import FaultConfig

# the reference runs op by op for these (module docstring)
EAGER = ("whisper_large_v3",)
OPS = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down", "r", "g")
ROUTES = {"clean": None, "fused": True, "three_pass": False}
LOGIT_ATOL = 1e-4    # float32 reductions in another order than XLA's
SCORE_RTOL = 1e-5
# faulted outputs blown up to ~1e5-1e9 by upsets: float32 rounding alone
# exceeds an absolute bound there
FAULTED_RTOL = 1e-6


class Forced:
    """A runtime admitting one BER on every operator domain."""
    age_years = 9.0

    def __init__(self, ber):
        self.ber = ber

    def op_bers(self):
        return {op: self.ber for op in OPS}

    def total_power(self):
        return 0.0


def _ref(arch):
    return jax.disable_jit() if arch in EAGER else contextlib.nullcontext()


def _fault_configs(fused, ber=1e-3, key=11):
    jfi = JaxFaultConfig(bers={op: jnp.float32(ber) for op in OPS},
                         key=jax.random.PRNGKey(key), step=jnp.int32(0),
                         use_systolic_kernel=True, fused=fused).with_seeds()
    pfi = FaultConfig(bers={op: ber for op in OPS}, key=prandom.PRNGKey(key),
                      use_systolic_kernel=True, fused=fused).with_seeds()
    return jfi, pfi


def _build(cfg_j, cfg, seed=0):
    init = jax_encdec.init_params if cfg_j.n_encoder_layers \
        else jax_tf.init_params
    params_j = init(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return params_j, params_from_reference(jax.tree.map(np.asarray,
                                                        params_j), cfg,
                                           device="cpu")


def _extra(cfg, B, rng):
    """The family's extra input (numpy float32) or None."""
    if cfg.n_encoder_layers:
        return rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.prefix_tokens:
        return rng.normal(size=(B, cfg.prefix_tokens, cfg.d_model)).astype(
            np.float32)
    return None


def _kw(cfg, extra, to):
    if extra is None:
        return {}
    return {("frames" if cfg.n_encoder_layers else "prefix_embeds"):
            to(extra)}


def make_model(arch):
    """``(arch, cfg_j, cfg, params_j, params, prompts (2, 12), extra)`` of
    the reduced config from the reference's ``init_params``."""
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    params_j, params = _build(cfg_j, cfg)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab, (2, 12))
    return arch, cfg_j, cfg, params_j, params, prompts, _extra(cfg, 2, rng)


def _logits(arch, cfg_j, cfg, params_j, params, tokens, extra, jfi, pfi):
    """Teacher-forced text logits of both packages."""
    with _ref(arch):
        if cfg.n_encoder_layers:
            enc = jax_encdec.encode(params_j, cfg_j, jnp.asarray(extra),
                                    fi=jfi)
            want, _ = jax_encdec.decode(params_j, cfg_j, jnp.asarray(tokens),
                                        enc_out=enc, fi=jfi)
        else:
            want, _, _ = jax_tf.forward_logits(
                params_j, cfg_j, jnp.asarray(tokens), fi=jfi,
                **_kw(cfg, extra, jnp.asarray))
    got, _ = family.text_logits(params, cfg, torch.as_tensor(tokens),
                                fi=pfi, **_kw(cfg, extra, torch.from_numpy))
    if not cfg.n_encoder_layers:
        want = want[:, cfg.prefix_tokens:]
    return np.asarray(want), got.numpy()
