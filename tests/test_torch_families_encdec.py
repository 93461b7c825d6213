"""The enc-dec family (whisper_large_v3) of the port vs the JAX reference
on the CPU, at ``reduced()``, with Pallas in interpret mode and the
reference op by op (``jax.disable_jit``; tests/test_torch_families_common.py
sets up both and says why): the forward on the clean, fused and
three-pass routes, prefill + decode with the cross-attention K/V computed once,
``steps.generate`` and the engine's tokens and score, the encoder and the
cross K/V (salt 0), the sinusoidal positions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_families_common import (FAULTED_RTOL, LOGIT_ATOL, ROUTES,
                                        SCORE_RTOL, Forced, _build, _extra,
                                        _fault_configs, _kw, _logits, _ref,
                                        make_model)
from repro.configs import get_config as jax_get_config
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro.serve import steps as jax_steps
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import random as prandom
from repro_torch.configs import get_config
from repro_torch.models import encdec, layers
from repro_torch.serve import steps
from repro_torch.serve.engine import ServeEngine


@pytest.fixture(scope="module", params=["whisper_large_v3"])
def model(request):
    return make_model(request.param)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("route", list(ROUTES))
def test_forward_logits_match_reference(model, route):
    arch, cfg_j, cfg, params_j, params, prompts, extra = model
    fused = ROUTES[route]
    jfi, pfi = (None, None) if fused is None else _fault_configs(fused)
    want, got = _logits(arch, cfg_j, cfg, params_j, params, prompts, extra,
                        jfi, pfi)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_prefill_and_decode_match_reference(model):
    """Prefill logits, then two decode steps fed the same tokens (the
    cross K/V from the prefill reused), on the fused route: logits within
    1e-4 at every step."""
    arch, cfg_j, cfg, params_j, params, prompts, extra = model
    jfi, pfi = _fault_configs(True)
    ex_j = () if extra is None else (jnp.asarray(extra),)
    with _ref(arch):
        out = jax_steps.make_prefill_fn(cfg_j, 32)(
            params_j, jnp.asarray(prompts), jfi, *ex_j)
    out_p = steps.prefill(params, cfg, torch.as_tensor(prompts), pfi, 32,
                          **_kw(cfg, extra, torch.from_numpy))
    np.testing.assert_allclose(out_p[0].numpy(), np.asarray(out[0]), rtol=0,
                               atol=LOGIT_ATOL)
    cache_j, cache = out[1], out_p[1]
    kv_j = out[2] if cfg.n_encoder_layers else None
    kv = out_p[2] if cfg.n_encoder_layers else None
    decode_j = jax_steps.make_decode_fn(cfg_j)
    tok = np.argmax(np.asarray(out[0]), axis=-1)[:, None]
    length = prompts.shape[1] + cfg.prefix_tokens
    for t in range(1, 3):
        args = (params_j, jnp.asarray(tok), cache_j,
                jnp.int32(length + t), jfi.for_step(jnp.int32(t)))
        with _ref(arch):
            want, cache_j = decode_j(*args, *(() if kv_j is None
                                              else (kv_j,)))
        got, cache = steps.decode(params, cfg, torch.as_tensor(tok), cache,
                                  length + t, pfi.for_step(t), kv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL)
        tok = np.argmax(np.asarray(want), axis=-1)[:, None]


def test_steps_generate_tokens_match_reference(model):
    """``steps.generate`` (greedy, fused route) against the reference's
    whole-generation function: the same tokens."""
    arch, cfg_j, cfg, params_j, params, prompts, extra = model
    jfi, pfi = _fault_configs(True)
    jfi = dataclasses.replace(jfi, seeds=None)
    pfi = dataclasses.replace(pfi, seeds=None)
    ex_j = () if extra is None else (jnp.asarray(extra),)
    with _ref(arch):
        want, _ = jax_steps.make_generate_fn(cfg_j, 32, 3)(
            params_j, jnp.asarray(prompts), jfi, jax.random.PRNGKey(4),
            jnp.float32(0.0), *ex_j)
    got, _, _ = steps.generate(params, cfg, torch.as_tensor(prompts), pfi,
                               prandom.PRNGKey(4), max_len=32, n_steps=3,
                               **_kw(cfg, extra, torch.from_numpy))
    np.testing.assert_array_equal(got, np.asarray(want))


# the three-pass route is held by test_forward_logits_match_reference; the
# op-by-op reference engine costs ~1 min a route
@pytest.mark.parametrize("fused", [True], ids=["fused"])
def test_engine_generate_and_score_match_reference(model, fused):
    """``ServeEngine.generate`` tokens (equal) and ``score`` of prompts +
    generated tokens (within 1e-5 relative) at BER 1e-3 on every domain."""
    arch, cfg_j, cfg, params_j, params, prompts, extra = model
    kw = dict(runtime=Forced(1e-3), max_len=32, use_systolic_kernel=True,
              use_fused_kernel=fused, seed=3)
    jeng = JaxServeEngine(cfg_j, params_j, **kw)
    peng = ServeEngine(cfg, params, device="cpu", **kw)
    with _ref(arch):
        want = jeng.generate(prompts, 3, **_kw(cfg, extra, np.asarray))
    got = peng.generate(prompts, 3, **_kw(cfg, extra, np.asarray))
    np.testing.assert_array_equal(got.tokens, want.tokens)
    tokens = np.concatenate([prompts, want.tokens], axis=1)
    with _ref(arch):
        want_s = jeng.score(tokens, **_kw(cfg, extra, jnp.asarray))
    got_s = peng.score(tokens, **_kw(cfg, extra, np.asarray))
    assert np.isfinite(got_s) and got_s > 0
    assert got_s == pytest.approx(want_s, rel=SCORE_RTOL)


@pytest.mark.parametrize("fused", [None, True], ids=["clean", "fused"])
def test_encode_and_cross_kv_match_reference(fused):
    """The encoder output and every layer's cross K/V (salt 0, as the
    reference's) of reduced whisper_large_v3."""
    cfg_j = jax_get_config("whisper_large_v3").reduced()
    cfg = get_config("whisper_large_v3").reduced()
    params_j, params = _build(cfg_j, cfg, seed=5)
    frames = _extra(cfg, 2, np.random.default_rng(6))
    jfi, pfi = (None, None) if fused is None else _fault_configs(True)
    with jax.disable_jit():
        enc_j = jax_encdec.encode(params_j, cfg_j, jnp.asarray(frames),
                                  fi=jfi)
        kv_j = jax_encdec.cross_kv(params_j, cfg_j, enc_j, fi=jfi)
    enc = encdec.encode(params, cfg, torch.from_numpy(frames), fi=pfi)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), rtol=0,
                               atol=LOGIT_ATOL)
    kv = encdec.cross_kv(params, cfg, torch.from_numpy(np.asarray(enc_j)),
                         fi=pfi)
    assert len(kv) == cfg.n_layers
    for i, lkv in enumerate(kv):
        for n in ("k", "v"):
            want = np.asarray(kv_j[n][i])
            np.testing.assert_allclose(lkv[n].numpy(), want,
                                       rtol=FAULTED_RTOL, atol=LOGIT_ATOL)


@pytest.mark.parametrize("S,d", [(16, 64), (1500, 1280)])
def test_sinusoid_positions_match_reference(S, d):
    """The sine half bit for bit (``fmath.pow`` and ``fmath.sin``); the
    cosine half (``torch.cos``) within one float32 ulp of 1 (6e-8)."""
    want = np.asarray(jax_layers.sinusoid_positions(S, d))
    got = layers.sinusoid_positions(S, d, "cpu").numpy()
    np.testing.assert_array_equal(got[:, :d // 2], want[:, :d // 2])
    np.testing.assert_allclose(got[:, d // 2:], want[:, d // 2:], rtol=0,
                               atol=2.0 ** -24)


