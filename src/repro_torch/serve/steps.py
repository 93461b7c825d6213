"""Serve steps: prefill, decode, greedy / temperature / top-k sampling and
the generation loop.

:func:`generate` reproduces the reference's ``make_generate_fn`` key and
fault-stream derivation exactly — ``fi.with_seeds()`` once per call, one
``split`` of the sampling key per token, ``fi.for_step(t)`` for decode step
``t`` — as a Python loop of eager steps (no compiled scan).  With
``lanes=N`` it is the reference's generation under ``jax.vmap`` over N
devices: the lanes fold into the batch axis of one forward per step, and
each lane keeps its own sampling-key chain.  A VLM's prefill takes the
prefix embeddings (``prefix_embeds``) and its cache counts the prefix;
an enc-dec model's prefill encodes the ``frames`` and computes the
cross-attention K/V once, which every decode step reuses.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import random as prandom
from ..configs import ModelConfig
from ..device import true_div
from ..models import encdec
from ..models import transformer as tf
from ..models.layers import FaultConfig
from ..obs.taps import logit_taps


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            fi: Optional[FaultConfig], max_len: int, *, prefix_embeds=None,
            frames=None):
    """-> (logits of the last position (B, vocab), cache at ``max_len``),
    and for an enc-dec model also the cross-attention K/V
    (:func:`repro_torch.models.encdec.cross_kv`) the decode steps reuse.
    The cache is in the params' dtype (the enc-dec cache is written slot
    by slot)."""
    B, S = tokens.shape
    dtype = params["embed"].dtype
    if cfg.n_encoder_layers:
        if frames is None:
            raise ValueError(f"{cfg.name} needs frames (B, "
                             f"{cfg.encoder_seq}, {cfg.d_model})")
        enc = encdec.encode(params, cfg, frames, fi=fi)
        kv = encdec.cross_kv(params, cfg, enc, fi=fi)
        cache = encdec.init_cache(cfg, B, max_len, dtype=dtype,
                                  device=tokens.device)
        logits, cache = encdec.decode(params, cfg, tokens, kv=kv, fi=fi,
                                      cache=cache, cache_len=S)
        return logits[:, -1], cache, kv
    cache = tf.init_cache(cfg, B, max_len, dtype=dtype, device=tokens.device)
    logits, cache, _ = tf.forward_logits(params, cfg, tokens, states=cache,
                                         cache_len=S + cfg.prefix_tokens,
                                         fi=fi, prefix_embeds=prefix_embeds)
    return logits[:, -1], cache


def decode(params, cfg: ModelConfig, token: torch.Tensor, cache,
           cache_len: int, fi: Optional[FaultConfig], kv=None):
    """token (B, 1) -> (logits (B, vocab), cache); ``kv`` is an enc-dec
    model's cross-attention K/V from :func:`prefill`."""
    if cfg.n_encoder_layers:
        logits, cache = encdec.decode(params, cfg, token, kv=kv, fi=fi,
                                      cache=cache, cache_len=cache_len,
                                      pos_offset=cache_len - 1)
    else:
        logits, cache = tf.decode_step(params, cfg, token, cache, cache_len,
                                       fi=fi)
    return logits[:, -1], cache


def sample_token(logits: torch.Tensor, key: torch.Tensor,
                 temperature: float = 0.0, top_k: Optional[int] = None, *,
                 lanes: Optional[int] = None) -> torch.Tensor:
    """Greedy / temperature / top-k sampling, as the reference's
    ``sample_token``.

    ``temperature == 0`` is the exact argmax (first index on ties), and
    ``key`` goes unused.  A positive temperature masks all but the
    ``top_k`` highest logits (when given) to ``-inf`` and draws
    ``categorical(key, logits / max(T, 1e-6))`` — the Gumbel-max trick
    over ``key``'s threefry uniforms, on the logits' device.  With
    ``lanes=N`` the rows fold N lanes lane-major, ``key`` is ``(N, 2)``,
    and each lane's rows draw from its own key.
    """
    temperature = np.float32(temperature)        # jax's float32 scalar
    if not temperature > 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    t = max(temperature, np.float32(1e-6))
    scaled = true_div(logits, float(t))
    if lanes is None:
        return prandom.categorical(key, scaled).to(torch.int32)
    return torch.cat([prandom.categorical(k, rows) for k, rows in
                      zip(key, scaled.chunk(lanes))]).to(torch.int32)


def _split_keys(key: torch.Tensor, lanes: Optional[int]):
    """``split`` of one key, or of each lane's: -> (next keys, subkeys)."""
    if lanes is None:
        return tuple(prandom.split(key))
    pairs = [prandom.split(k) for k in key]
    return (torch.stack([p[0] for p in pairs]),
            torch.stack([p[1] for p in pairs]))


def generate(params, cfg: ModelConfig, prompts: torch.Tensor,
             fi: Optional[FaultConfig], key: torch.Tensor, *,
             max_len: int, n_steps: int, temperature: float = 0.0,
             top_k: Optional[int] = None, lanes: Optional[int] = None,
             prefix_embeds: Optional[torch.Tensor] = None,
             frames: Optional[torch.Tensor] = None
             ) -> Tuple[np.ndarray, Dict, Dict]:
    """Prefill + ``n_steps - 1`` decode steps + sampling.

    Returns ``(tokens (B, n_steps), telemetry {name: (n_steps,)}, timings
    {"prefill_s", "decode_s"})``; the timings are host clock, each phase
    ended by a device synchronisation.  With ``lanes=N``, ``prompts`` is
    ``(N * B, S)`` lane-major, ``fi`` a lane config, ``key`` the lanes'
    ``(N, 2)`` sampling keys, and the result ``(tokens (N, B, n_steps),
    telemetry {name: (N, n_steps)}, timings)``.  ``prefix_embeds`` (VLM)
    and ``frames`` (enc-dec) are the extras of the prompts' rows, folded
    the same way.
    """
    S = prompts.shape[1]
    if fi is not None:
        fi = fi.with_seeds()
    sync = (torch.cuda.synchronize if prompts.device.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    out = prefill(params, cfg, prompts, fi, max_len,
                  prefix_embeds=prefix_embeds, frames=frames)
    logits, cache = out[0], out[1]
    kv = out[2] if cfg.n_encoder_layers else None
    cache_len0 = S + cfg.prefix_tokens
    key, sub = _split_keys(key, lanes)
    tok = sample_token(logits, sub, temperature, top_k, lanes=lanes)
    toks, taps = [tok], [logit_taps(logits, lanes)]
    sync()
    t1 = time.perf_counter()
    for t in range(1, n_steps):
        fi_t = None if fi is None else fi.for_step(t)
        logits, cache = decode(params, cfg, tok[:, None], cache,
                               cache_len0 + t, fi_t, kv)
        key, sub = _split_keys(key, lanes)
        tok = sample_token(logits, sub, temperature, top_k, lanes=lanes)
        toks.append(tok)
        taps.append(logit_taps(logits, lanes))
    tokens = torch.stack(toks, dim=-1).cpu().numpy()
    t2 = time.perf_counter()
    series = {k: torch.stack([tp[k] for tp in taps], dim=-1).cpu().numpy()
              for k in taps[0]}
    if lanes is not None:
        tokens = tokens.reshape(lanes, -1, n_steps)
    return tokens, series, {"prefill_s": t1 - t0, "decode_s": t2 - t1}
