"""Dense decoder-only LM: init, forward, KV cache and decode step.

The port's param tree is a plain dict with one entry per layer
(``params["layers"][i]``) instead of the reference's stacked ``groups``
scanned by ``lax.scan``; the layers run in a Python loop with
``salt = layer index``, the reference's ``gidx * len(pattern) + i``.
Weight layouts follow the reference (``wq (d, H, hd)``, ``wo (H, hd, d)``);
:mod:`repro_torch.convert` carries a reference tree across.  The KV cache
is updated in place during decode (the reference returns a new buffer).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..configs import ModelConfig
from ..device import resolve_device
from . import attention as attn_lib
from .layers import (FaultConfig, _normal, apply_rope, init_norm, mlp_apply,
                     mlp_init, op_einsum, rms_norm)


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.family, cfg.mlp, cfg.norm, cfg.pos) != ("dense", "gated", "rms",
                                                    "rope"):
        raise NotImplementedError(f"{cfg.name}: only dense RMSNorm/RoPE/"
                                  "SwiGLU decoders are ported")


def _attn_init(cfg: ModelConfig, dtype, device, gen) -> Dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = d ** -0.5
    return {"wq": _normal((d, H, hd), s, dtype, device, gen),
            "wk": _normal((d, KV, hd), s, dtype, device, gen),
            "wv": _normal((d, KV, hd), s, dtype, device, gen),
            "wo": _normal((H, hd, d), (H * hd) ** -0.5, dtype, device, gen)}


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> Dict:
    """Random params from a seeded ``torch.Generator`` on ``device``, with
    the reference's scales (``N(0,1) * d**-0.5`` projections, ``0.02``
    embeddings)."""
    _check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model
    params: Dict = {
        "embed": _normal((cfg.vocab, d), 0.02, dtype, device, gen),
        "final_norm": init_norm(d, dtype, device),
        "lm_head": _normal((d, cfg.vocab), d ** -0.5, dtype, device, gen),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "norm1": init_norm(d, dtype, device),
            "norm2": init_norm(d, dtype, device),
            "attn": _attn_init(cfg, dtype, device, gen),
            "ffn": mlp_init(d, cfg.d_ff, dtype, device, gen)})
    return params


# --------------------------------------------------------------------------- #
def _attn_block(x, bp, cfg: ModelConfig, *, positions, cache=None,
                cache_len: Optional[int] = None, fi=None, salt=0):
    """Self-attention + FFN block.  With ``cache`` and one token: decode."""
    h = rms_norm(x, bp["norm1"]["scale"])
    ap = bp["attn"]
    q = op_einsum("bsd,dhk->bshk", h, ap["wq"], "q", fi, salt)
    k = op_einsum("bsd,dhk->bshk", h, ap["wk"], "k", fi, salt)
    v = op_einsum("bsd,dhk->bshk", h, ap["wv"], "v", fi, salt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        kv_len = cache["k"].shape[1]
        if q.shape[1] == 1:      # decode: ring-write at slot (len-1) % kv_len
            idx = (cache_len - 1) % kv_len
            cache["k"][:, idx] = k[:, 0]
            cache["v"][:, idx] = v[:, 0]
            out = attn_lib.decode_attention(q, cache["k"], cache["v"],
                                            cache_len, fi=fi, salt=salt)
            new_cache = cache
        else:                    # prefill: full attention, stash K/V
            out = attn_lib.full_attention(q, k, v, fi=fi, salt=salt)
            S = k.shape[1]
            if S >= kv_len:      # keep the last kv_len tokens at t % kv_len
                kc = torch.roll(k[:, -kv_len:], S % kv_len, dims=1)
                vc = torch.roll(v[:, -kv_len:], S % kv_len, dims=1)
            else:
                pad = (0, 0, 0, 0, 0, kv_len - S)
                kc = torch.nn.functional.pad(k, pad)
                vc = torch.nn.functional.pad(v, pad)
            new_cache = {"k": kc.contiguous(), "v": vc.contiguous()}
    else:
        out = attn_lib.full_attention(q, k, v, fi=fi, salt=salt)
    x = x + op_einsum("bshk,hkd->bsd", out, ap["wo"], "o", fi, salt)
    h2 = rms_norm(x, bp["norm2"]["scale"])
    return x + mlp_apply(h2, bp["ffn"], fi, salt), new_cache


def _run_blocks(x, params, cfg: ModelConfig, *, positions, states=None,
                cache_len=None, fi=None):
    new_states: Optional[List] = [] if states is not None else None
    for i, bp in enumerate(params["layers"]):
        x, ns = _attn_block(x, bp, cfg, positions=positions,
                            cache=None if states is None else states[i],
                            cache_len=cache_len, fi=fi, salt=i)
        if new_states is not None:
            new_states.append(ns)
    return x, new_states


def embed_tokens(params, tokens):
    return params["embed"][tokens]


def unembed(params, x):
    return (x @ params["lm_head"]).to(torch.float32)


def forward_logits(params, cfg: ModelConfig, tokens, *,
                   fi: Optional[FaultConfig] = None, states=None,
                   cache_len=None):
    """Full-sequence forward (prefill).  tokens: (B, S) int.  Returns
    ``(logits (B, S, vocab) float32, new_states)``."""
    _check_supported(cfg)
    x = embed_tokens(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, new_states = _run_blocks(x, params, cfg, positions=positions,
                                states=states, cache_len=cache_len, fi=fi)
    x = rms_norm(x, params["final_norm"]["scale"])
    return unembed(params, x), new_states


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> List[Dict]:
    """Per-layer ``{"k", "v"}`` buffers of shape (B, max_len, KV, hd)."""
    shp = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shp, dtype=dtype, device=device),
             "v": torch.zeros(shp, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def decode_step(params, cfg: ModelConfig, token, cache, cache_len: int, *,
                fi: Optional[FaultConfig] = None):
    """One decode step.  token: (B, 1); ``cache_len`` includes this token."""
    x = embed_tokens(params, token)
    positions = torch.full((1, 1), cache_len - 1, dtype=torch.int64,
                           device=x.device)
    x, new_cache = _run_blocks(x, params, cfg, positions=positions,
                               states=cache, cache_len=cache_len, fi=fi)
    x = rms_norm(x, params["final_norm"]["scale"])
    return unembed(params, x), new_cache
