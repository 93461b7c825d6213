"""Decoder-only LM (dense and MoE families): init, forward, KV cache and
decode step.

The port's param tree is a plain dict with one entry per layer
(``params["layers"][i]``) instead of the reference's stacked ``groups``
scanned by ``lax.scan``; the layers run in a Python loop with
``salt = layer index``, the reference's ``gidx * len(pattern) + i``.
Weight layouts follow the reference (``wq (d, H, hd)``, ``wo (H, hd, d)``,
experts ``(E, d, f)``); :mod:`repro_torch.convert` carries a reference
tree across.  The KV cache is updated in place during decode (the
reference returns a new buffer).  Under a lane config (N devices'
:class:`FaultConfig`) the batch axis folds the lanes lane-major: a
``(N * B, S)`` forward is N devices' ``(B, S)`` forwards, each at its own
BERs, in one pass over the weights (the MoE dispatch keeps each lane's
capacity and queue positions its own, :mod:`repro_torch.models.moe`).
Sliding windows, prefix embeddings, encoder layers, other block patterns
and the hybrid, SSM, enc-dec and VLM families are not ported yet:
:func:`check_supported` refuses them.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs import ModelConfig
from ..device import resolve_device
from . import attention as attn_lib
from .layers import (FaultConfig, _normal, apply_rope, init_norm, mlp_apply,
                     mlp_init, norm, op_einsum, rms_norm)
from .moe import moe_apply, moe_init

UNPORTED_FAMILIES = ("hybrid", "ssm", "encdec", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a config the port would serve differently from the reference:
    an unported family, or a field that changes the computation in any
    family (a sliding ``window`` in attention and the cache, prefix
    embeddings, encoder layers, a block pattern other than attention)."""
    if cfg.family in UNPORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is "
                                  "not ported yet")
    unported = {"window": cfg.window is not None,
                "prefix_tokens": cfg.prefix_tokens > 0,
                "n_encoder_layers": cfg.n_encoder_layers > 0,
                "block_pattern": tuple(cfg.block_pattern) != ("attn",)}
    for field, is_set in unported.items():
        if is_set:
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not ported "
                "yet (the port would serve it as if unset)")


def _attn_init(cfg: ModelConfig, dtype, device, gen) -> Dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = d ** -0.5
    p = {"wq": _normal((d, H, hd), s, dtype, device, gen),
         "wk": _normal((d, KV, hd), s, dtype, device, gen),
         "wv": _normal((d, KV, hd), s, dtype, device, gen),
         "wo": _normal((H, hd, d), (H * hd) ** -0.5, dtype, device, gen)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> Dict:
    """Random params from a seeded ``torch.Generator`` on ``device``, with
    the reference's scales (``N(0,1) * d**-0.5`` projections, ``0.02``
    embeddings) and tree (no ``lm_head`` under tied embeddings, a float32
    MoE router)."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff
    params: Dict = {
        "embed": _normal((cfg.vocab, d), 0.02, dtype, device, gen),
        "final_norm": init_norm(cfg.norm, d, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal((d, cfg.vocab), d ** -0.5, dtype, device,
                                    gen)
    params["layers"] = []
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "norm1": init_norm(cfg.norm, d, dtype, device),
            "norm2": init_norm(cfg.norm, d, dtype, device),
            "attn": _attn_init(cfg, dtype, device, gen),
            "ffn": (moe_init(d, f, cfg.moe, cfg.mlp, dtype, device, gen)
                    if cfg.moe else
                    mlp_init(d, f, cfg.mlp, dtype, device, gen))})
    return params


# --------------------------------------------------------------------------- #
def _attn_block(x, bp, cfg: ModelConfig, *, positions, cache=None,
                cache_len: Optional[int] = None, fi=None, salt=0,
                with_aux: bool = False):
    """Self-attention + FFN block.  With ``cache`` and one token: decode.
    Returns ``(x, new_cache, aux)``; ``aux`` is the MoE load-balance loss
    when ``with_aux`` is set and the FFN is MoE, else ``None``."""
    h = norm(x, bp["norm1"], cfg.norm)
    ap = bp["attn"]
    q = op_einsum("bsd,dhk->bshk", h, ap["wq"], "q", fi, salt)
    k = op_einsum("bsd,dhk->bshk", h, ap["wk"], "k", fi, salt)
    v = op_einsum("bsd,dhk->bshk", h, ap["wv"], "v", fi, salt)
    if cfg.qk_norm:
        q, k = rms_norm(q, ap["q_norm"]), rms_norm(k, ap["k_norm"])
    if cfg.pos == "rope":
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
    h2 = norm(x, bp["norm2"], cfg.norm)
    if cfg.moe:
        y, aux = moe_apply(h2, bp["ffn"], cfg.moe, cfg.mlp, fi, salt,
                           with_aux=with_aux)
    else:
        y, aux = mlp_apply(h2, bp["ffn"], cfg.mlp, fi, salt), None
    return x + y, new_cache, aux


def _run_blocks(x, params, cfg: ModelConfig, *, positions, states=None,
                cache_len=None, fi=None, with_aux: bool = False,
                remat: bool = False):
    """-> ``(x, new_states, aux)``: ``aux`` is the float32 load-balance loss
    summed over layers when ``with_aux`` is set (``(N,)`` under a lane
    config of N lanes, each lane's own), else ``None``.  It is
    built on the device (no host copy), so the step stays free of
    host-device synchronisation.

    ``remat=True`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``, non-reentrant): only a block's input is
    kept, as the reference's per-layer-group ``jax.checkpoint``.  The
    recomputation repeats the same operations, so values and gradients
    equal those without remat bit for bit."""
    check_supported(cfg)
    new_states: Optional[List] = [] if states is not None else None
    aux_total = (torch.zeros((), dtype=torch.float32, device=x.device)
                 if with_aux else None)
    block = _attn_block
    if remat and torch.is_grad_enabled():
        block = functools.partial(checkpoint, _attn_block,
                                  use_reentrant=False)
    for i, bp in enumerate(params["layers"]):
        x, ns, aux = block(x, bp, cfg, positions=positions,
                           cache=None if states is None else states[i],
                           cache_len=cache_len, fi=fi, salt=i,
                           with_aux=with_aux)
        if aux is not None:
            aux_total = aux_total + aux
        if new_states is not None:
            new_states.append(ns)
    return x, new_states, aux_total


def embed_tokens(params, cfg: ModelConfig, tokens):
    # a gather; its backward sums rows by sorted index, not by atomics
    x = torch.nn.functional.embedding(tokens, params["embed"])
    if cfg.scale_embeds:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


def unembed(params, cfg: ModelConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w).to(torch.float32)


def forward_logits(params, cfg: ModelConfig, tokens, *,
                   fi: Optional[FaultConfig] = None, states=None,
                   cache_len=None, remat: bool = False):
    """Full-sequence forward (prefill).  tokens: (B, S) int.  Returns
    ``(logits (B, S, vocab) float32, new_states, aux)``, ``aux`` the MoE
    load-balance loss summed over layers (float32, 0 for dense models;
    ``(N,)``, one per lane, under a lane config).  ``remat`` recomputes
    each block in the backward pass (see :func:`_run_blocks`)."""
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, new_states, aux = _run_blocks(x, params, cfg, positions=positions,
                                     states=states, cache_len=cache_len,
                                     fi=fi, with_aux=True, remat=remat)
    x = norm(x, params["final_norm"], cfg.norm)
    return unembed(params, cfg, x), new_states, aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> List[Dict]:
    """Per-layer ``{"k", "v"}`` buffers of shape (B, max_len, KV, hd)."""
    shp = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shp, dtype=dtype, device=device),
             "v": torch.zeros(shp, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def decode_step(params, cfg: ModelConfig, token, cache, cache_len: int, *,
                fi: Optional[FaultConfig] = None):
    """One decode step.  token: (B, 1); ``cache_len`` includes this token.
    The MoE load-balance loss is not computed: decode has no use for it."""
    x = embed_tokens(params, cfg, token)
    positions = torch.full((1, 1), cache_len - 1, dtype=torch.int64,
                           device=x.device)
    x, new_cache, _ = _run_blocks(x, params, cfg, positions=positions,
                                  states=cache, cache_len=cache_len, fi=fi)
    x = norm(x, params["final_norm"], cfg.norm)
    return unembed(params, cfg, x), new_cache
