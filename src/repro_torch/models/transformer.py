"""Decoder-only LM (dense, MoE, hybrid, SSM and VLM families): init,
forward, decode state and decode step.

The port's param tree is a plain dict with one entry per layer
(``params["layers"][i]``) instead of the reference's stacked ``groups``
(one period of ``cfg.block_pattern`` each, scanned by ``lax.scan``) and
unstacked ``tail``; layer ``i`` is of kind ``block_pattern[i % period]``
and runs in a Python loop with ``salt = i``, which is the reference's
``gidx * period + j`` in a group and ``n_groups * period + t`` in the
tail.  Block kinds: ``attn`` (self-attention with a sliding ``window``
and a prefix-bidirectional mask where the config sets them, + MLP or
MoE), ``rec`` (RG-LRU, :mod:`repro_torch.models.rglru`, + MLP), ``rwkv``
(RWKV6 time and channel mix, :mod:`repro_torch.models.rwkv6`).  A VLM's
``prefix_tokens`` patch embeddings enter through the clean
``prefix_proj``.  Weight layouts follow the reference (``wq (d, H,
hd)``, ``wo (H, hd, d)``, experts ``(E, d, f)``);
:mod:`repro_torch.convert` carries a reference tree across.  A windowed
KV cache is a ring of ``window`` slots.  The attention cache is updated
in place during decode (the reference returns a new buffer); recurrent
states come back new.  Under a lane config (N devices'
:class:`FaultConfig`) the batch axis folds the lanes lane-major: a
``(N * B, S)`` forward is N devices' ``(B, S)`` forwards, each at its own
BERs, in one pass over the weights (the MoE dispatch keeps each lane's
capacity and queue positions its own, :mod:`repro_torch.models.moe`).
The enc-dec family is :mod:`repro_torch.models.encdec`.
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
                     mlp_init, norm, op_einsum, op_linear, rms_norm)
from .moe import moe_apply, moe_init
from .rglru import rglru_block, rglru_init, rglru_init_state
from .rwkv6 import (rwkv_channel_mix, rwkv_channel_mix_init,
                    rwkv_init_state, rwkv_time_mix, rwkv_time_mix_init)

BLOCK_KINDS = ("attn", "rec", "rwkv")


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a block kind the port does not know (every shipped config's
    kinds are known)."""
    unknown = [k for k in cfg.block_pattern if k not in BLOCK_KINDS]
    if unknown:
        raise NotImplementedError(f"{cfg.name}: block kind(s) {unknown} are "
                                  f"not implemented (known: {BLOCK_KINDS})")


def _decoder_only(cfg: ModelConfig) -> None:
    check_supported(cfg)
    if cfg.n_encoder_layers:
        raise ValueError(f"{cfg.name} is an enc-dec model: use "
                         "repro_torch.models.encdec")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


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


def _block_init(kind: str, cfg: ModelConfig, dtype, device, gen) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"norm1": init_norm(cfg.norm, d, dtype, device),
         "norm2": init_norm(cfg.norm, d, dtype, device)}
    if kind == "attn":
        p["attn"] = _attn_init(cfg, dtype, device, gen)
        p["ffn"] = (moe_init(d, f, cfg.moe, cfg.mlp, dtype, device, gen)
                    if cfg.moe else
                    mlp_init(d, f, cfg.mlp, dtype, device, gen))
    elif kind == "rec":
        p["rglru"] = rglru_init(d, dtype, device, gen)
        p["ffn"] = mlp_init(d, f, cfg.mlp, dtype, device, gen)
    else:
        p["tm"] = rwkv_time_mix_init(d, cfg.rwkv_head_dim, dtype, device, gen)
        p["cm"] = rwkv_channel_mix_init(d, f, dtype, device, gen)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> Dict:
    """Random params from a seeded ``torch.Generator`` on ``device``, with
    the reference's scales (``N(0,1) * d**-0.5`` projections, ``0.02``
    embeddings) and tree (no ``lm_head`` under tied embeddings, a
    ``prefix_proj`` for prefix embeddings; float32 MoE router, RG-LRU
    ``lam``, RWKV ``decay_base`` and ``bonus_u``)."""
    _decoder_only(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model
    params: Dict = {
        "embed": _normal((cfg.vocab, d), 0.02, dtype, device, gen),
        "final_norm": init_norm(cfg.norm, d, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal((d, cfg.vocab), d ** -0.5, dtype, device,
                                    gen)
    if cfg.prefix_tokens:
        params["prefix_proj"] = _normal((d, d), d ** -0.5, dtype, device, gen)
    params["layers"] = [_block_init(kind, cfg, dtype, device, gen)
                        for kind in layer_kinds(cfg)]
    return params


# --------------------------------------------------------------------------- #
def _attn_block(x, bp, cfg: ModelConfig, *, positions, prefix_len: int = 0,
                cache=None, cache_len: Optional[int] = None, fi=None, salt=0,
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
    if cache is not None and q.shape[1] == 1:
        # decode: ring-write token cache_len - 1 at its slot, attend
        kv_len = cache["k"].shape[1]
        idx = (cache_len - 1) % kv_len
        cache["k"][:, idx] = k[:, 0]
        cache["v"][:, idx] = v[:, 0]
        out = attn_lib.decode_attention(q, cache["k"], cache["v"],
                                        cache_len, fi=fi, salt=salt)
        new_cache = cache
    else:
        out = attn_lib.full_attention(q, k, v, causal=True,
                                      window=cfg.window,
                                      prefix_len=prefix_len, fi=fi, salt=salt)
        if cache is not None:    # prefill: stash K/V
            kv_len, S = cache["k"].shape[1], k.shape[1]
            if S >= kv_len:      # keep the last kv_len tokens at t % kv_len
                kc = torch.roll(k[:, -kv_len:], S % kv_len, dims=1)
                vc = torch.roll(v[:, -kv_len:], S % kv_len, dims=1)
            else:
                pad = (0, 0, 0, 0, 0, kv_len - S)
                kc = torch.nn.functional.pad(k, pad)
                vc = torch.nn.functional.pad(v, pad)
            new_cache = {"k": kc.contiguous(), "v": vc.contiguous()}
    x = x + op_einsum("bshk,hkd->bsd", out, ap["wo"], "o", fi, salt)
    h2 = norm(x, bp["norm2"], cfg.norm)
    if cfg.moe:
        y, aux = moe_apply(h2, bp["ffn"], cfg.moe, cfg.mlp, fi, salt,
                           with_aux=with_aux)
    else:
        y, aux = mlp_apply(h2, bp["ffn"], cfg.mlp, fi, salt), None
    return x + y, new_cache, aux


def _rec_block(x, bp, cfg: ModelConfig, *, cache=None, fi=None, salt=0,
               **_):
    h = norm(x, bp["norm1"], cfg.norm)
    out, new_state = rglru_block(h, bp["rglru"], state=cache, fi=fi,
                                 salt=salt)
    x = x + out
    h2 = norm(x, bp["norm2"], cfg.norm)
    return x + mlp_apply(h2, bp["ffn"], cfg.mlp, fi, salt), new_state, None


def _rwkv_block(x, bp, cfg: ModelConfig, *, cache=None, fi=None, salt=0,
                **_):
    h = norm(x, bp["norm1"], cfg.norm)
    out, tm_state = rwkv_time_mix(h, bp["tm"], cfg.rwkv_head_dim,
                                  state=None if cache is None
                                  else cache["tm"], fi=fi, salt=salt)
    x = x + out
    h2 = norm(x, bp["norm2"], cfg.norm)
    out2, cm_shift = rwkv_channel_mix(h2, bp["cm"],
                                      state=None if cache is None
                                      else cache["cm_shift"], fi=fi,
                                      salt=salt)
    new_state = (None if cache is None
                 else {"tm": tm_state, "cm_shift": cm_shift})
    return x + out2, new_state, None


_BLOCKS = {"attn": _attn_block, "rec": _rec_block, "rwkv": _rwkv_block}


def _run_blocks(x, params, cfg: ModelConfig, *, positions, prefix_len=0,
                states=None, cache_len=None, fi=None, with_aux: bool = False,
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
    _decoder_only(cfg)
    new_states: Optional[List] = [] if states is not None else None
    aux_total = (torch.zeros((), dtype=torch.float32, device=x.device)
                 if with_aux else None)
    for i, (kind, bp) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        block = _BLOCKS[kind]
        if remat and torch.is_grad_enabled():
            block = functools.partial(checkpoint, block, use_reentrant=False)
        x, ns, aux = block(x, bp, cfg, positions=positions,
                           prefix_len=prefix_len,
                           cache=None if states is None else states[i],
                           cache_len=cache_len, fi=fi, salt=i,
                           with_aux=with_aux)
        if aux is not None:
            aux_total = aux_total + aux
        if new_states is not None:
            new_states.append(ns)
    return x, new_states, aux_total


def embed_tokens(params, cfg: ModelConfig, tokens, prefix_embeds=None,
                 with_prefix: bool = True):
    """Token embeddings (scaled by sqrt(d) where the config says so),
    after the prefix's: ``prefix_embeds (B, P, d)`` through the clean
    ``prefix_proj`` (the reference's ``op_linear(..., "embed")`` with no
    fault config)."""
    # a gather; its backward sums rows by sorted index, not by atomics
    x = torch.nn.functional.embedding(tokens, params["embed"])
    if cfg.scale_embeds:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    if cfg.prefix_tokens and with_prefix:
        if prefix_embeds is None:
            raise ValueError(f"{cfg.name} needs prefix_embeds (B, "
                             f"{cfg.prefix_tokens}, {cfg.d_model})")
        pe = op_linear(prefix_embeds.to(x.dtype), params["prefix_proj"],
                       "embed")
        x = torch.cat([pe, x], dim=1)
    return x


def unembed(params, cfg: ModelConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w).to(torch.float32)


def forward_logits(params, cfg: ModelConfig, tokens, *, prefix_embeds=None,
                   fi: Optional[FaultConfig] = None, states=None,
                   cache_len=None, remat: bool = False):
    """Full-sequence forward (prefill).  tokens: (B, S) int; a VLM also
    takes ``prefix_embeds`` (B, prefix_tokens, d), whose positions come
    first.  Returns ``(logits (B, prefix_tokens + S, vocab) float32,
    new_states, aux)``, ``aux`` the MoE load-balance loss summed over
    layers (float32, 0 for other models; ``(N,)``, one per lane, under a
    lane config).  ``remat`` recomputes each block in the backward pass
    (see :func:`_run_blocks`)."""
    x = embed_tokens(params, cfg, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, new_states, aux = _run_blocks(x, params, cfg, positions=positions,
                                     prefix_len=cfg.prefix_tokens,
                                     states=states, cache_len=cache_len,
                                     fi=fi, with_aux=True, remat=remat)
    x = norm(x, params["final_norm"], cfg.norm)
    return unembed(params, cfg, x), new_states, aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> List[Dict]:
    """Per-layer decode state: ``{"k", "v"}`` of (B, kv_len, KV, hd) for
    attention (``kv_len = min(max_len, window)`` with a window: a ring),
    the RG-LRU's conv tail (``dtype``) and float32 ``h``, RWKV's bf16
    shifts and float32 WKV state."""
    _decoder_only(cfg)

    def one(kind):
        if kind == "attn":
            kv_len = min(max_len, cfg.window) if cfg.window else max_len
            shp = (batch, kv_len, cfg.n_kv_heads, cfg.hd)
            return {"k": torch.zeros(shp, dtype=dtype, device=device),
                    "v": torch.zeros(shp, dtype=dtype, device=device)}
        if kind == "rec":
            return rglru_init_state(batch, cfg.d_model, dtype, device)
        return rwkv_init_state(batch, cfg.d_model, cfg.rwkv_head_dim, device)

    return [one(kind) for kind in layer_kinds(cfg)]


def decode_step(params, cfg: ModelConfig, token, cache, cache_len: int, *,
                fi: Optional[FaultConfig] = None):
    """One decode step.  token: (B, 1); ``cache_len`` includes this token
    (and a VLM's prefix).  The MoE load-balance loss is not computed:
    decode has no use for it."""
    x = embed_tokens(params, cfg, token, with_prefix=False)
    positions = torch.full((1, 1), cache_len - 1, dtype=torch.int64,
                           device=x.device)
    x, new_cache, _ = _run_blocks(x, params, cfg, positions=positions,
                                  states=cache, cache_len=cache_len, fi=fi)
    x = norm(x, params["final_norm"], cfg.norm)
    return unembed(params, cfg, x), new_cache
