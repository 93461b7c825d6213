"""Whisper-style encoder-decoder backbone, conv frontend stubbed (port of
``repro.models.encdec``).

The encoder takes precomputed frame embeddings (B, encoder_seq, d) plus
sinusoidal positions: bidirectional self-attention + MLP per layer.  The
decoder adds learned positions to its token embeddings and runs causal
self-attention, cross-attention into the encoder output and an MLP per
layer.  Fault streams keep the reference's salts as they are: the encoder
layers and every layer's cross-attention K/V (:func:`cross_kv`) draw with
salt 0, the decoder layers with their layer index.  The unembedding
``lm_head`` is clean, as in the reference.  The port's tree holds one
dict per layer (``enc_layers[i]``, ``dec_layers[i]``) where the
reference stacks them; the decode cache is a per-layer ``{"k", "v"}``
list written slot by slot (token ``t`` at slot ``t``) in place.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs import ModelConfig
from ..device import resolve_device
from ..distributed import sharding as shrules
from . import attention as attn_lib
from .layers import (FaultConfig, _normal, init_norm, mlp_apply, mlp_init,
                     norm, op_einsum, sinusoid_positions)
from .transformer import _attn_init, refuse_quantized

MAX_DEC_POS = 8192  # learned decoder position table (paper backbone stub)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda", place=None) -> Dict:
    """Random params from a seeded ``torch.Generator`` on ``device``, with
    the reference's tree and scales (``dec_pos`` ``N(0,1) * 0.01``).
    ``place`` is applied to each top-level leaf and layer as it is drawn
    (:func:`repro_torch.models.transformer.init_params`)."""
    device = resolve_device(device)
    place = place or (lambda tree: tree)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model
    nrm = lambda: init_norm(cfg.norm, d, dtype, device)

    def enc_layer():
        return {"norm1": nrm(), "attn": _attn_init(cfg, dtype, device, gen),
                "norm2": nrm(),
                "ffn": mlp_init(d, cfg.d_ff, cfg.mlp, dtype, device, gen)}

    def dec_layer():
        return {"norm1": nrm(),
                "self_attn": _attn_init(cfg, dtype, device, gen),
                "norm_x": nrm(),
                "cross_attn": _attn_init(cfg, dtype, device, gen),
                "norm2": nrm(),
                "ffn": mlp_init(d, cfg.d_ff, cfg.mlp, dtype, device, gen)}

    params = place({"embed": _normal((cfg.vocab, d), 0.02, dtype, device,
                                     gen)})
    params.update(place({"dec_pos": _normal((MAX_DEC_POS, d), 0.01, dtype,
                                            device, gen)}))
    params["enc_layers"] = [place(enc_layer())
                            for _ in range(cfg.n_encoder_layers)]
    params["dec_layers"] = [place(dec_layer()) for _ in range(cfg.n_layers)]
    params.update(place({"enc_final": nrm(), "final_norm": nrm()}))
    params.update(place({"lm_head": _normal((d, cfg.vocab), d ** -0.5,
                                            dtype, device, gen)}))
    return params


def _self_attn(h, ap, cfg: ModelConfig, *, causal: bool, fi=None, salt=0,
               cache=None, cache_len: Optional[int] = None):
    q = op_einsum("bsd,dhk->bshk", h, ap["wq"], "q", fi, salt)
    k = op_einsum("bsd,dhk->bshk", h, ap["wk"], "k", fi, salt)
    v = op_einsum("bsd,dhk->bshk", h, ap["wv"], "v", fi, salt)
    new_cache = None
    if cache is not None and q.shape[1] == 1:        # decode: slot len - 1
        idx = cache_len - 1
        cache["k"][:, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, idx] = v[:, 0].to(cache["v"].dtype)
        out = attn_lib.decode_attention(q, cache["k"], cache["v"],
                                        cache_len, fi=fi, salt=salt)
        new_cache = cache
    else:
        out = attn_lib.attention(q, k, v, causal=causal, fi=fi, salt=salt)
        if cache is not None:    # prefill: the prompt's K/V in [0, S)
            pad = (0, 0, 0, 0, 0, cache["k"].shape[1] - k.shape[1])
            new_cache = {
                "k": torch.nn.functional.pad(k, pad).to(cache["k"].dtype),
                "v": torch.nn.functional.pad(v, pad).to(cache["v"].dtype)}
    return out, new_cache


def _cross_attn(h, enc_kv, ap, cfg: ModelConfig, *, fi=None, salt=0):
    q = op_einsum("bsd,dhk->bshk", h, ap["wq"], "q", fi, salt)
    return attn_lib.attention(q, enc_kv["k"], enc_kv["v"], causal=False,
                              fi=fi, salt=salt)


def _maybe_remat(fn, remat: bool):
    if remat and torch.is_grad_enabled():
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return fn


def _enc_layer(x, lp, cfg: ModelConfig, fi):
    h = norm(x, lp["norm1"], cfg.norm)
    out, _ = _self_attn(h, lp["attn"], cfg, causal=False, fi=fi)
    x = x + op_einsum("bshk,hkd->bsd", out, lp["attn"]["wo"], "o", fi)
    h2 = norm(x, lp["norm2"], cfg.norm)
    return x + mlp_apply(h2, lp["ffn"], cfg.mlp, fi)


def encode(params, cfg: ModelConfig, frames, *,
           fi: Optional[FaultConfig] = None, remat: bool = False):
    """frames: (B, S_enc, d) precomputed frame embeddings (stub frontend)
    -> the encoder output (B, S_enc, d) in the params' dtype."""
    refuse_quantized(params, "the enc-dec family (the reference's encoder "
                     "reads params['embed'].dtype)")
    x = frames.to(params["embed"].dtype)
    x = x + sinusoid_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    layer = _maybe_remat(_enc_layer, remat)
    for lp in params["enc_layers"]:
        x = layer(x, lp, cfg, fi)
    return norm(x, params["enc_final"], cfg.norm)


def cross_kv(params, cfg: ModelConfig, enc_out, *,
             fi: Optional[FaultConfig] = None) -> List[Dict]:
    """Every decoder layer's cross-attention ``{"k", "v"}`` (B, S_enc, KV,
    hd), computed once per encoder output (salt 0, as the reference)."""
    out = []
    for lp in params["dec_layers"]:
        ap = lp["cross_attn"]
        out.append({"k": op_einsum("bsd,dhk->bshk", enc_out, ap["wk"], "k",
                                   fi),
                    "v": op_einsum("bsd,dhk->bshk", enc_out, ap["wv"], "v",
                                   fi)})
    return out


def _dec_layer(x, lp, lkv, lcache, cfg: ModelConfig, fi, salt, cache_len):
    h = norm(x, lp["norm1"], cfg.norm)
    out, new_c = _self_attn(h, lp["self_attn"], cfg, causal=True, fi=fi,
                            salt=salt, cache=lcache, cache_len=cache_len)
    x = x + op_einsum("bshk,hkd->bsd", out, lp["self_attn"]["wo"], "o", fi,
                      salt)
    hx = norm(x, lp["norm_x"], cfg.norm)
    xo = _cross_attn(hx, lkv, lp["cross_attn"], cfg, fi=fi, salt=salt)
    x = x + op_einsum("bshk,hkd->bsd", xo, lp["cross_attn"]["wo"], "o", fi,
                      salt)
    h2 = norm(x, lp["norm2"], cfg.norm)
    return x + mlp_apply(h2, lp["ffn"], cfg.mlp, fi, salt), new_c


def decode(params, cfg: ModelConfig, tokens, enc_out=None, kv=None, *,
           fi: Optional[FaultConfig] = None, cache=None,
           cache_len: Optional[int] = None, pos_offset: int = 0,
           remat: bool = False):
    """Teacher-forced decoder over ``tokens`` (B, S), or one step with a
    ``cache``.  ``kv`` (:func:`cross_kv`) is computed from ``enc_out``
    when not given.  Returns ``(logits (B, S, vocab) float32, new cache
    or None)``."""
    refuse_quantized(params, "the enc-dec family")
    if kv is None:
        kv = cross_kv(params, cfg, enc_out, fi=fi)
    x = shrules.lookup_rows(params["embed"], tokens)
    pos = torch.arange(tokens.shape[1], device=x.device) + pos_offset
    x = x + shrules.lookup_rows(params["dec_pos"], pos)[None]
    layer = _maybe_remat(_dec_layer, remat and cache is None)
    new_cache = [] if cache is not None else None
    for i, lp in enumerate(params["dec_layers"]):
        x, nc = layer(x, lp, kv[i], None if cache is None else cache[i],
                      cfg, fi, i, cache_len)
        if new_cache is not None:
            new_cache.append(nc)
    x = norm(x, params["final_norm"], cfg.norm)
    logits = shrules.block_product(
        x, params["lm_head"], lambda x, w: x @ shrules.held(w), {1: -1})
    return logits.to(torch.float32), new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> List[Dict]:
    """Per-decoder-layer self-attention ``{"k", "v"}`` of (B, max_len, KV,
    hd)."""
    shp = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shp, dtype=dtype, device=device),
             "v": torch.zeros(shp, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]
