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

An int8 weight tree (:func:`quantize_params`) holds its matrices as
``{"int8_q", "int8_s"}`` leaves, int8 values with per-output-channel
float32 scales; each layer is dequantised at the top of the layer loop,
so a bf16 copy exists only for the layer being computed.  An int8 KV
cache (``init_cache(quantized=True)``) holds K/V the same way, one scale
per (token, head).
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
                device="cuda", place=None) -> Dict:
    """Random params from a seeded ``torch.Generator`` on ``device``, with
    the reference's scales (``N(0,1) * d**-0.5`` projections, ``0.02``
    embeddings) and tree (no ``lm_head`` under tied embeddings, a
    ``prefix_proj`` for prefix embeddings; float32 MoE router, RG-LRU
    ``lam``, RWKV ``decay_base`` and ``bonus_u``).

    ``place`` (a function of a dict of params) is applied to each
    top-level leaf and each layer as soon as it is drawn, so a caller can
    keep part of it (a rank's blocks) and let the rest go before the next
    draw; the draws are the same either way."""
    _decoder_only(cfg)
    device = resolve_device(device)
    place = place or (lambda tree: tree)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model
    params: Dict = place({
        "embed": _normal((cfg.vocab, d), 0.02, dtype, device, gen),
        "final_norm": init_norm(cfg.norm, d, dtype, device),
    })
    if not cfg.tie_embeddings:
        params.update(place({"lm_head": _normal(
            (d, cfg.vocab), d ** -0.5, dtype, device, gen)}))
    if cfg.prefix_tokens:
        params.update(place({"prefix_proj": _normal(
            (d, d), d ** -0.5, dtype, device, gen)}))
    params["layers"] = [place(_block_init(kind, cfg, dtype, device, gen))
                        for kind in layer_kinds(cfg)]
    return params


# --------------------------------------------------------------------------- #
# int8 weight trees and KV caches
# --------------------------------------------------------------------------- #
def _quantize(x: torch.Tensor, compiled: bool = False) -> Dict:
    """``x`` -> int8 values and float32 scales over its last axis:
    ``s = max(amax, 1e-8) / 127``, ``q = clip(round(x / s), -127, 127)``
    (rounded half to even, as ``jnp.round``).  ``compiled`` takes ``s``
    as the reference's compiled steps do, where XLA turns the division by
    the constant 127 into a product with its float32 reciprocal (an ulp
    apart now and then); its ``quantize_params`` runs op by op and
    divides."""
    xf = x.to(torch.float32)
    amax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8)
    if compiled:
        s = amax * (torch.ones((), dtype=torch.float32, device=x.device)
                    / 127.0)
    else:
        s = amax / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return {"int8_q": q, "int8_s": s}


def is_qleaf(x) -> bool:
    """An int8 leaf: ``{"int8_q": int8, "int8_s": float32}``."""
    return isinstance(x, dict) and "int8_q" in x


def is_quantized(params) -> bool:
    """True for a tree from :func:`quantize_params` (its embedding table
    is always an int8 leaf)."""
    return is_qleaf(params.get("embed"))


def compute_dtype(params):
    """The dtype a tree serves in: its embedding table's, and bf16 for an
    int8 tree (whose embedding rows dequantise to bf16)."""
    emb = params["embed"]
    return torch.bfloat16 if is_qleaf(emb) else emb.dtype


def params_device(params) -> torch.device:
    """The device a param tree (int8 or not) lives on."""
    emb = params["embed"]
    return (emb["int8_q"] if is_qleaf(emb) else emb).device


def refuse_quantized(params, what: str) -> None:
    """Training, the enc-dec family and the mesh engines take no int8
    tree: the reference fails on them or never gives them one."""
    if is_quantized(params):
        raise NotImplementedError(f"{what} takes no int8 weight tree "
                                  "(quantize_params): ROADMAP A.10")


def quantize_params(params: Dict, cfg: ModelConfig) -> Dict:
    """A param tree -> its int8 tree, leaf for leaf as the reference's
    ``quantize_params`` quantises its stacked tree: every leaf of two
    dims or more there.  The reference stacks each layer of a whole
    period of ``cfg.block_pattern`` under a leading group axis, so a
    layer leaf that is 1-D on its own (a norm's scale, RG-LRU's ``lam``,
    RWKV's ``mix`` / ``decay_base``) is quantised there, one scale a
    layer, while the same leaf of a tail layer (past the last whole
    period) and the top-level ``final_norm`` are not.  An enc-dec tree's
    layers are all stacked."""
    def tree(t, min_ndim):
        if isinstance(t, dict):
            return {k: tree(v, min_ndim) for k, v in t.items()}
        return _quantize(t) if t.dim() >= min_ndim else t

    out = {k: tree(v, 2) for k, v in params.items()
           if k not in ("layers", "enc_layers", "dec_layers")}
    if "enc_layers" in params:
        out["enc_layers"] = [tree(lp, 1) for lp in params["enc_layers"]]
        out["dec_layers"] = [tree(lp, 1) for lp in params["dec_layers"]]
        return out
    n_stacked = cfg.n_layers // len(cfg.block_pattern) \
        * len(cfg.block_pattern)
    out["layers"] = [tree(lp, 1 if i < n_stacked else 2)
                     for i, lp in enumerate(params["layers"])]
    return out


def dequant_tree(tree, dtype=torch.bfloat16):
    """Every int8 leaf of ``tree`` as ``int8_q.to(dtype) *
    int8_s.to(dtype)`` (a product in ``dtype``, as the reference's); other
    leaves pass through."""
    if is_qleaf(tree):
        return tree["int8_q"].to(dtype) * tree["int8_s"].to(dtype)
    if isinstance(tree, dict):
        return {k: dequant_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dequant_tree(v, dtype) for v in tree]
    return tree


def quantize_cache_entry(x: torch.Tensor) -> Dict:
    """K or V ``(B, S, KV, hd)`` -> int8 values and one float32 scale per
    (token, head), over ``hd``, as the reference's compiled prefill and
    decode steps quantise them."""
    return _quantize(x, compiled=True)


# --------------------------------------------------------------------------- #
def _attn_block(x, bp, cfg: ModelConfig, *, positions, prefix_len: int = 0,
                cache=None, cache_len=None, fi=None, salt=0,
                with_aux: bool = False):
    """Self-attention + FFN block.  With ``cache`` and one token: decode,
    at one depth (``cache_len`` an int) or at each row's own (a ``(B,)``
    tensor: row ``b`` ring-writes its slot ``(cache_len[b] - 1) %
    kv_len``).  Returns ``(x, new_cache, aux)``; ``aux`` is the MoE
    load-balance loss when ``with_aux`` is set and the FFN is MoE, else
    ``None``."""
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
    qcache = cache is not None and is_qleaf(cache["k"])
    if cache is not None and q.shape[1] == 1:
        # decode: ring-write token cache_len - 1 at its slot, attend; an
        # int8 cache takes the quantised entry and is attended dequantised
        kv_len = (cache["k"]["int8_q"] if qcache else cache["k"]).shape[1]
        idx = (cache_len - 1) % kv_len
        if isinstance(cache_len, torch.Tensor):
            rows = torch.arange(k.shape[0], device=k.device)

            def write(buf, new):
                buf[rows, idx] = new[:, 0]
        else:
            def write(buf, new):
                buf[:, idx] = new[:, 0]
        if qcache:
            for name, new in (("k", k), ("v", v)):
                entry = quantize_cache_entry(new)
                for f in entry:
                    write(cache[name][f], entry[f])
            k_at, v_at = (dequant_tree(cache[n], q.dtype) for n in "kv")
        else:
            write(cache["k"], k)
            write(cache["v"], v)
            k_at, v_at = cache["k"], cache["v"]
        out = attn_lib.decode_attention(q, k_at, v_at, cache_len, fi=fi,
                                        salt=salt)
        new_cache = cache
    else:
        out = attn_lib.attention(q, k, v, causal=True, window=cfg.window,
                                 prefix_len=prefix_len, fi=fi, salt=salt)
        if cache is not None:    # prefill: stash K/V
            kv_len = (cache["k"]["int8_q"] if qcache
                      else cache["k"]).shape[1]
            S = k.shape[1]
            if S >= kv_len:      # keep the last kv_len tokens at t % kv_len
                kc = torch.roll(k[:, -kv_len:], S % kv_len, dims=1)
                vc = torch.roll(v[:, -kv_len:], S % kv_len, dims=1)
            else:
                pad = (0, 0, 0, 0, 0, kv_len - S)
                kc = torch.nn.functional.pad(k, pad)
                vc = torch.nn.functional.pad(v, pad)
            if qcache:
                new_cache = {"k": quantize_cache_entry(kc),
                             "v": quantize_cache_entry(vc)}
            else:
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
    int8 = is_quantized(params)
    period = len(cfg.block_pattern)
    n_grouped = cfg.n_layers // period * period
    for i, (kind, bp) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        if i < n_grouped and i % period == 0:
            # a layer group's start, where the reference's scan pins it
            x = shrules.constrain_activation(x)
        if int8:         # this layer alone, in the activations' dtype
            bp = dequant_tree(bp, x.dtype)
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
    fault config).  A rank's block of the table gives whole rows
    (:func:`repro_torch.distributed.sharding.lookup_rows`)."""
    emb = params["embed"]
    if is_qleaf(emb):    # gather int8 rows, dequantise those rows, in bf16
        x = emb["int8_q"][tokens].to(torch.bfloat16) \
            * emb["int8_s"][tokens].to(torch.bfloat16)
    else:
        # a gather; its backward sums rows by sorted index, not by atomics
        x = shrules.lookup_rows(emb, tokens)
    if cfg.scale_embeds:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    if cfg.prefix_tokens and with_prefix:
        if prefix_embeds is None:
            raise ValueError(f"{cfg.name} needs prefix_embeds (B, "
                             f"{cfg.prefix_tokens}, {cfg.d_model})")
        pe = op_linear(prefix_embeds.to(x.dtype),
                       dequant_tree(params["prefix_proj"], x.dtype), "embed")
        x = torch.cat([pe, x], dim=1)
    return x


def unembed(params, cfg: ModelConfig, x):
    """Logits, float32; a rank's vocab block of the head gives its
    columns, gathered, and a block of its ``d_model`` side (the train
    layout's fallback, a tied head's) its partial sums, all-reduced
    (:func:`repro_torch.distributed.sharding.block_product`)."""
    if cfg.tie_embeddings:
        logits = shrules.block_product(
            x, dequant_tree(params["embed"], x.dtype),
            lambda x, w: x @ shrules.held(w).T, {0: -1}, {1: -1})
    else:
        logits = shrules.block_product(
            x, dequant_tree(params["lm_head"], x.dtype),
            lambda x, w: x @ shrules.held(w), {1: -1}, {0: -1})
    return logits.to(torch.float32)


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
               dtype=torch.bfloat16, device="cuda",
               quantized: bool = False) -> List[Dict]:
    """Per-layer decode state: ``{"k", "v"}`` of (B, kv_len, KV, hd) for
    attention (``kv_len = min(max_len, window)`` with a window: a ring),
    the RG-LRU's conv tail (``dtype``) and float32 ``h``, RWKV's bf16
    shifts and float32 WKV state.  ``quantized=True`` holds each of K and
    V as an int8 leaf: int8 values and a float32 scale (B, kv_len, KV, 1)
    per (token, head)."""
    _decoder_only(cfg)

    def one(kind):
        if kind == "attn":
            kv_len = min(max_len, cfg.window) if cfg.window else max_len
            shp = (batch, kv_len, cfg.n_kv_heads, cfg.hd)
            if quantized:
                z = lambda: {
                    "int8_q": torch.zeros(shp, dtype=torch.int8,
                                          device=device),
                    "int8_s": torch.zeros(shp[:-1] + (1,),
                                          dtype=torch.float32,
                                          device=device)}
                return {"k": z(), "v": z()}
            return {"k": torch.zeros(shp, dtype=dtype, device=device),
                    "v": torch.zeros(shp, dtype=dtype, device=device)}
        if kind == "rec":
            return rglru_init_state(batch, cfg.d_model, dtype, device)
        return rwkv_init_state(batch, cfg.d_model, cfg.rwkv_head_dim, device)

    return [one(kind) for kind in layer_kinds(cfg)]


def decode_step(params, cfg: ModelConfig, token, cache, cache_len, *,
                fi: Optional[FaultConfig] = None):
    """One decode step.  token: (B, 1); ``cache_len`` includes this token
    (and a VLM's prefix): an int, or a ``(B,)`` tensor of per-row depths
    on the tokens' device (the online slots; an all-equal tensor gives the
    int's result bit for bit).  The MoE load-balance loss is not
    computed: decode has no use for it."""
    x = embed_tokens(params, cfg, token, with_prefix=False)
    if isinstance(cache_len, torch.Tensor):
        positions = (cache_len - 1).to(torch.int64)[:, None]      # (B, 1)
    else:
        positions = torch.full((1, 1), cache_len - 1, dtype=torch.int64,
                               device=x.device)
    x, new_cache, _ = _run_blocks(x, params, cfg, positions=positions,
                                  states=cache, cache_len=cache_len, fi=fi)
    x = norm(x, params["final_norm"], cfg.norm)
    return unembed(params, cfg, x), new_cache
