"""Attention: GQA/MQA with the faultable QK^T / SV domains, sliding
windows, prefix-bidirectional masks, non-causal (encoder, cross) attention,
and decode against a ring-buffer KV cache.  Shapes: q (B, S, H, hd)
grouped as (B, S, KV, G, hd) with G = H // KV; k/v (B, S, KV, hd).

The reference runs a clean prefill of S >= 2048 tokens as chunked
(flash-style) online-softmax attention; the port runs it as
:func:`full_attention`, the same function in another float order (its
faulted path is full attention in both).  Chunked attention is ROADMAP
A.6's next item.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import FaultConfig, op_batched_matmul

NEG_INF = -1e30


def _mask(q_pos, k_pos, causal: bool, window: Optional[int] = None,
          prefix_len: int = 0):
    """(Sq, Sk) boolean mask; True = attend.  Causal, except that inside
    the first ``prefix_len`` positions attention is bidirectional; with a
    ``window``, a query sees the keys less than ``window`` behind it."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        cm = q_pos[:, None] >= k_pos[None, :]
        if prefix_len:
            cm = cm | ((q_pos[:, None] < prefix_len)
                       & (k_pos[None, :] < prefix_len))
        m = m & cm
    if window is not None:
        m = m & (q_pos[:, None] - k_pos[None, :] < window)
    return m


def full_attention(q, k, v, *, causal: bool = True,
                   window: Optional[int] = None, prefix_len: int = 0,
                   fi: Optional[FaultConfig] = None, salt=0):
    """Attention over the whole sequence (prefill, encoder, cross), with
    the faultable QK^T / SV domains."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd) * (hd ** -0.5)
    qt = qg.permute(0, 2, 3, 1, 4)                     # B KV G Sq hd
    kt = k.permute(0, 2, 3, 1)                         # B KV hd Sk
    scores = op_batched_matmul(qt, kt[:, :, None], "qkt", fi, salt)
    m = _mask(torch.arange(Sq, device=q.device),
              torch.arange(k.shape[1], device=q.device), causal, window,
              prefix_len)
    scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    vt = v.permute(0, 2, 1, 3)                         # B KV Sk hd
    out = op_batched_matmul(probs, vt[:, :, None], "sv", fi, salt)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def decode_attention(q1, k_cache, v_cache, cache_len: int, *,
                     fi: Optional[FaultConfig] = None, salt=0):
    """Single-token decode vs a (B, S_max, KV, hd) ring-buffer cache with
    every row at depth ``cache_len``: token ``t`` sits in slot
    ``t % S_max``, so once ``cache_len >= S_max`` every slot is valid (a
    windowed cache holds exactly the window; attention does not depend on
    the slots' order, and RoPE was applied before caching)."""
    B, _, H, hd = q1.shape
    S = k_cache.shape[1]
    KV = k_cache.shape[2]
    G = H // KV
    qg = (q1 * (hd ** -0.5)).reshape(B, 1, KV, G, hd).permute(0, 2, 3, 1, 4)
    kt = k_cache.permute(0, 2, 3, 1)                   # B KV hd S
    s = op_batched_matmul(qg, kt[:, :, None], "qkt", fi, salt)  # B KV G 1 S
    valid = torch.arange(S, device=q1.device) < min(cache_len, S)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s.to(torch.float32), dim=-1).to(q1.dtype)
    vt = v_cache.permute(0, 2, 1, 3)                   # B KV S hd
    out = op_batched_matmul(p, vt[:, :, None], "sv", fi, salt)
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, hd)
