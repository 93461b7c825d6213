"""Attention: causal GQA with the faultable QK^T / SV domains, and decode
against a KV cache.  Shapes: q (B, S, H, hd) grouped as (B, S, KV, G, hd)
with G = H // KV; k/v (B, S, KV, hd).  Sliding windows, prefix masks and
the reference's chunked (flash-style) clean prefill are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import FaultConfig, op_batched_matmul

NEG_INF = -1e30


def _mask(q_pos, k_pos):
    """(Sq, Sk) causal mask; True = attend."""
    return q_pos[:, None] >= k_pos[None, :]


def full_attention(q, k, v, *, fi: Optional[FaultConfig] = None, salt=0):
    """Causal GQA attention over the whole sequence (prefill), with the
    faultable QK^T / SV domains."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd) * (hd ** -0.5)
    qt = qg.permute(0, 2, 3, 1, 4)                     # B KV G Sq hd
    kt = k.permute(0, 2, 3, 1)                         # B KV hd Sk
    scores = op_batched_matmul(qt, kt[:, :, None], "qkt", fi, salt)
    m = _mask(torch.arange(Sq, device=q.device),
              torch.arange(k.shape[1], device=q.device))
    scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    vt = v.permute(0, 2, 1, 3)                         # B KV Sk hd
    out = op_batched_matmul(probs, vt[:, :, None], "sv", fi, salt)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def decode_attention(q1, k_cache, v_cache, cache_len: int, *,
                     fi: Optional[FaultConfig] = None, salt=0):
    """Single-token decode vs a (B, S_max, KV, hd) ring-buffer cache with
    every row at depth ``cache_len``."""
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
