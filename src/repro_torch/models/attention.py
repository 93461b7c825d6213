"""Attention: GQA/MQA with the faultable QK^T / SV domains, sliding
windows, prefix-bidirectional masks, non-causal (encoder, cross) attention,
and decode against a ring-buffer KV cache.  Shapes: q (B, S, H, hd)
grouped as (B, S, KV, G, hd) with G = H // KV; k/v (B, S, KV, hd).

:func:`attention` dispatches as the reference's does: a clean call
(``fi is None``) of S >= 2048 queries runs :func:`chunked_attention`
(flash-style online softmax over 512 x 512 chunks), anything else
:func:`full_attention` (the faulted path is full attention in both).
:data:`FORCE_SINGLE_CHUNK` sends every call to :func:`full_attention`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import FaultConfig, op_batched_matmul

NEG_INF = -1e30

# The reference's cost-probe knob: full attention at any length (its dry
# run counts every FLOP of a single block, which a scanned chunk loop
# hides).
FORCE_SINGLE_CHUNK = False


def _mask(q_pos, k_pos, causal: bool, window: Optional[int] = None,
          prefix_len: int = 0, kv_valid: Optional[int] = None):
    """(..., Sq, Sk) boolean mask of query positions ``q_pos`` (..., Sq)
    and key positions ``k_pos`` (Sk,); True = attend.  Causal, except that
    inside the first ``prefix_len`` positions attention is bidirectional;
    with a ``window``, a query sees the keys less than ``window`` behind
    it; keys at ``kv_valid`` and beyond (chunk padding) are masked."""
    q_pos = q_pos[..., :, None]
    m = torch.ones(q_pos.shape[:-1] + k_pos.shape, dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        cm = q_pos >= k_pos
        if prefix_len:
            cm = cm | ((q_pos < prefix_len) & (k_pos < prefix_len))
        m = m & cm
    if window is not None:
        m = m & (q_pos - k_pos < window)
    if kv_valid is not None:
        m = m & (k_pos < kv_valid)
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


def _f32_products(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 for a product the reference takes with
    ``preferred_element_type=float32``: bf16 x bf16 products are exact in
    float32, so only the summation order differs.  TF32 would round the
    operands, so a card with TF32 matmuls on is refused."""
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise NotImplementedError(
            "chunked attention needs float32 matmuls: turn TF32 off "
            "(torch.backends.cuda.matmul.allow_tf32 = False)")
    return x.to(torch.float32)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, prefix_len: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 512):
    """Flash-style chunked attention (online softmax), the reference's
    function in its order.

    Queries and keys are padded to whole chunks (padded keys masked via
    ``kv_valid``, padded query rows sliced off).  Every KV chunk is visited
    in order, carrying the running max ``m``, denominator ``l`` and a
    float32 accumulator; the unnormalised ``p`` is rounded to the input
    dtype before the PV product, and the sum divided by ``l`` at the end.
    A query whose first chunks are all masked gathers ``p == 1`` there,
    which the first chunk with a valid key multiplies by ``alpha == 0``,
    as in the reference.  The query chunks carry independent state, so
    they run side by side (one product per KV chunk for all of them).
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    Sk = k.shape[1]
    q_chunk, kv_chunk = min(q_chunk, S), min(kv_chunk, Sk)
    pad_q, pad_k = (-S) % q_chunk, (-Sk) % kv_chunk
    kv_valid = Sk if pad_k else None
    pad = torch.nn.functional.pad
    if pad_q:
        q = pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = pad(k, (0, 0, 0, 0, 0, pad_k))
        v = pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (S + pad_q) // q_chunk, (Sk + pad_k) // kv_chunk
    qg = _f32_products(
        (q * (hd ** -0.5)).reshape(B, nq, q_chunk, KV, G, hd))
    kg = _f32_products(k).reshape(B, nk, kv_chunk, KV, hd)
    vg = v.reshape(B, nk, kv_chunk, KV, hd)
    q_pos = torch.arange(nq * q_chunk, device=q.device).reshape(nq, q_chunk)

    shape = (B, nq, KV, G, q_chunk)
    m_run = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(shape + (hd,), dtype=torch.float32, device=q.device)
    for j in range(nk):
        k_pos = j * kv_chunk + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("bnqkgh,bskh->bnkgqs", qg, kg[:, j])
        mask = _mask(q_pos, k_pos, causal, window, prefix_len, kv_valid)
        s = torch.where(mask[None, :, None, None], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(-1)
        pv = torch.einsum("bnkgqs,bskh->bnkgqh",
                          _f32_products(p.to(q.dtype)),
                          _f32_products(vg[:, j]))
        acc = acc * alpha[..., None] + pv
        m_run = m_new
    out = (acc / torch.clamp(l_run, min=1e-30)[..., None]).to(q.dtype)
    # (B, nq, KV, G, qc, hd) -> (B, S(+pad), H, hd)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, S + pad_q, H, hd)
    return out[:, :S]


def attention(q, k, v, *, causal: bool = True,
              window: Optional[int] = None, prefix_len: int = 0,
              fi: Optional[FaultConfig] = None, salt=0,
              chunk_threshold: int = 2048):
    """The reference's dispatch: chunked for a clean call of at least
    ``chunk_threshold`` queries, full (faultable) attention otherwise."""
    if fi is None and q.shape[1] >= chunk_threshold \
            and not FORCE_SINGLE_CHUNK:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 prefix_len=prefix_len)
    return full_attention(q, k, v, causal=causal, window=window,
                          prefix_len=prefix_len, fi=fi, salt=salt)


def decode_attention(q1, k_cache, v_cache, cache_len, *,
                     fi: Optional[FaultConfig] = None, salt=0):
    """Single-token decode vs a (B, S_max, KV, hd) ring-buffer cache:
    token ``t`` sits in slot ``t % S_max``, so once ``cache_len >= S_max``
    every slot is valid (a windowed cache holds exactly the window;
    attention does not depend on the slots' order, and RoPE was applied
    before caching).

    ``cache_len`` is an int (every row at one depth) or a ``(B,)`` tensor
    of per-row depths (the online slots, each at its own ragged depth); an
    all-equal tensor masks exactly as the int does."""
    B, _, H, hd = q1.shape
    S = k_cache.shape[1]
    KV = k_cache.shape[2]
    G = H // KV
    qg = (q1 * (hd ** -0.5)).reshape(B, 1, KV, G, hd).permute(0, 2, 3, 1, 4)
    kt = k_cache.permute(0, 2, 3, 1)                   # B KV hd S
    s = op_batched_matmul(qg, kt[:, :, None], "qkt", fi, salt)  # B KV G 1 S
    pos = torch.arange(S, device=q1.device)
    if isinstance(cache_len, torch.Tensor):            # per-row depths
        valid = (pos[None, :] < torch.clamp(cache_len, max=S)[:, None]
                 )[:, None, None, None, :]
    else:
        valid = pos < min(cache_len, S)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s.to(torch.float32), dim=-1).to(q1.dtype)
    vt = v_cache.permute(0, 2, 1, 3)                   # B KV S hd
    out = op_batched_matmul(p, vt[:, :, None], "sv", fi, salt)
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, hd)
