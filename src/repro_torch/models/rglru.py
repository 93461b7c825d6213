"""Griffin/RecurrentGemma recurrent block: causal conv1d + RG-LRU (port of
``repro.models.rglru``).

RG-LRU (arXiv:2402.19427):

    r_t = sigmoid(x_t W_a);  i_t = sigmoid(x_t W_x)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the diagonal-linear recurrence as the reference's
``jax.lax.associative_scan`` does, level by level in the same odd/even
order (:func:`_assoc_scan`): log2(S) levels of elementwise tensor
operations, each vectorised over the sequence.  Decode is one update,
``a * h + x``.  The block is Griffin's: a GELU (tanh) gate branch times
conv1d(4) -> RG-LRU, projected back; its weight matmuls are the ``g``,
``v``, ``r``, ``k`` and ``o`` operator domains.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import FaultConfig, _normal, op_linear

C_RGLRU = 8.0
CONV_W = 4


def rglru_init(d: int, dtype, device, gen) -> Dict:
    s = d ** -0.5
    p = {name: _normal((d, d), s, dtype, device, gen)
         for name in ("w_x", "w_gate", "w_out", "w_a", "w_i")}
    p["lam"] = torch.rand((d,), dtype=torch.float32, device=device,
                          generator=gen) * 0.6 + 0.7
    p["conv_w"] = torch.zeros((CONV_W, d), dtype=dtype, device=device)
    p["conv_w"][-1] = 1.0
    p["conv_b"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            state: Optional[torch.Tensor] = None):
    """Causal depthwise conv of width CONV_W over x (B, S, d), in the
    reference's sum order.  ``state``: (B, CONV_W - 1, d), the trailing
    inputs of the previous segment.  Returns (y, new_state)."""
    B, S, d = x.shape
    if state is None:
        state = torch.zeros((B, CONV_W - 1, d), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)        # (B, S+3, d)
    y = sum(xp[:, i:i + S] * w[i] for i in range(CONV_W)) + b
    return y, xp[:, -(CONV_W - 1):]


def _combine(lhs, rhs):
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = torch.empty((even.shape[0], even.shape[1] + odd.shape[1])
                      + tuple(even.shape[2:]), dtype=even.dtype,
                      device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _assoc_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple:
    """Inclusive scan of ``(a, b)`` pairs along axis 1 under
    :func:`_combine`, with ``jax.lax.associative_scan``'s recursion: pair
    up neighbours, scan the pairs, then fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rglru_scan(xin: torch.Tensor, a: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + xin_t along axis 1, from ``h0`` (folded into the
    first step, as the reference does)."""
    b = xin
    if h0 is not None:
        b = torch.cat([b[:, :1] + (a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
    return _assoc_scan(a, b)[1]


def rglru_block(x: torch.Tensor, p: Dict, *, state: Optional[Dict] = None,
                fi: Optional[FaultConfig] = None, salt=0
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d) -> (B, S, d); ``state`` carries (conv, h) across
    segments and comes back updated (``None`` without one)."""
    gate = F.gelu(op_linear(x, p["w_gate"], "g", fi, salt),
                  approximate="tanh")
    u = op_linear(x, p["w_x"], "v", fi, salt)
    u, new_conv = _conv1d(u, p["conv_w"], p["conv_b"],
                          None if state is None else state["conv"])
    r = torch.sigmoid(op_linear(u, p["w_a"], "r", fi, salt)
                      .to(torch.float32))
    i = torch.sigmoid(op_linear(u, p["w_i"], "k", fi, salt)
                      .to(torch.float32))
    log_a = -C_RGLRU * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    xin = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) \
        * (i * u.to(torch.float32))
    h0 = None if state is None else state["h"]
    if x.shape[1] == 1 and state is not None:           # decode
        h = a[:, 0] * h0 + xin[:, 0]
        hs = h[:, None]
    else:
        hs = _rglru_scan(xin, a, h0)
        h = hs[:, -1]
    out = op_linear(hs.to(x.dtype) * gate, p["w_out"], "o", fi, salt)
    new_state = {"conv": new_conv, "h": h} if state is not None else None
    return out, new_state


def rglru_init_state(batch: int, d: int, dtype, device) -> Dict:
    """Zero decode state: the conv tail in ``dtype``, ``h`` in float32."""
    return {"conv": torch.zeros((batch, CONV_W - 1, d), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, d), dtype=torch.float32, device=device)}
