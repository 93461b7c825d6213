"""Mixture-of-Experts FFN with capacity-bucketed, sort-free dispatch (port
of ``repro.models.moe``, its ``global`` dispatch — the one the faulted
path takes).

Routing is a top-k softmax over the router's logits; the router matmul is
the faultable ``router`` operator domain.  Each (token, slot) pair gets a
position in its expert's queue from an int32 one-hot cumsum, is scattered
into an ``(E, C + 1, d)`` buffer (row ``C`` takes the overflow and is
dropped), runs through its expert's FFN, and is gathered back and combined
with the renormalised router weights.  Dropped tokens fall back to the
residual path.  The expert FFNs are clean batched matmuls: the reference
computes them outside every fault hook, and so does the port.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs import MoEConfig
from .layers import FaultConfig, _normal, mlp_apply, mlp_init, op_linear


def moe_init(d: int, f: int, moe: MoEConfig, variant: str, dtype, device,
             gen) -> Dict:
    """Expert weights ``(E, d, f)`` / ``(E, f, d)`` in ``dtype``; the
    router ``(d, E)`` stays float32, as in the reference."""
    E = moe.n_experts
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {"w_router": _normal((d, E), s_in, torch.float32, device, gen),
         "w_up": _normal((E, d, f), s_in, dtype, device, gen),
         "w_down": _normal((E, f, d), s_out, dtype, device, gen)}
    if variant == "gated":
        p["w_gate"] = _normal((E, d, f), s_in, dtype, device, gen)
    if moe.dense_residual:
        p["dense"] = mlp_init(d, f, variant, dtype, device, gen)
    return p


def _capacity(n_tokens: int, moe: MoEConfig) -> int:
    c = int(n_tokens * moe.top_k * moe.capacity_factor / moe.n_experts)
    return max(8, -(-c // 8) * 8)


def moe_apply(x: torch.Tensor, p: Dict, moe: MoEConfig, variant: str,
              fi: Optional[FaultConfig] = None, salt=0, *,
              with_aux: bool = True):
    """x: (B, S, d) -> ``((B, S, d), aux load-balance loss)``; the loss is
    ``None`` when ``with_aux`` is false (decode, which discards it)."""
    B, S, d = x.shape
    T = B * S
    E, K = moe.n_experts, moe.top_k
    C = _capacity(T, moe)
    xf = x.reshape(T, d)

    logits = op_linear(xf, p["w_router"].to(x.dtype), "router", fi, salt)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)             # (T, K)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    aux = aux_load_balance_loss(probs, top_e, E) if with_aux else None

    # position of each (token, slot) in its expert's queue; row-major
    # flattening keeps token order with the slots interleaved
    flat_e = top_e.reshape(-1)                              # (T*K,)
    onehot = F.one_hot(flat_e, E).to(torch.int32)           # (T*K, E)
    pos_all = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = torch.gather(pos_all, 1, flat_e[:, None])[:, 0]
    keep = pos < C
    safe_pos = torch.where(keep, pos, C)                    # C = overflow row

    # scatter into the (E, C+1, d) buffer.  Kept pairs have distinct
    # (expert, position) slots, so only the overflow row C sees duplicate
    # writes; CUDA's scatter picks one of them in no fixed order, which is
    # harmless because that row is dropped here.
    xrep = torch.repeat_interleave(xf, K, dim=0)           # (T*K, d)
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_e, safe_pos] = xrep
    buf = buf[:, :C]

    # expert FFN: (E, C, d) @ (E, d, f), clean as in the reference
    if variant == "gated":
        h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    else:
        h = F.gelu(torch.bmm(buf, p["w_up"]), approximate="tanh")
    out_buf = torch.bmm(h, p["w_down"])                     # (E, C, d)

    # gather back (a dropped pair reads row C - 1, as jax clamps an
    # out-of-range gather, and is zeroed) and combine with router weights
    out_tok = out_buf[flat_e, torch.clamp_max(safe_pos, C - 1)]
    out_tok = torch.where(keep[:, None], out_tok, 0.0)
    w = top_p.reshape(-1)[:, None].to(x.dtype)
    out = (out_tok * w).reshape(T, K, d).sum(dim=1)

    if moe.dense_residual:
        out = out + mlp_apply(xf, p["dense"], variant, fi, salt)
    return out.reshape(B, S, d), aux


def aux_load_balance_loss(probs: torch.Tensor, top_e: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (float32 scalar).  The
    expert counts are a one-hot sum, not ``bincount``, which reads the
    indices' range back to the host on CUDA."""
    me = probs.mean(dim=0)                                  # (E,)
    ce = F.one_hot(top_e.reshape(-1), n_experts).sum(0).to(
        torch.float32) / top_e.numel()
    return n_experts * torch.sum(me * ce)
