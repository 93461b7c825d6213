"""Mixture-of-Experts FFN with capacity-bucketed, sort-free dispatch (port
of ``repro.models.moe``, its ``global`` dispatch — the one the faulted
path takes).

Routing is a top-k softmax over the router's logits; the router matmul is
the faultable ``router`` operator domain.  Each (token, slot) pair gets a
position in its expert's queue from an int32 one-hot cumsum, is scattered
into an ``(E, C + 1, d)`` buffer (row ``C`` takes the overflow and is
dropped), runs through its expert's FFN, and is gathered back and combined
with the renormalised router weights.  Under a lane config every lane is
dispatched on its own (its capacity, queue positions and overflow row), as
the reference's ``vmap`` over fleet lanes does.  Dropped tokens fall back
to the residual path.  The expert FFNs are clean batched matmuls: the
reference computes them outside every fault hook, and so does the port.
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
              with_aux: bool = True, lanes: Optional[int] = None):
    """x: (B, S, d) -> ``((B, S, d), aux load-balance loss)``; the loss is
    ``None`` when ``with_aux`` is false (decode, which discards it).

    With ``lanes=N`` (taken from ``fi.lanes`` when not given) ``x`` is
    ``(N * B, S, d)``, N devices' batches folded lane-major, and each lane
    is dispatched as the reference's ``jax.vmap`` dispatches it alone: its
    capacity counts its own ``B * S`` tokens, its queue positions come
    from a cumsum over its own pairs, and its overflow row is its own.
    The router (and arctic's dense residual MLP) run on the lane GEMM; the
    expert FFNs run as one ``bmm`` chain over all lanes' rows, ``(E, N *
    C, d)``, so the expert weights are read once a forward.  The aux loss
    is then ``(N,)``, each lane's single-device loss.
    """
    if lanes is None and fi is not None:
        lanes = fi.lanes
    N = lanes or 1
    NB, S, d = x.shape
    if NB % N:
        raise ValueError(f"batch {NB} does not fold {N} lanes")
    T = NB // N * S                                         # one lane's tokens
    E, K = moe.n_experts, moe.top_k
    C = _capacity(T, moe)
    xf = x.reshape(N * T, d)

    logits = op_linear(xf, p["w_router"].to(x.dtype), "router", fi, salt)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    # lax.top_k's order: ties (an upset router saturates the softmax to
    # exact 0s and 1s) go to the lower expert index, which a stable
    # descending sort gives and torch.topk does not promise
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]               # (N*T, K)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    aux = None
    if with_aux:
        aux = aux_load_balance_loss(probs.reshape(N, T, E),
                                    top_e.reshape(N, T, K), E)
        aux = aux if lanes else aux[0]

    # position of each (token, slot) in its lane's expert queue; row-major
    # flattening keeps token order with the slots interleaved
    flat_e = top_e.reshape(N, T * K)
    onehot = F.one_hot(flat_e, E).to(torch.int32)           # (N, T*K, E)
    pos_all = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(pos_all, 2, flat_e[..., None])[..., 0]
    keep = pos < C
    safe_pos = torch.where(keep, pos, C)                    # C = overflow row

    # scatter into the (N, E, C+1, d) buffer.  Kept pairs have distinct
    # (lane, expert, position) slots, so only the overflow rows see
    # duplicate writes; CUDA's scatter picks one of them in no fixed order,
    # which is harmless because those rows are dropped here.
    lane = torch.arange(N, device=x.device)[:, None].expand(N, T * K)
    xrep = torch.repeat_interleave(xf, K, dim=0).reshape(N, T * K, d)
    buf = torch.zeros((N, E, C + 1, d), dtype=x.dtype, device=x.device)
    buf[lane, flat_e, safe_pos] = xrep
    # every lane's rows of one expert side by side: (E, N*C, d)
    buf = buf[:, :, :C].transpose(0, 1).reshape(E, N * C, d)

    # expert FFN: (E, N*C, d) @ (E, d, f), clean as in the reference
    if variant == "gated":
        h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    else:
        h = F.gelu(torch.bmm(buf, p["w_up"]), approximate="tanh")
    out_buf = torch.bmm(h, p["w_down"]).reshape(E, N, C, d).transpose(0, 1)

    # gather back (a dropped pair reads row C - 1, as jax clamps an
    # out-of-range gather, and is zeroed) and combine with router weights
    out_tok = out_buf[lane, flat_e, torch.clamp_max(safe_pos, C - 1)]
    out_tok = torch.where(keep[..., None], out_tok, 0.0)
    w = top_p.reshape(N, T * K, 1).to(x.dtype)
    out = (out_tok * w).reshape(N * T, K, d).sum(dim=1)

    if moe.dense_residual:
        out = out + mlp_apply(xf, p["dense"], variant, fi, salt)
    return out.reshape(NB, S, d), aux


def aux_load_balance_loss(probs: torch.Tensor, top_e: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (float32): ``probs (...,
    T, E)`` and ``top_e (..., T, K)`` give one loss per leading index (a
    scalar for 2-D inputs).  The expert counts are a one-hot sum, not
    ``bincount``, which reads the indices' range back to the host on
    CUDA."""
    me = probs.mean(dim=-2)                                 # (..., E)
    lead = top_e.shape[:-2]
    counts = F.one_hot(top_e.reshape(*lead, -1), n_experts).sum(-2)
    ce = counts.to(torch.float32) / (top_e.shape[-2] * top_e.shape[-1])
    return n_experts * torch.sum(me * ce, dim=-1)
