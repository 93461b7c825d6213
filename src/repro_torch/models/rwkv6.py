"""RWKV6 (Finch) time-mix with data-dependent decay, chunked-parallel form
(port of ``repro.models.rwkv6``).

Per head (dim N) the matrix-valued state S (N x N) evolves as

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = (r_t)^T (S_{t-1} + diag(u) k_t v_t^T)

with per-channel decay ``w_t = exp(-exp(ww_t))`` from a clean LoRA of x_t,
clamped to a rate of at most 0.25 a step, and a bonus ``u`` for the
current token.  Prefill pads the sequence with zeros to a multiple of the
chunk (128) and runs the chunked linear-attention algorithm: the quadratic
form with decay masks inside a chunk, the state carried across chunks in
order (:data:`FORCE_SINGLE_CHUNK` makes the whole sequence one chunk).
Decode is the single-step update.  Token-shift mixers use the
static interpolation form, as in the reference.  The time-mix matmuls are
the ``q`` (r), ``k``, ``v``, ``g`` and ``o`` operator domains, the channel
mix ``up`` and ``down``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import FaultConfig, _normal, op_linear

DECAY_LORA = 64

# The reference's cost-probe knob: the whole prefill as one chunk.
FORCE_SINGLE_CHUNK = False


def rwkv_time_mix_init(d: int, hd: int, dtype, device, gen) -> Dict:
    s = d ** -0.5
    H = d // hd
    p = {name: _normal((d, d), s, dtype, device, gen)
         for name in ("w_r", "w_k", "w_v", "w_g", "w_o")}
    p["decay_base"] = torch.rand((d,), dtype=torch.float32, device=device,
                                 generator=gen) * 2.0 - 7.0
    p["decay_lora_a"] = _normal((d, DECAY_LORA), s, dtype, device, gen)
    p["decay_lora_b"] = _normal((DECAY_LORA, d), DECAY_LORA ** -0.5, dtype,
                                device, gen)
    p["bonus_u"] = _normal((H, hd), 0.1, torch.float32, device, gen)
    p["mix"] = torch.full((5, d), 0.5, dtype=dtype, device=device)
    return p


def rwkv_channel_mix_init(d: int, f: int, dtype, device, gen) -> Dict:
    return {"w_in": _normal((d, f), d ** -0.5, dtype, device, gen),
            "w_out": _normal((f, d), f ** -0.5, dtype, device, gen),
            "mix": torch.full((d,), 0.5, dtype=dtype, device=device)}


def _token_shift(x: torch.Tensor, x_prev1: torch.Tensor) -> torch.Tensor:
    """shifted(x)[t] = x[t-1]; the first step takes ``x_prev1`` (B, d)."""
    return torch.cat([x_prev1.to(x.dtype)[:, None], x[:, :-1]], dim=1)


def _chunked_wkv(r, k, v, w_log, u, chunk: int, s0):
    """Chunked linear attention with per-channel decay.

    r, k, v, w_log: (B, S, H, N) with S a multiple of ``chunk`` (w_log the
    log-decay, < 0); u: (H, N); s0: (B, H, N, N).  Returns
    (out (B, S, H, N), final state)."""
    B, S, H, N = r.shape
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)
    s = s0
    outs = []
    for c0 in range(0, S, chunk):
        rb, kb, vb = (t[:, c0:c0 + chunk] for t in (r, k, v))
        wb = w_log[:, c0:c0 + chunk].to(torch.float32)
        cum = torch.cumsum(wb, dim=1)              # inclusive decay sums
        total = cum[:, -1:]
        decay_in = torch.exp(cum - wb)             # exp(cum[t-1])
        o_inter = torch.einsum("bthn,bhnm->bthm", rb * decay_in, s)
        q_ = rb * decay_in
        k_ = kb * torch.exp(-cum)
        att = torch.einsum("bthn,bshn->bhts", q_, k_)
        att = torch.where(tri, att, 0.0)
        diag = (rb * u * kb).sum(dim=-1)
        o_intra = torch.einsum("bhts,bshn->bthn", att, vb) \
            + diag[..., None] * vb
        k_carry = kb * torch.exp(total - cum)
        s = torch.exp(total)[:, 0, :, :, None] * s \
            + torch.einsum("bshn,bshm->bhnm", k_carry, vb)
        outs.append(o_inter + o_intra)
    return torch.cat(outs, dim=1), s


def rwkv_time_mix(x, p, hd: int, *, state: Optional[Dict] = None,
                  chunk: int = 128, fi: Optional[FaultConfig] = None,
                  salt=0) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d).  state: {"shift": (B, d), "wkv": (B, H, N, N)}."""
    B, S, d = x.shape
    H = d // hd
    if FORCE_SINGLE_CHUNK:
        chunk = S
    xp = _token_shift(x, state["shift"] if state is not None
                      else torch.zeros((B, d), dtype=x.dtype,
                                       device=x.device))
    mix = p["mix"]
    mixed = [x * mix[i] + xp * (1 - mix[i]) for i in range(5)]
    r = op_linear(mixed[0], p["w_r"], "q", fi, salt).reshape(B, S, H, hd)
    k = op_linear(mixed[1], p["w_k"], "k", fi, salt).reshape(B, S, H, hd)
    v = op_linear(mixed[2], p["w_v"], "v", fi, salt).reshape(B, S, H, hd)
    g = F.silu(op_linear(mixed[3], p["w_g"], "g", fi, salt))
    ww = p["decay_base"] + torch.tanh(
        mixed[4] @ p["decay_lora_a"]) @ p["decay_lora_b"]
    w_log = -torch.clamp(torch.exp(ww.to(torch.float32)), 1e-6, 0.25) \
        .reshape(B, S, H, hd)

    s0 = state["wkv"] if state is not None else torch.zeros(
        (B, H, hd, hd), dtype=torch.float32, device=x.device)
    if S == 1 and state is not None:                    # decode
        rt, kt, vt = (t[:, 0].to(torch.float32) for t in (r, k, v))
        wt = torch.exp(w_log[:, 0])
        kv = kt[..., :, None] * vt[..., None, :]
        out = torch.einsum("bhn,bhnm->bhm", rt,
                           s0 + p["bonus_u"][None, :, :, None] * kv)
        s_fin = wt[..., None] * s0 + kv
        out = out.reshape(B, 1, d)
    else:
        rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
        pad = (-S) % chunk
        if pad:
            z = lambda t: F.pad(t, (0, 0, 0, 0, 0, pad))
            rf, kf, vf, w_log = z(rf), z(kf), z(vf), z(w_log)
        out, s_fin = _chunked_wkv(rf, kf, vf, w_log, p["bonus_u"],
                                  min(chunk, rf.shape[1]), s0)
        out = out[:, :S].reshape(B, S, d)
    out = op_linear(out.to(x.dtype) * g, p["w_o"], "o", fi, salt)
    new_state = ({"shift": x[:, -1], "wkv": s_fin}
                 if state is not None else None)
    return out, new_state


def rwkv_channel_mix(x, p, *, state: Optional[torch.Tensor] = None,
                     fi: Optional[FaultConfig] = None, salt=0):
    B, S, d = x.shape
    xp = _token_shift(x, state if state is not None
                      else torch.zeros((B, d), dtype=x.dtype,
                                       device=x.device))
    xm = x * p["mix"] + xp * (1 - p["mix"])
    h = torch.square(torch.relu(op_linear(xm, p["w_in"], "up", fi, salt)))
    out = op_linear(h, p["w_out"], "down", fi, salt)
    return out, (x[:, -1] if state is not None else None)


def rwkv_init_state(batch: int, d: int, hd: int, device) -> Dict:
    """Zero decode state: the shifts in bf16 (the reference's), the WKV
    state in float32."""
    H = d // hd
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return {"tm": {"shift": z((batch, d), torch.bfloat16),
                   "wkv": z((batch, H, hd, hd), torch.float32)},
            "cm_shift": z((batch, d), torch.bfloat16)}
