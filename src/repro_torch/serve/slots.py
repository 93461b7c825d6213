"""Slot state of continuous-batching online serving (port of
``repro.serve.slots``).

A :class:`SlotState` is the whole in-flight batch of an online engine:
``K`` fixed slots, each holding one live request's ragged KV cache row,
its decode depth, its sampled-token buffer and its completion flags, as
tensors on the serving device.  Two plain functions advance it:

* :func:`refill` — refill freed slots from the host queue: prefill the
  whole ``(K, S)`` prompt matrix (zero rows where no slot is refilled) in
  one forward and merge only the refilled rows into the live state
  (``torch.where`` into fresh tensors, so no state aliases another);
* :func:`decode_chunk` — ``chunk_steps`` decode steps in a host loop, in
  which every slot advances at its own depth (a ``(K,)`` ``cache_len``,
  :func:`repro_torch.models.transformer.decode_step`), samples, and
  retires itself on EOS or an exhausted budget through per-slot masks.
  Retired and empty slots still run through every matmul (the batch shape
  is fixed: the fault streams index words by their place in the whole
  batch, and an MoE layer's capacity counts every row); their state is
  frozen by the masks and their garbage never crosses rows.

The global decode step and the sampling key stay on the host (a Python
int and the port's threefry key), so ``fi.for_step(t)`` and the per-step
key splits cost no device work; ``active``, ``done``, ``cache_len``,
``n_generated`` and the token scatter stay on the device, and a chunk
makes no host-device synchronisation.

With ``lanes=N`` the slots of N fleet lanes fold lane-major into ``N * K``
rows: one forward a step for the whole fleet, a lane :class:`FaultConfig`,
``(N, 2)`` keys (one sampling chain per lane), and taps of ``(N,)``.

Bit-exactness contract (as the reference's): with all ``K`` slots filled
once at step 0 and no EOS, the first refill plus chunked decode gives
:func:`repro_torch.serve.steps.generate`'s tokens — the same key chain
(one split a refill and a step), the same fault-stream steps, and an
all-equal ``cache_len`` masks as the int does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..configs import ModelConfig
from ..models import transformer as tf
from ..models.layers import FaultConfig
from ..obs.taps import Telemetry, logit_taps
from . import steps

# request_id of an empty (never filled / harvested) slot
EMPTY = -1


@dataclasses.dataclass(frozen=True)
class SlotState:
    """K in-flight request slots (``N * K`` rows for N lanes).

    ``cache`` is the model's per-layer decode state with the slot axis as
    its batch axis (axis 0 of every leaf: attention K/V rings, RG-LRU
    conv tails and ``h``, RWKV shifts and WKV states).  ``cache_len``
    counts the tokens in each slot's cache row (prompt + generated so
    far); ``tokens`` buffers each slot's generated ids at ``[slot,
    0:n_generated]``; ``key`` is the sampling chain (``(2,)``, or
    ``(N, 2)`` for N lanes), split once a refill and once a decode step;
    ``step`` the global decode step every fault stream folds in.
    """

    cache: List                  # per-layer decode state, slot-batched
    cache_len: torch.Tensor      # (K,) int64 tokens in each slot's cache
    last_tok: torch.Tensor       # (K,) int32 next decode input per slot
    active: torch.Tensor         # (K,) bool: the slot is mid-generation
    request_id: torch.Tensor     # (K,) int32 live request id (EMPTY: free)
    n_generated: torch.Tensor    # (K,) int32 tokens emitted per slot
    max_new: torch.Tensor        # (K,) int32 per-request budget
    tokens: torch.Tensor         # (K, C) int32 generated-token buffer
    key: torch.Tensor            # host sampling key(s)
    step: int                    # global decode-step counter (host)

    @property
    def n_slots(self) -> int:
        return int(self.cache_len.shape[-1])

    def replace(self, **kw) -> "SlotState":
        return dataclasses.replace(self, **kw)


def check_family(cfg: ModelConfig) -> None:
    """Online slots serve decoder-only families, as the reference's: an
    enc-dec model's frames and a VLM's prefix are per-request payloads the
    fixed-slot refill does not carry."""
    if cfg.n_encoder_layers or cfg.prefix_tokens:
        raise ValueError(
            f"{cfg.name}: online slot serving covers decoder-only families "
            "(the enc-dec / prefix extras are per-request payloads the "
            "fixed-slot refill does not carry); use the static-batch "
            "engines instead")


def init_slots(cfg: ModelConfig, n_slots: int, max_len: int,
               max_new_cap: int, key: torch.Tensor, *, dtype,
               device) -> SlotState:
    """All-free slot state: every slot empty, caches zeroed (in ``dtype``,
    the params' dtype, as the prefill's cache)."""
    check_family(cfg)
    K = int(n_slots)
    zeros = lambda dt: torch.zeros((K,), dtype=dt, device=device)
    return SlotState(
        cache=tf.init_cache(cfg, K, max_len, dtype=dtype, device=device),
        cache_len=zeros(torch.int64), last_tok=zeros(torch.int32),
        active=zeros(torch.bool),
        request_id=torch.full((K,), EMPTY, dtype=torch.int32,
                              device=device),
        n_generated=zeros(torch.int32), max_new=zeros(torch.int32),
        tokens=torch.zeros((K, int(max_new_cap)), dtype=torch.int32,
                           device=device),
        key=key, step=0)


def _merge_cache(refill: torch.Tensor, new_cache, old_cache):
    """``torch.where`` the refilled rows of ``new_cache`` into fresh copies
    of ``old_cache``'s leaves; the slot axis is axis 0 of every leaf."""
    def merge(new, old):
        if isinstance(new, dict):
            return {k: merge(new[k], old[k]) for k in new}
        mask = refill.reshape((-1,) + (1,) * (new.dim() - 1))
        return torch.where(mask, new, old)
    return [merge(n, o) for n, o in zip(new_cache, old_cache)]


# --------------------------------------------------------------------------- #
# refill: batched prompt prefill merged into freed slots
# --------------------------------------------------------------------------- #
@torch.no_grad()
def refill(params, cfg: ModelConfig, slots: SlotState, prompts, refill_mask,
           request_id, max_new, fi: Optional[FaultConfig], *,
           temperature: float, eos: int, max_len: int,
           top_k: Optional[int] = None,
           lanes: Optional[int] = None) -> SlotState:
    """Prefill the full ``(K, S)`` ``prompts`` (rows of slots not refilled
    are padding) at the fault streams of step ``slots.step``, sample each
    row's first token with one key split (one per lane), and merge only the
    ``refill_mask`` rows into ``slots``.  ``request_id`` / ``max_new`` are
    ``(K,)``; budgets clip to ``[1, C]``.  A request whose first token is
    ``eos``, or whose budget is one token, completes here."""
    S = prompts.shape[1]
    if fi is not None:
        fi = fi.with_seeds()
    logits, new_cache = steps.prefill(
        params, cfg, prompts, None if fi is None else fi.for_step(slots.step),
        max_len)
    key, sub = steps._split_keys(slots.key, lanes)
    tok0 = steps.sample_token(logits, sub, temperature, top_k, lanes=lanes)
    mask = refill_mask.to(torch.bool)
    C = slots.tokens.shape[1]
    max_new = torch.clamp(max_new.to(torch.int32), 1, C)
    done0 = (tok0 == eos) | (max_new <= 1)           # one-token requests
    row0 = torch.zeros_like(slots.tokens)
    row0[:, 0] = tok0
    return slots.replace(
        cache=_merge_cache(mask, new_cache, slots.cache),
        cache_len=torch.where(mask, S, slots.cache_len),
        last_tok=torch.where(mask, tok0, slots.last_tok),
        active=torch.where(mask, ~done0, slots.active),
        request_id=torch.where(mask, request_id.to(torch.int32),
                               slots.request_id),
        n_generated=torch.where(mask, 1, slots.n_generated).to(torch.int32),
        max_new=torch.where(mask, max_new, slots.max_new),
        tokens=torch.where(mask[:, None], row0, slots.tokens),
        key=key)


# --------------------------------------------------------------------------- #
# chunked decode: every slot advances at its own depth
# --------------------------------------------------------------------------- #
@torch.no_grad()
def decode_chunk(params, cfg: ModelConfig, slots: SlotState,
                 fi: Optional[FaultConfig], *, chunk_steps: int,
                 temperature: float, eos: int,
                 top_k: Optional[int] = None, lanes: Optional[int] = None
                 ) -> Tuple[SlotState, torch.Tensor, Telemetry]:
    """``chunk_steps`` decode steps of every slot.

    Returns ``(slots, active_trace, telemetry)``: ``active_trace`` is the
    ``(chunk_steps, K)`` occupancy on the device (which slots served each
    step: the duty cycle the aging replay reads), ``telemetry`` the
    per-step logit taps over the live slots, ``(chunk_steps,)`` each, or
    ``(N, chunk_steps)`` with lanes.  The cache is written in place."""
    if fi is not None:
        fi = fi.with_seeds()
    C = slots.tokens.shape[1]
    rows = torch.arange(slots.tokens.shape[0], device=slots.tokens.device)
    trace, taps = [], []
    s = slots
    for _ in range(chunk_steps):
        active0 = s.active
        cl = s.cache_len + 1            # per-slot depth incl. this token
        t = s.step + 1                  # global decode-step index
        logits, cache = steps.decode(params, cfg, s.last_tok[:, None],
                                     s.cache, cl,
                                     None if fi is None else fi.for_step(t))
        key, sub = steps._split_keys(s.key, lanes)
        tok = steps.sample_token(logits, sub, temperature, top_k,
                                 lanes=lanes)
        ngen = s.n_generated + 1
        done = (tok == eos) | (ngen >= s.max_new)
        col = torch.clamp(s.n_generated, 0, C - 1).to(torch.int64)
        tokens = s.tokens.clone()
        tokens[rows, col] = torch.where(active0, tok, s.tokens[rows, col])
        s = s.replace(cache=cache,
                      cache_len=torch.where(active0, cl, s.cache_len),
                      last_tok=torch.where(active0, tok, s.last_tok),
                      active=active0 & ~done,
                      n_generated=torch.where(active0, ngen, s.n_generated),
                      tokens=tokens, key=key, step=t)
        trace.append(active0)
        taps.append(logit_taps(logits, lanes, active=active0))
    series = {k: torch.stack([tp[k] for tp in taps], dim=-1)
              for k in taps[0]}
    return s, torch.stack(trace), Telemetry(series)
