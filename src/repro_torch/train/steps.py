"""Train steps (port of ``repro.train.steps``): the train state,
the loss, and a step with microbatch gradient accumulation and per-block
remat.

Gradients come from ``torch.autograd``.  A step marks the params as
requiring gradients only while it runs, sums the microbatches' gradients
in float32 in microbatch order, as the reference's ``lax.scan`` adds them
onto float32 zeros (in the params' ``.grad`` for float32 params, in
float32 buffers for the others), divides by the count and hands them to :func:`repro_torch.optim.adamw_update`, which
updates params and moments in place.  The data-parallel step with
compressed residuals waits for the distributed layer (ROADMAP A.8).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..configs import ModelConfig
from ..device import resolve_device
from ..models import family
from ..models import transformer as tf
from ..optim import AdamWConfig, OptState, adamw_init, adamw_update
from ..tree import leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    residuals: Optional[Any] = None      # error-feedback state (DP; A.8)


def init_train_state(cfg: ModelConfig, seed: int = 0, *,
                     dtype=torch.float32, device="cuda",
                     compressed: bool = False) -> TrainState:
    """Random params of the config's family from ``seed``
    (:func:`repro_torch.models.family.init_params`) and a fresh optimizer
    state on ``device``."""
    if compressed:
        raise NotImplementedError(
            "compressed data-parallel residuals are not ported (ROADMAP "
            "A.8)")
    params = family.init_params(cfg, seed, dtype,
                                device=resolve_device(device))
    return TrainState(params=params, opt=adamw_init(params))


# --------------------------------------------------------------------------- #
# loss
# --------------------------------------------------------------------------- #
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy.  logits (B, S, V) float32, labels
    (B, S) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(logz - gold)


def make_loss_fn(cfg: ModelConfig, *, remat: bool = False,
                 aux_weight: float = 0.01) -> Callable:
    """``(params, batch) -> (loss, {"loss", "xent", "aux"})``; batch keys
    ``tokens`` and ``labels`` (tensors on the params' device), and
    ``frames`` for an enc-dec model or ``prefix_embeds`` for a VLM (whose
    prefix logits are dropped).  ``aux`` is the MoE load-balance loss
    :func:`forward_logits` returns (0 for other models); it reaches the
    router's softmax in the backward pass."""
    tf.check_supported(cfg)

    def loss_fn(params, batch):
        name = family.extra_name(cfg)
        extra = {name: batch[name]} if name else {}
        logits, aux = family.text_logits(params, cfg, batch["tokens"],
                                         remat=remat, **extra)
        xent = softmax_xent(logits, batch["labels"])
        loss = xent + aux_weight * aux
        return loss, {"loss": loss, "xent": xent, "aux": aux}

    return loss_fn


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, remat: bool = False,
                    aux_weight: float = 0.01) -> Callable:
    """``(state, batch) -> (state, metrics)``: loss and gradients of each
    microbatch, their float32 mean, one AdamW update.  The metrics are
    the microbatches' mean ``loss``/``xent``/``aux`` and the update's
    ``grad_norm`` and ``lr``, all device tensors."""
    loss_fn = make_loss_fn(cfg, remat=remat, aux_weight=aux_weight)

    def train_step(state: TrainState, batch):
        params = state.params
        ps = leaves(params)
        batch = _to_device(batch, ps[0].device)
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{microbatches} microbatches")
        for p in ps:
            p.grad = None
            p.requires_grad_(True)
        # float32 sums of the non-float32 params' microbatch gradients
        acc = {}
        try:
            per = B // microbatches
            mets = []
            for i in range(microbatches):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                with torch.enable_grad():
                    loss, m = loss_fn(params, mb)
                    loss.backward()
                mets.append({k: v.detach() for k, v in m.items()})
                if microbatches > 1:
                    _move_low_precision_grads(ps, acc)
        finally:
            for p in ps:
                p.requires_grad_(False)
        with torch.no_grad():
            grads = grads_of(params, acc)
            if microbatches > 1:
                for g in leaves(grads):
                    g.div_(microbatches)
        metrics = mets[0] if microbatches == 1 else {
            k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        new_params, new_opt, opt_m = adamw_update(
            grads, state.opt, params, opt_cfg,
            period=len(cfg.block_pattern))
        for p in ps:
            p.grad = None
        return (TrainState(new_params, new_opt, state.residuals),
                dict(metrics, **opt_m))

    return train_step


def _move_low_precision_grads(ps, acc):
    """Add each non-float32 param's ``.grad`` into its float32 sum in
    ``acc`` and clear it, so microbatch gradients add up in float32 as
    the reference's scan adds them onto float32 zeros."""
    for p in ps:
        if p.dtype != torch.float32 and p.grad is not None:
            g = p.grad.to(torch.float32)
            acc[id(p)] = acc[id(p)].add_(g) if id(p) in acc else g
            p.grad = None


def grads_of(params, sums=None):
    """The tree of the params' ``.grad`` tensors, or their float32 sums
    where ``sums`` holds one by the param's id (zeros for a param the
    loss did not reach)."""
    sums = sums or {}

    def grad(p):
        if id(p) in sums:
            return sums[id(p)]
        return p.grad if p.grad is not None else torch.zeros_like(p)

    return tree_map(grad, params)


def make_dp_train_step(*args, **kwargs):
    raise NotImplementedError(
        "the data-parallel step with compressed gradients is not ported "
        "(ROADMAP A.8)")


def dp_residuals_init(*args, **kwargs):
    raise NotImplementedError(
        "data-parallel error-feedback residuals are not ported (ROADMAP "
        "A.8)")
