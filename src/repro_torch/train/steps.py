"""Train steps (port of ``repro.train.steps``): the train state,
the loss, and a step with microbatch gradient accumulation and per-block
remat.

Gradients come from ``torch.autograd``.  A step marks the params as
requiring gradients only while it runs, sums the microbatches' gradients
in float32 in microbatch order, as the reference's ``lax.scan`` adds them
onto float32 zeros (in the params' ``.grad`` for float32 params, in
float32 buffers for the others), divides by the count and hands them to :func:`repro_torch.optim.adamw_update`, which
updates params and moments in place.

:func:`make_dp_train_step` is the reference's explicit data-parallel step
over the ranks of a ``torch.distributed`` group
(:class:`repro_torch.launch.mesh.LogicalMesh`): each rank takes its rows of
the global batch, and the ranks average their gradients with the int8
error-feedback mean (:mod:`repro_torch.distributed.collectives`) or the
plain one before the same AdamW update on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..configs import ModelConfig
from ..device import resolve_device, true_div
from ..distributed import collectives
from ..distributed.sharding import _dp, _tp
from ..models import family
from ..models import transformer as tf
from ..optim import AdamWConfig, OptState, adamw_init, adamw_update
from ..tree import leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    residuals: Optional[Any] = None      # error-feedback state (DP)


def init_train_state(cfg: ModelConfig, seed: int = 0, *,
                     dtype=torch.float32, device="cuda",
                     compressed: bool = False) -> TrainState:
    """Random params of the config's family from ``seed``
    (:func:`repro_torch.models.family.init_params`) and a fresh optimizer
    state on ``device``; ``compressed`` adds zero error-feedback
    residuals."""
    params = family.init_params(cfg, seed, dtype,
                                device=resolve_device(device))
    return TrainState(params=params, opt=adamw_init(params),
                      residuals=collectives.zeros_residuals(params)
                      if compressed else None)


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
        tf.refuse_quantized(params, "training")
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
        tf.refuse_quantized(params, "training")
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


def make_dp_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh, *,
                       compress: bool = True, remat: bool = False,
                       aux_weight: float = 0.01) -> Callable:
    """The explicit data-parallel step over ``mesh``'s group:
    ``(state, global batch) -> (state, metrics)`` on every rank.

    Rank ``r`` of ``n`` takes rows ``[r B / n, (r + 1) B / n)`` of the
    global batch (the split ``shard_map``'s ``P(axes)`` makes), the
    gradients of the loss on them, and their mean over the group:
    :func:`~repro_torch.distributed.collectives.tree_psum_compressed` with
    this rank's residuals (``state.residuals``, updated in place), or the
    plain :func:`~repro_torch.distributed.collectives.tree_psum`.  The
    metrics are averaged over the group; AdamW then makes the same update
    on every rank, so the replicated params stay equal.  The mean runs
    under the profiler range ``dp_grad_mean``."""
    if mesh is None or mesh.group is None:
        raise ValueError("make_dp_train_step needs a mesh over a started "
                         "process group (repro_torch.launch.mesh."
                         "init_data_group)")
    if _tp(mesh) != 1:
        raise NotImplementedError(
            f"a model axis of {_tp(mesh)} over ranks is tensor-parallel "
            f"training: ROADMAP A.8c")
    loss_fn = make_loss_fn(cfg, remat=remat, aux_weight=aux_weight)
    n, rank, group = _dp(mesh), mesh.rank, mesh.group

    def train_step(state: TrainState, batch):
        if compress and state.residuals is None:
            raise ValueError("a compressed step needs residuals "
                             "(dp_residuals_init)")
        params = state.params
        tf.refuse_quantized(params, "training")
        ps = leaves(params)
        batch = _to_device(batch, ps[0].device)
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"global batch {B} does not split over {n} "
                             f"ranks")
        per = B // n
        local = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
        for p in ps:
            p.grad = None
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, m = loss_fn(params, local)
                loss.backward()
        finally:
            for p in ps:
                p.requires_grad_(False)
        with torch.no_grad(), torch.profiler.record_function("dp_grad_mean"):
            grads = grads_of(params)
            if compress:
                grads, res = collectives.tree_psum_compressed(
                    grads, state.residuals, group,
                    period=len(cfg.block_pattern))
            else:
                grads, res = collectives.tree_psum(grads, group), \
                    state.residuals
            names = list(m)
            mets = torch.stack([m[k].detach().to(torch.float32)
                                for k in names])
            torch.distributed.all_reduce(mets, group=group)
            mets = true_div(mets, float(n))
        metrics = dict(zip(names, mets.unbind(0)))
        new_params, new_opt, opt_m = adamw_update(
            grads, state.opt, params, opt_cfg,
            period=len(cfg.block_pattern))
        for p in ps:
            p.grad = None
        return (TrainState(new_params, new_opt, res),
                dict(metrics, **opt_m))

    return train_step


def dp_residuals_init(params, mesh):
    """This rank's error-feedback residuals: float32 zeros shaped like the
    params.  The reference keeps one copy a data shard on a leading
    ``(n, ...)`` axis; a rank of ``mesh``'s group holds its own slice."""
    if _tp(mesh) != 1:
        raise NotImplementedError("a model axis over ranks is "
                                  "tensor-parallel training: ROADMAP A.8c")
    return collectives.zeros_residuals(params)
