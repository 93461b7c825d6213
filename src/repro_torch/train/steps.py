"""Train steps (port of ``repro.train.steps``): the train state,
the loss, and a step with microbatch gradient accumulation and per-block
remat.

Gradients come from ``torch.autograd``.  A step marks the params as
requiring gradients only while it runs, sums the microbatches' gradients
in float32 in microbatch order, as the reference's ``lax.scan`` adds them
onto float32 zeros (in the params' ``.grad`` for float32 params, in
float32 buffers for the others), divides by the count and hands them to :func:`repro_torch.optim.adamw_update`, which
updates params and moments in place.

``make_train_step(mesh=)`` is the same step over the ranks of a
:func:`repro_torch.launch.mesh.make_local_mesh` mesh ``(dp, tp)``: the
reference's ``"train"`` layout, which its launcher places over a
``("data", "model")`` mesh and GSPMD partitions.  Each rank holds its
blocks of the state (:func:`init_train_state` or
:func:`shard_train_state`; :func:`gather_train_state` makes it whole
again, on one rank's host), each data replica takes its rows of the
global batch, the forward and backward run under
:func:`repro_torch.distributed.sharding.train_mesh_scope` (collectives
that autograd differentiates through), each gradient is averaged over
the ranks that hold the same shard, and AdamW clips by the norm over
blocks.  The dense decoder family only: the others refuse a model axis
(ROADMAP A.8c(c)).

:func:`make_dp_train_step` is the reference's explicit data-parallel step
over the ranks of a ``torch.distributed`` group
(:class:`repro_torch.launch.mesh.LogicalMesh`): each rank takes its rows of
the global batch, and the ranks average their gradients with the int8
error-feedback mean (:mod:`repro_torch.distributed.collectives`) or the
plain one before the same AdamW update on every rank.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..configs import ModelConfig
from ..device import resolve_device, true_div
from ..distributed import collectives
from ..distributed import sharding as shrules
from ..distributed.sharding import _dp, _tp
from ..launch.mesh import A8C_B
from ..models import family
from ..models import transformer as tf
from ..optim import AdamWConfig, OptState, adamw_init, adamw_update
from ..tree import leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    residuals: Optional[Any] = None      # error-feedback state (DP)


def _over_ranks(mesh) -> bool:
    """A mesh whose model axis above 1 spans the ranks of a group."""
    return getattr(mesh, "model_group", None) is not None


def check_tp_family(cfg: ModelConfig, tp: int) -> None:
    """Tensor-parallel training covers the dense decoder family (every
    fallback of the train layout); a model axis above 1 for another
    family raises."""
    if tp > 1 and (cfg.family != "dense" or cfg.moe or cfg.n_encoder_layers
                   or cfg.prefix_tokens or cfg.block_pattern != ("attn",)):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) over a model axis of {tp} ranks: "
            f"tensor-parallel training of the non-dense families is "
            f"ROADMAP A.8c(c)")


def init_train_state(cfg: ModelConfig, seed: int = 0, *,
                     dtype=torch.float32, device="cuda",
                     compressed: bool = False, mesh=None) -> TrainState:
    """Random params of the config's family from ``seed``
    (:func:`repro_torch.models.family.init_params`) and a fresh optimizer
    state on ``device``; ``compressed`` adds zero error-feedback
    residuals.  On a ``mesh`` whose model axis spans ranks, each leaf is
    cut to this rank's block of the train layout as soon as it is drawn
    (the draws are the same), so no rank holds the whole tree, and the
    moments mirror the blocks."""
    place = None
    if _over_ranks(mesh):
        check_tp_family(cfg, _tp(mesh))
        if compressed:
            raise NotImplementedError("compressed training with a model "
                                      f"axis: {A8C_B}")
        place = lambda tree: shrules.shard_tree(tree, shrules.param_specs(
            tree, cfg, mesh, layout="train"), mesh)
    params = family.init_params(cfg, seed, dtype,
                                device=resolve_device(device), place=place)
    return TrainState(params=params, opt=adamw_init(params),
                      residuals=collectives.zeros_residuals(params)
                      if compressed else None)


def shard_train_state(state: TrainState, cfg: ModelConfig,
                      mesh) -> TrainState:
    """This rank's blocks of a whole train state (params and both
    moments, e.g. from :func:`repro_torch.convert.params_from_reference`
    or :func:`init_train_state`) under the train layout of ``mesh``: each
    leaf the layout splits over ``"model"`` becomes a
    :class:`~repro_torch.distributed.sharding.RankBlock` of a copy, every
    other leaf stays whole.  The state as it is on a mesh without a model
    axis over ranks."""
    if not _over_ranks(mesh):
        return state
    check_tp_family(cfg, _tp(mesh))
    if state.residuals is not None:
        raise NotImplementedError(f"error-feedback residuals with a model "
                                  f"axis: {A8C_B}")
    specs = shrules.param_specs(state.params, cfg, mesh, layout="train")
    cut = lambda tree: shrules.shard_tree(tree, specs, mesh)
    return TrainState(cut(state.params), OptState(
        cut(state.opt.mu), cut(state.opt.nu), state.opt.step), None)


def gather_tree(tree, mesh):
    """A tree of this rank's blocks made whole on the host of shard 0:
    each block gathered over ``mesh``'s model group (the blocks in shard
    order, :func:`~repro_torch.distributed.collectives.gather_cat`), every
    other leaf as it is; the other ranks get ``None`` leaves.  Every rank
    of the model group calls this.  The tree as it is on a mesh without a
    model axis over ranks."""
    if not _over_ranks(mesh):
        return tree
    mine = mesh.shard == 0

    def whole(x):
        if isinstance(x, shrules.RankBlock):
            return collectives.gather_cat(x.data, x.dim, mesh.model_group)
        return x if mine else None

    return tree_map(whole, tree)


def gather_train_state(state: TrainState, mesh) -> TrainState:
    """:func:`gather_tree` of a block state's params and moments."""
    g = lambda tree: gather_tree(tree, mesh)
    return TrainState(g(state.params), OptState(
        g(state.opt.mu), g(state.opt.nu), state.opt.step), state.residuals)


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
                    mesh=None, microbatches: int = 1, remat: bool = False,
                    aux_weight: float = 0.01) -> Callable:
    """``(state, batch) -> (state, metrics)``: loss and gradients of each
    microbatch, their float32 mean, one AdamW update.  The metrics are
    the microbatches' mean ``loss``/``xent``/``aux`` and the update's
    ``grad_norm`` and ``lr``, all device tensors.

    ``mesh``: a mesh over the ranks of a started group
    (:func:`repro_torch.launch.mesh.make_local_mesh`), on which every
    rank calls the step with the same global batch and its own state.
    Replica ``r`` of ``dp`` takes rows ``[r B / dp, (r + 1) B / dp)``
    (split into the microbatches); with a model axis above 1 the state
    holds this rank's blocks and the forward and backward run under
    :func:`~repro_torch.distributed.sharding.train_mesh_scope`, and
    under remat each block's recompute runs its collectives again, in
    the same order on every rank.  Each gradient is then the plain mean
    over the data group (the ranks of this rank's shard), the metrics are
    averaged over it, and the clip norm sums the blocks over the model
    group, so the metrics and the clip scale are the same on every rank.
    No mesh, or one without a group, is one device."""
    loss_fn = make_loss_fn(cfg, remat=remat, aux_weight=aux_weight)
    ranked = mesh is not None and mesh.group is not None
    tp, dp = (_tp(mesh), _dp(mesh)) if ranked else (1, 1)
    check_tp_family(cfg, tp)
    if tp > 1 and not (_over_ranks(mesh) and mesh.data_group is not None):
        raise ValueError("a model axis over ranks needs the mesh's model and "
                         "data groups (repro_torch.launch.mesh."
                         "make_local_mesh)")
    replica = mesh.replica if ranked else 0
    data_group = (mesh.group if tp == 1 else mesh.data_group) \
        if ranked else None
    model_group = mesh.model_group if tp > 1 else None
    scope = (lambda: shrules.train_mesh_scope(mesh)) if tp > 1 \
        else contextlib.nullcontext

    def train_step(state: TrainState, batch):
        params = state.params
        tf.refuse_quantized(params, "training")
        ps = [shrules.held(p) for p in leaves(params)]
        batch = _to_device(batch, ps[0].device)
        B = batch["tokens"].shape[0]
        if B % (dp * microbatches):
            raise ValueError(f"batch {B} does not split into {dp} replicas "
                             f"of {microbatches} microbatches")
        rows = B // dp
        batch = {k: v[replica * rows:(replica + 1) * rows]
                 for k, v in batch.items()}
        for p in ps:
            p.grad = None
            p.requires_grad_(True)
        # float32 sums of the non-float32 params' microbatch gradients
        acc = {}
        try:
            per = rows // microbatches
            mets = []
            for i in range(microbatches):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                with torch.enable_grad(), scope():
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
                    shrules.held(g).div_(microbatches)
            metrics = mets[0] if microbatches == 1 else {
                k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
            if dp > 1:
                with torch.profiler.record_function("dp_grad_mean"):
                    grads = collectives.tree_psum(grads, data_group)
                    metrics = _group_mean(metrics, data_group)
        new_params, new_opt, opt_m = adamw_update(
            grads, state.opt, params, opt_cfg,
            period=len(cfg.block_pattern), group=model_group)
        for p in ps:
            p.grad = None
        return (TrainState(new_params, new_opt, state.residuals),
                dict(metrics, **opt_m))

    return train_step


def _group_mean(metrics, group):
    """The metrics (0-d tensors) averaged over ``group`` in float32: one
    all-reduce of their stack ("grad_mean"), the same on every rank."""
    names = list(metrics)
    total = collectives.all_reduce_sum(torch.stack(
        [metrics[k].detach().to(torch.float32) for k in names]), group,
        "grad_mean")
    mean = true_div(total, float(torch.distributed.get_world_size(group)))
    return dict(zip(names, mean.unbind(0)))


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
    loss did not reach); a rank block's gradient is a block of the same
    part."""
    sums = sums or {}

    def grad(p):
        if id(p) in sums:
            return sums[id(p)]
        return p.grad if p.grad is not None else torch.zeros_like(p)

    return tree_map(lambda p: grad(p) if isinstance(p, torch.Tensor)
                    else p.map(grad), params)


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
    plain :func:`~repro_torch.distributed.collectives.tree_psum`
    (``compress=False``: :func:`make_train_step` over ``mesh``, whose mean
    over the data group is that).  The metrics are averaged over the
    group; AdamW then makes the same update on every rank, so the
    replicated params stay equal.  The mean runs under the profiler range
    ``dp_grad_mean``."""
    if mesh is None or mesh.group is None:
        raise ValueError("make_dp_train_step needs a mesh over a started "
                         "process group (repro_torch.launch.mesh."
                         "init_data_group)")
    if _tp(mesh) != 1:
        raise NotImplementedError(
            f"the explicit data-parallel step with a model axis of "
            f"{_tp(mesh)} ranks: {A8C_B}")
    if not compress:
        return make_train_step(cfg, opt_cfg, mesh=mesh, remat=remat,
                               aux_weight=aux_weight)
    loss_fn = make_loss_fn(cfg, remat=remat, aux_weight=aux_weight)
    n, rank, group = _dp(mesh), mesh.rank, mesh.group

    def train_step(state: TrainState, batch):
        if state.residuals is None:
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
            grads, res = collectives.tree_psum_compressed(
                grads_of(params), state.residuals, group,
                period=len(cfg.block_pattern))
            metrics = _group_mean(m, group)
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
        raise NotImplementedError("error-feedback residuals with a model "
                                  f"axis: {A8C_B}")
    return collectives.zeros_residuals(params)
