"""The int8 error-feedback gradient mean over a ``torch.distributed`` group
(port of ``repro.distributed.collectives``).

Each rank quantises ``g + residual`` of a leaf to int8 with its own absmax
scale, the ranks sum the int8 values in int32 and average their scales,
and the mean is ``qsum * smean / n``.  The part of the leaf the int8 value
did not carry, taken against the transmitted ``q * smean`` (not the local
``q * scale``), stays behind as the next step's residual, so the
compression bias vanishes over steps (Karimireddy et al., "Error Feedback
Fixes SignSGD").

A leaf is the reference's: the port keeps a decoder's layers as a list,
the reference stacks them, so the layers of one stack share one scale
(:func:`repro_torch.optim.adamw.ref_order_groups`).

What crosses the group: the int32 sums (4 bytes an element, which is
what makes the sum exact: ``n * 127`` fits in int32 for any group) and
one float32 scale a leaf a rank.  The reference's docstring counts 1 byte
an element, but its ``psum`` also sums int32.  The scales of every leaf
travel in one ``all_reduce`` (each in its rank's row) and are added in
rank order, so ``smean`` is the same on every rank and every backend.  The int32 payloads travel in
flat buckets of at most :data:`BUCKET_BYTES`; a leaf larger than that
spans several buckets.  Integer sums are exact in any order, so a bucketed
call equals one call a leaf bit for bit.

Where the reference takes ``axis_names`` inside a ``shard_map`` body, the
port takes the ``torch.distributed`` group of the mesh's data axis
(:class:`repro_torch.launch.mesh.LogicalMesh`'s ``group``); every call goes
through it, a group of one rank included.

Mesh serving over ranks (the serve layout's all-gathers, where the
reference lets GSPMD gather the output blocks it pins replicated) uses
:func:`all_gather_cat`: pure data movement, counted per call.

Tensor-parallel training over ranks (the train layout's blocks, where
the reference lets GSPMD insert the collectives and differentiate
through them) uses three collectives that autograd differentiates
through, each over the model group of a rank's data replica:
:func:`copy_to_model` (the identity forward, the all-reduce of the
gradient backward: the input of every product with a block),
:func:`reduce_from_model` (the all-reduce of partial sums forward, the
identity backward: the output of a product that contracts a block) and
:func:`gather_from_model` (:func:`all_gather_cat` forward, this rank's
slice of the gradient backward: the output of a column block).  Every
all-gather and all-reduce of these and of the train step is counted by
kind (:func:`collective_counts`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import true_div
from ..optim.adamw import ref_order_groups
from ..tree import leaves, tree_map

_F32 = torch.float32
# the int32 payload of one all_reduce: 64 M elements
BUCKET_BYTES = 256 * 2 ** 20


def quantize_int8_global(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-tensor symmetric absmax int8 quantisation -> ``(q, scale)``:
    ``scale = max(amax, 1e-30) / 127`` (float32, 0-d), ``q = clip(round(x
    / scale), -127, 127)`` rounded half to even."""
    scale = _scale([x])
    return _quantize(x, scale), scale


def _scale(xs: List[torch.Tensor]) -> torch.Tensor:
    """The absmax scale of the tensors of one leaf, taken together."""
    # the absmax without an |x| temporary (max is exact in any order)
    amax = torch.stack([torch.linalg.vector_norm(x, ord=float("inf"))
                        for x in xs]).max()
    return true_div(torch.clamp_min(amax, 1e-30), 127.0)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def zeros_residuals(params):
    """Initial error-feedback state of a param tree: float32 zeros."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                          device=p.device), params)


def _buckets(sizes: List[int], bucket_elems: int):
    """Cut the leaves' concatenated elements into buckets of at most
    ``bucket_elems``: each bucket a list of ``(leaf, start, stop)``."""
    out, cur, room = [], [], bucket_elems
    for i, n in enumerate(sizes):
        start = 0
        while start < n:
            take = min(room, n - start)
            cur.append((i, start, start + take))
            start += take
            room -= take
            if room == 0:
                out.append(cur)
                cur, room = [], bucket_elems
    if cur:
        out.append(cur)
    return out


def bucket_plan(tree, period: int = 1, bucket_bytes: int = BUCKET_BYTES
                ) -> dict:
    """What :func:`tree_psum_compressed` sends for ``tree``: the reference
    leaves, the buckets, the collectives (one ``all_reduce`` of the scales
    and one a bucket) and the bytes each rank sends (its payload, and its
    scales' row of the ``(n, leaves)`` scale tensor)."""
    sizes = [x.numel() for x in leaves(tree)]
    buckets = _buckets(sizes, max(1, bucket_bytes // 4))
    n_leaves = len(_leaf_groups(tree, period))
    return {"leaves": n_leaves, "buckets": len(buckets),
            "collectives": 1 + len(buckets),
            "payload_bytes": 4 * sum(sizes), "scale_bytes": 4 * n_leaves}


def mean_scale(scales: torch.Tensor, group) -> torch.Tensor:
    """The ranks' mean of their float32 ``scales`` (one a leaf), the same
    on every rank: each rank's scales land in its row of a zero ``(n,
    ...)`` tensor summed by one ``all_reduce`` (adding zeros is exact, and
    gloo reduces CUDA tensors where it gathers none), then the rows are
    added in rank order (as a sequential psum) and divided by ``n``."""
    n = dist.get_world_size(group)
    rows = torch.zeros((n,) + scales.shape, dtype=_F32, device=scales.device)
    rows[dist.get_rank(group)] = scales
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    total = rows[0]
    for row in rows[1:]:
        total = total + row
    return true_div(total, float(n))


def _leaf_groups(tree, period: int) -> List[List[torch.Tensor]]:
    """The tensors of each reference leaf: a decoder's ``layers`` list
    stacked as the reference stacks them (``ref_order_groups``), every
    other tensor alone."""
    if isinstance(tree, dict):
        return list(ref_order_groups(tree, period))
    return [[x] for x in leaves(tree)]


@torch.no_grad()
def _compressed_mean(ggroups, rgroups, group, bucket_bytes: int,
                     sums: Optional[list]):
    """The mean and new residual of each tensor, the tensors grouped by
    reference leaf (one scale a group): two lists in group order.

    Works in place: a float32 gradient's storage holds ``g + residual``
    and then the mean, and each residual tensor is overwritten by its new
    value; a gradient of another dtype gets a new mean tensor of its
    dtype."""
    n = dist.get_world_size(group)
    # g + r in float32 (in a float32 gradient's own storage)
    gf_groups = [[g.to(_F32).add_(r) for g, r in zip(gg, rg)]
                 for gg, rg in zip(ggroups, rgroups)]
    scales = torch.stack([_scale(gg) for gg in gf_groups])
    smean = mean_scale(scales, group)
    gs = [g for gg in ggroups for g in gg]
    rs = [r for rg in rgroups for r in rg]
    gfs = [gf for gg in gf_groups for gf in gg]
    leaf = [i for i, gg in enumerate(ggroups) for _ in gg]
    dev = gfs[0].device
    outs = [gf if g.dtype == _F32 else torch.empty_like(g)
            for g, gf in zip(gs, gfs)]
    if sums is not None:
        sums[:] = [torch.empty(g.shape, dtype=torch.int32, device=dev)
                   for g in gs]
    flat = [gf.view(-1) for gf in gfs]
    for bucket in _buckets([f.numel() for f in flat],
                           max(1, bucket_bytes // 4)):
        size = sum(stop - start for _, start, stop in bucket)
        buf = torch.empty(size, dtype=torch.int32, device=dev)
        at = 0
        for i, start, stop in bucket:
            buf[at:at + stop - start] = _quantize(flat[i][start:stop],
                                                  scales[leaf[i]])
            at += stop - start
        local = buf.to(torch.int8)      # the local q, for the residual
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        at = 0
        for i, start, stop in bucket:
            k, sm = stop - start, smean[leaf[i]]
            q, qsum = local[at:at + k].to(_F32), buf[at:at + k]
            seg = flat[i][start:stop]
            rs[i].view(-1)[start:stop] = seg - q * sm
            outs[i].view(-1)[start:stop] = true_div(qsum.to(_F32) * sm,
                                                    float(n))
            if sums is not None:
                sums[i].view(-1)[start:stop] = qsum
            at += k
    return outs, gs


def psum_compressed_leaf(g: torch.Tensor, residual: torch.Tensor, group
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean of one leaf over ``group``: ``(mean,
    new_residual)``, the mean in ``g``'s dtype.  In place as
    :func:`tree_psum_compressed`."""
    (out,), _ = _compressed_mean([[g]], [[residual]], group, BUCKET_BYTES,
                                 None)
    return out, residual


def tree_psum_compressed(grads, residuals, group, *, period: int = 1,
                         bucket_bytes: int = BUCKET_BYTES,
                         sums: Optional[list] = None):
    """:func:`psum_compressed_leaf` over a tree, leaf by reference leaf
    (``period``: the block pattern's length; a decoder's ``layers`` are
    stacked as the reference stacks them, one scale for the stack, see
    :func:`repro_torch.optim.adamw.ref_order_groups`), the int32 payloads
    in buckets of at most ``bucket_bytes``: ``(mean tree, residual
    tree)``.

    In place, as ``adamw_update`` is: the residual tensors are overwritten
    by the new residuals (the returned tree is ``residuals``), and a
    float32 gradient's storage by its mean.  ``sums``, a list, receives
    each tensor's int32 sum in reference-leaf order, for checks."""
    outs, gs = _compressed_mean(_leaf_groups(grads, period),
                                _leaf_groups(residuals, period), group,
                                bucket_bytes, sums)
    by_id = {id(g): o for g, o in zip(gs, outs)}
    return tree_map(lambda g: by_id[id(g)], grads), residuals


@torch.no_grad()
def tree_psum(grads, group):
    """The uncompressed mean over ``group``: one :func:`all_reduce_sum` a
    leaf ("grad_mean"), in the leaf's dtype; a rank block's mean is a
    block of the same part (the ranks of ``group`` hold the same block).
    The baseline the compressed mean is held to, and the data-group mean
    of :func:`repro_torch.train.steps.make_train_step`."""
    n = float(dist.get_world_size(group))

    def mean(g):
        return true_div(all_reduce_sum(g, group, "grad_mean"), n)

    return tree_map(lambda g: mean(g) if isinstance(g, torch.Tensor)
                    else g.map(mean), grads)


def _staged(x: torch.Tensor, group) -> bool:
    """Gloo moves no CUDA tensor here: such a tensor goes through host
    memory (NCCL works on the card)."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order: an all-gather, pure data movement (every rank's ``x`` has the
    same shape).

    Gloo gathers no CUDA tensor, so under gloo a CUDA ``x`` is staged
    through host memory: copied to the host, gathered there, and the
    whole copied back to ``x``'s device.  NCCL gathers on the card.  Each
    call adds one call, the gathered tensor's bytes and, when staged, the
    bytes of both host copies to the "gather" counts
    (:func:`collective_counts`)."""
    n = dist.get_world_size(group)
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    nbytes = out.numel() * out.element_size()
    if staged:
        out = out.to(x.device)
    _count("gather", nbytes, nbytes + nbytes // n if staged else 0)
    return out


def gather_cat(x: torch.Tensor, dim: int, group) -> Optional[torch.Tensor]:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order, on the host of the group's rank 0 only (a gather, not an
    all-gather); ``None`` on the others.  Staged and counted as
    :func:`all_gather_cat` ("gather")."""
    n, mine = dist.get_world_size(group), dist.get_rank(group) == 0
    src = x.detach().contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)] if mine else None
    dist.gather(src, parts, dst=dist.get_global_rank(group, 0), group=group)
    nbytes = src.numel() * src.element_size()
    _count("gather", n * nbytes if mine else nbytes,
           nbytes if staged else 0)
    return torch.cat(parts, dim=dim).cpu() if mine else None


def all_reduce_sum(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, a new tensor on
    ``x``'s device, the same on every rank (a ring reduces each element
    once and then hands it round).  A CUDA ``x`` under gloo is staged
    through host memory as :func:`all_gather_cat` stages it.  Counted
    under ``kind``: one call, ``x``'s bytes, and both host copies when
    staged."""
    src = x.contiguous()
    staged = _staged(src, group)
    buf = src.cpu() if staged else src.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    nbytes = buf.numel() * buf.element_size()
    if staged:
        buf = buf.to(x.device)
    _count(kind, nbytes, 2 * nbytes if staged else 0)
    return buf


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group, "grad_reduce"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group, "reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim = dim % x.dim()
        ctx.span = (dist.get_rank(group) * x.shape[ctx.dim],
                    x.shape[ctx.dim])
        return all_gather_cat(x, ctx.dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, *ctx.span), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (whole on every rank of the model group ``group``) as the
    input of a product with this rank's block: the identity forward; the
    backward all-reduces the gradient, since each rank's block gives only
    its part of ``x``'s gradient."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's partial product ``x`` (a
    product that contracts this rank's block): an all-reduce forward; the
    gradient of the sum is each partial's, so the backward is the
    identity."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Each rank's block ``x`` of a column-block product concatenated
    along ``dim`` in rank order (:func:`all_gather_cat`); the backward
    takes this rank's slice of the gradient, which is whole on every
    rank."""
    return _GatherFromModel.apply(x, dim, group)


COLLECTIVE_KINDS = (
    "gather",           # the all-gathers of column blocks, and gathers
    "reduce",           # the forward all-reduces of partial sums
    "grad_reduce",      # the backward all-reduces of copy_to_model
    "grad_mean",        # a step's mean over the data group, its metrics'
    "norm",             # the clip norm's sums of block partials
)
_COUNTS: dict = {}


def _count(kind: str, nbytes: int, staged_bytes: int) -> None:
    c = _COUNTS[kind]
    c["calls"] += 1
    c["bytes"] += nbytes
    c["staged_bytes"] += staged_bytes


def collective_counts() -> dict:
    """Per kind of :data:`COLLECTIVE_KINDS`, the calls, the bytes moved
    (an all-gather's whole result, an all-reduce's tensor) and the bytes
    staged through host memory since :func:`reset_collective_counts`."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def reset_collective_counts() -> None:
    for k in COLLECTIVE_KINDS:
        _COUNTS[k] = {"calls": 0, "bytes": 0, "staged_bytes": 0}


reset_collective_counts()
