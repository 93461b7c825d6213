"""Elastic scaling: re-mesh a data-parallel job to a different rank
count (port of ``repro.distributed.elastic``).

The data axis is resizable at a checkpoint boundary without touching the
math: the model (tensor-parallel) axis is pinned by weight shapes, data
parallelism absorbs the change, and ``dp * microbatches`` is kept so the
global batch is unchanged.  :func:`plan_remesh_shape` plans from a named
shape alone, :func:`plan_remesh` from a live mesh;
:func:`make_mesh_from_plan` makes the new group over the first ranks and
:func:`reshard_state` carries the replicated state onto it, and each new
rank's error-feedback residuals from the old rank whose row the
reference's step would give it.  A model axis
above 1 over ranks (tensor-parallel training, whose step is ported) is
not re-meshed: that is ROADMAP A.8c(b).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ModelConfig
from ..launch.mesh import A8C_B, LogicalMesh
from ..tree import flatten, map_with_path, unflatten
from .sharding import state_specs


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    microbatches: int            # grad-accum steps preserving global batch


def plan_remesh_shape(axis_names: Tuple[str, ...], axis_sizes,
                      new_n_devices: int, *, global_batch: int,
                      old_microbatches: int = 1) -> RemeshPlan:
    """Plan the re-mesh of an ``(axis_names, {name: size})`` layout onto
    ``new_n_devices``: the model axis stays, data parallelism shrinks (to
    the largest divisor of ``global_batch`` when needed), microbatches
    grow so ``dp * microbatches`` is kept, and every old axis name is kept
    (a ``pod`` axis keeps whole pods when the new data degree fills them,
    else collapses to 1)."""
    names = tuple(axis_names)
    sizes = dict(axis_sizes)
    model = sizes.get("model", 1)
    if new_n_devices % model != 0:
        raise ValueError(f"{new_n_devices} devices not divisible by "
                         f"model={model}")
    new_dp = new_n_devices // model
    old_dp = int(np.prod([sizes[a] for a in names if a != "model"]))
    if global_batch % new_dp != 0:
        while new_dp > 1 and global_batch % new_dp != 0:
            new_dp -= 1
    new_micro = max(1, (old_dp * old_microbatches) // new_dp)
    if "pod" in names:
        per_pod_dp = sizes["data"]
        if new_dp % per_pod_dp == 0:
            new_sizes = {"pod": new_dp // per_pod_dp, "data": per_pod_dp,
                         "model": model}
        else:
            new_sizes = {"pod": 1, "data": new_dp, "model": model}
        new_shape = tuple(new_sizes[a] for a in names)
        new_names = names
    else:
        new_shape = tuple(new_dp if a == "data" else model
                          for a in names if a in ("data", "model"))
        new_names = tuple(a for a in names if a in ("data", "model"))
    return RemeshPlan(tuple(sizes[a] for a in names), new_shape,
                      new_names, new_micro)


def plan_remesh(old_mesh, new_n_devices: int, *, global_batch: int,
                old_microbatches: int = 1) -> RemeshPlan:
    """:func:`plan_remesh_shape` of a live mesh's named shape."""
    return plan_remesh_shape(
        old_mesh.axis_names, old_mesh.shape, new_n_devices,
        global_batch=global_batch, old_microbatches=old_microbatches)


def make_mesh_from_plan(plan: RemeshPlan, device="cuda"
                        ) -> Optional[LogicalMesh]:
    """The plan's mesh over the first ``prod(new_shape)`` ranks of the
    started group: a new group (``dist.new_group``, which every rank of
    the old group calls).  The ranks past them get ``None``.  ``device``:
    where this rank's tensors live (its card under NCCL)."""
    sizes = dict(zip(plan.axis_names, plan.new_shape))
    if sizes.get("model", 1) != 1:
        raise NotImplementedError(f"a model axis of {sizes['model']} ranks "
                                  f"is {A8C_B}")
    n = int(np.prod(plan.new_shape))
    if n > dist.get_world_size():
        raise ValueError(f"the plan needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    group = dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    return LogicalMesh(tuple(plan.axis_names), tuple(plan.new_shape),
                       torch.device(device), group=group,
                       rank=dist.get_rank(group))


def _data_degree(shape, names) -> int:
    return int(np.prod([n for a, n in zip(names, shape) if a != "model"]))


@torch.no_grad()
def reshard_state(state, cfg: ModelConfig, new_mesh: Optional[LogicalMesh],
                  *, plan: Optional[RemeshPlan] = None):
    """A train or serve state on ``new_mesh``: every replicated leaf a copy
    of the new group's first rank's, bit for bit (a broadcast).

    The port's :func:`~repro_torch.distributed.sharding.state_specs` must
    find every leaf replicated on the new mesh; a leaf sharded over a
    model axis is tensor-parallel placement and raises.  A state without
    residuals (the plain mean, a serve state) re-meshes to any size; the
    ranks past the new mesh pass ``None`` and get ``None``.

    The error-feedback residuals of a compressed state belong to one rank
    each, and move as the reference's step splits its ``(n_old, ...)``
    residuals over the new data axis (each new shard takes its block's
    first row): new rank ``r`` continues from old rank ``r * n_old //
    n_new``, bit for bit, a point-to-point copy over the started group
    (rank 0 keeps its own).  Where ``n_new`` does not divide ``n_old``
    (4 -> 3, or any growth) the reference's step refuses the residuals,
    and so does this, with ``ValueError`` on every rank before anything
    moves.  Such a state needs ``plan`` (the :class:`RemeshPlan` that made
    ``new_mesh``), and every rank of the old mesh calls this, those past
    the new mesh with ``None``, since they hold residuals that others
    take.  The old and the new mesh are the first ranks of the started
    group, as :func:`make_mesh_from_plan` makes them; sends work under
    gloo (CPU tensors) and NCCL (CUDA tensors)."""
    residuals = getattr(state, "residuals", None)
    replicated = state._replace(residuals=None) if residuals is not None \
        else state
    if residuals is not None:
        _check_residual_plan(plan, new_mesh)
    if new_mesh is not None:
        specs = state_specs(flatten(replicated), cfg, new_mesh)
        sharded = sorted(k for k, sp in specs.items() if sp != ())
        if sharded:
            raise NotImplementedError(f"{sharded[0]} is sharded "
                                      f"{specs[sharded[0]]} on the new mesh:"
                                      f" {A8C_B}")
    carried = None if residuals is None else _carry_residuals(
        residuals, plan, new_mesh)
    if new_mesh is None:
        return None
    src = dist.get_global_rank(new_mesh.group, 0)

    def place(path, x):
        if x is None:
            return None
        y = x.to(new_mesh.device, copy=True)
        dist.broadcast(y, src=src, group=new_mesh.group)
        return y

    out = map_with_path(place, replicated)
    return out if carried is None else out._replace(residuals=carried)


def _check_residual_plan(plan: Optional[RemeshPlan],
                         new_mesh: Optional[LogicalMesh]) -> None:
    """The refusals of a compressed re-mesh, the same on every rank."""
    if plan is None:
        raise ValueError("a compressed state's residuals move by the plan's "
                         "data degrees: pass plan=")
    n_old = _data_degree(plan.old_shape, plan.axis_names)
    n_new = _data_degree(plan.new_shape, plan.axis_names)
    if n_old % n_new:
        raise ValueError(
            f"error-feedback residuals of {n_old} data shards do not split "
            f"over {n_new}: as the reference's step, a re-mesh of a "
            f"compressed state needs the new data degree to divide the old "
            f"(new rank r continues from old rank r * n_old // n_new)")
    if dist.get_world_size() < n_old:
        raise ValueError(f"the plan's old mesh needs {n_old} ranks, the "
                         f"group has {dist.get_world_size()}")
    if new_mesh is not None and (new_mesh.size != n_new
                                 or new_mesh.rank != dist.get_rank()):
        raise ValueError(f"the new mesh {new_mesh.shape} (rank "
                         f"{new_mesh.rank}) is not the plan's over the first "
                         f"{n_new} ranks")


def _carry_residuals(residuals, plan: RemeshPlan,
                     new_mesh: Optional[LogicalMesh]):
    """This rank's residuals on the new mesh (``None`` past it): old rank
    ``r * k`` sends its tree to old rank ``r`` (``k = n_old // n_new``)."""
    n_old = _data_degree(plan.old_shape, plan.axis_names)
    k = n_old // _data_degree(plan.new_shape, plan.axis_names)
    rank = dist.get_rank()
    flat = flatten(residuals)
    leaves = list(flat.values())
    pending, sent = [], []
    if 0 < rank < n_old and k > 1 and rank % k == 0:
        sent = [x.contiguous() for x in leaves]
        pending += [dist.isend(x, dst=rank // k, tag=i)
                    for i, x in enumerate(sent)]
    got = None
    if new_mesh is not None:
        if rank * k == rank:             # rank 0, or a re-mesh to the same size
            got = [x.to(new_mesh.device, copy=True) for x in leaves]
        else:
            got = [torch.empty(x.shape, dtype=x.dtype,
                               device=new_mesh.device) for x in leaves]
            pending += [dist.irecv(y, src=rank * k, tag=i)
                        for i, y in enumerate(got)]
    for req in pending:
        req.wait()
    if got is None:
        return None
    return unflatten(residuals, dict(zip(flat, got)))
