"""Elastic scaling: re-mesh a data-parallel job to a different rank
count (port of ``repro.distributed.elastic``).

The data axis is resizable at a checkpoint boundary without touching the
math: the model (tensor-parallel) axis is pinned by weight shapes, data
parallelism absorbs the change, and ``dp * microbatches`` is kept so the
global batch is unchanged.  :func:`plan_remesh_shape` plans from a named
shape alone, :func:`plan_remesh` from a live mesh;
:func:`make_mesh_from_plan` makes the new group over the first ranks and
:func:`reshard_state` carries the replicated state onto it.  A model axis
above 1 over ranks is tensor-parallel training (ROADMAP A.8c's training
half).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ModelConfig
from ..launch.mesh import A8C, LogicalMesh
from ..tree import flatten, map_with_path
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
                                  f"is {A8C}")
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


@torch.no_grad()
def reshard_state(state, cfg: ModelConfig, new_mesh: LogicalMesh):
    """A train or serve state on ``new_mesh``: every replicated leaf a copy
    of the new group's first rank's, bit for bit (a broadcast).

    The port's :func:`~repro_torch.distributed.sharding.state_specs` must
    find every leaf replicated on the new mesh; a leaf sharded over a
    model axis is tensor-parallel placement and raises.  The
    error-feedback residuals of a compressed state belong to one rank
    each: they restart from zero on the new mesh, as
    :func:`repro_torch.train.steps.dp_residuals_init` starts them."""
    residuals = getattr(state, "residuals", None)
    replicated = state._replace(residuals=None) if residuals is not None \
        else state
    specs = state_specs(flatten(replicated), cfg, new_mesh)
    sharded = sorted(k for k, sp in specs.items() if sp != ())
    if sharded:
        raise NotImplementedError(f"{sharded[0]} is sharded "
                                  f"{specs[sharded[0]]} on the new mesh: "
                                  f"{A8C}")
    src = dist.get_global_rank(new_mesh.group, 0)

    def place(path, x):
        if x is None:
            return None
        y = x.to(new_mesh.device, copy=True)
        dist.broadcast(y, src=src, group=new_mesh.group)
        return y

    out = map_with_path(place, replicated)
    if residuals is not None:
        out = out._replace(residuals=map_with_path(
            lambda path, r: torch.zeros(r.shape, dtype=r.dtype,
                                        device=new_mesh.device), residuals))
    return out
