"""Elastic scaling: plan a job's re-mesh to a different device count
(the mesh-free part of ``repro.distributed.elastic``).

The data axis is resizable at a checkpoint boundary without touching the
math: the model (tensor-parallel) axis is pinned by weight shapes, data
parallelism absorbs the change, and ``dp * microbatches`` is kept so the
global batch is unchanged.  :func:`plan_remesh_shape` plans from a named
shape alone; planning from a live mesh and resharding state wait for the
port of the mesh layer.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


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
