"""Mesh builders (port of ``repro.launch.mesh``): logical meshes.

A :class:`LogicalMesh` is a named shape, ``("data", "model")`` or
``("pod", "data", "model")``, that the sharding rules
(:mod:`repro_torch.distributed.sharding`) read, on one torch device.  The
mesh serving engine runs every model-axis shard of one device on that
device (the fleet lanes run several devices on one card the same way), so
``make_serve_mesh(tp)`` takes any ``tp``.  Placing a mesh's shards over
several processes is ROADMAP A.8b: the engines refuse a mesh whose data
axes hold more than one replica.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """A named mesh shape on one torch device: ``shape`` maps each axis
    name to its size, in ``axis_names`` order."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def visible_devices(device="cuda") -> int:
    """The devices a default mesh spans: the visible CUDA cards, or the
    one CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production shapes: 16 x 16 ``("data", "model")`` a pod, 2 x 16 x
    16 ``("pod", "data", "model")`` multi-pod (a logical shape: nothing is
    placed)."""
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 16),
                           resolve_device(device))
    return LogicalMesh(("data", "model"), (16, 16), resolve_device(device))


def make_local_mesh(model: int = 1, device="cuda"):
    """The visible devices, data-major: ``(n // model, model)``."""
    n = visible_devices(device)
    if model < 1 or n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return LogicalMesh(("data", "model"), (n // model, model),
                       resolve_device(device))


def make_serve_mesh(tp: Optional[int] = None, device="cuda"):
    """Tensor-parallel serving mesh ``("data", "model")`` of shape ``(1,
    tp)`` on ``device``; ``tp`` defaults to the visible devices, as the
    reference counts its devices."""
    tp = visible_devices(device) if tp is None else int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    return LogicalMesh(("data", "model"), (1, tp), resolve_device(device))
