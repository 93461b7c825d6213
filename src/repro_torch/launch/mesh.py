"""Mesh builders (port of ``repro.launch.mesh``): logical meshes.

A :class:`LogicalMesh` is a named shape, ``("data", "model")`` or
``("pod", "data", "model")``, that the sharding rules
(:mod:`repro_torch.distributed.sharding`) read, on one torch device.  The
mesh serving engine runs every model-axis shard of one device on that
device (the fleet lanes run several devices on one card the same way), so
``make_serve_mesh(tp)`` takes any ``tp``.

A mesh may also span the ranks of a ``torch.distributed`` group: its data
axes are the group's ranks (``group``, and this process's ``rank`` in it),
its model axis 1.  :func:`init_data_group` starts such a group from a
``file://`` store (no network) and :func:`run_local_ranks` runs a function
on each rank of one host.  A model axis above 1 over ranks is
tensor-parallel placement, ROADMAP A.8c; so is serving a mesh whose data
axes hold more than one replica.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import tempfile
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

A8C = "tensor-parallel placement over ranks: ROADMAP A.8c"


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """A named mesh shape on one torch device: ``shape`` maps each axis
    name to its size, in ``axis_names`` order.  ``group`` is the
    ``torch.distributed`` group whose ranks make up the data axes (``None``:
    one process) and ``rank`` this process's rank in it."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device
    group: Any = None
    rank: int = 0

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
    """The visible devices, data-major: ``(n // model, model)``; under a
    started process group, its ranks: ``(world, 1)``."""
    grouped = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if grouped else visible_devices(device)
    if model < 1 or n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    if not grouped:
        return LogicalMesh(("data", "model"), (n // model, model),
                           resolve_device(device))
    if model != 1:
        raise NotImplementedError(f"a model axis of {model} ranks is {A8C}")
    return LogicalMesh(("data", "model"), (n, 1), resolve_device(device),
                       group=dist.group.WORLD, rank=dist.get_rank())


def init_data_group(init_file: str, rank: int, world_size: int, *,
                    backend: str, device="cuda") -> LogicalMesh:
    """Start this process's rank of a ``world_size``-rank group from the
    ``file://`` store at ``init_file`` (a path no earlier group used) and
    return the mesh over it, ``("data", "model") = (world_size, 1)``.

    ``backend`` is the caller's choice: ``"nccl"`` runs one rank a card
    (rank r on ``cuda:r``), ``"gloo"`` runs on the CPU, or several ranks on
    one card (``device``).  A failing start raises; nothing falls back to
    another backend or device."""
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL runs on CUDA devices only")
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"NCCL runs one rank a card: {world_size} ranks on "
                f"{torch.cuda.device_count()} cards (several ranks on one "
                f"card take gloo)")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    dist.init_process_group(backend,
                            init_method="file://" + os.path.abspath(init_file),
                            rank=rank, world_size=world_size)
    return make_local_mesh(device=dev)


def _rank_main(rank, world_size, backend, device, out_dir):
    """One spawned rank: load the function and its arguments, start the
    group, run the function, save its result (or the traceback) under
    ``out_dir``."""
    try:
        fn, args = torch.load(os.path.join(out_dir, "call.pt"),
                              weights_only=False)
        init_file = os.path.join(out_dir, "store")
        mesh = init_data_group(init_file, rank, world_size, backend=backend,
                               device=device)
        try:
            result = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_local_ranks(fn, world_size: int, *args, backend: str,
                    device="cuda", timeout: float = 600.0) -> list:
    """``fn(mesh, *args)`` on ``world_size`` processes of this host, each a
    rank of one group (:func:`init_data_group` over a store in a fresh
    temporary directory); returns the ranks' results in rank order.

    ``fn`` is a module-level function and ``args`` and the results must
    pickle (return host data: numpy arrays, numbers).  The processes are
    spawned, so each imports ``fn``'s module afresh.  A rank that fails
    stops the others and raises here with its traceback; so does a run
    past ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        # the arguments go through a file: a spawned process's own
        # arguments pass through a pipe, slowly for ~100 KB of arrays
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        procs = [ctx.Process(target=_rank_main, args=(
            r, world_size, backend, str(device), tmp))
            for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if time.monotonic() > deadline or any(
                        p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errors = []
        for f in sorted(os.listdir(tmp)):
            if f.endswith(".err"):
                with open(os.path.join(tmp, f)) as fh:
                    errors.append(fh.read())
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} ended with exit codes "
                               f"{[procs[r].exitcode for r in bad]} "
                               f"(timeout {timeout} s)")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]


def make_serve_mesh(tp: Optional[int] = None, device="cuda"):
    """Tensor-parallel serving mesh ``("data", "model")`` of shape ``(1,
    tp)`` on ``device``; ``tp`` defaults to the visible devices, as the
    reference counts its devices."""
    tp = visible_devices(device) if tp is None else int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    return LogicalMesh(("data", "model"), (1, tp), resolve_device(device))
