"""Mesh builders (port of ``repro.launch.mesh``): logical meshes.

A :class:`LogicalMesh` is a named shape, ``("data", "model")`` or
``("pod", "data", "model")``, that the sharding rules
(:mod:`repro_torch.distributed.sharding`) read, on one torch device.  The
mesh serving engine runs every model-axis shard of one device on that
device (the fleet lanes run several devices on one card the same way), so
``make_serve_mesh(tp)`` takes any ``tp``.

A mesh may also span the ranks of a ``torch.distributed`` group (``group``,
and this process's ``rank`` in it).  :func:`init_data_group` starts such a
group from a ``file://`` store (no network) and :func:`run_local_ranks`
runs a function on each rank of one host.  Under a started group,
:func:`make_local_mesh` (training) and :func:`make_serve_mesh` (serving)
place a model axis of ``k`` over the ranks, ``(world // k, k)``: rank
``r`` is shard ``r % k`` of data replica ``r // k``, ``model_group``
holds the ``k`` ranks of its replica (the group its blocks' collectives
run in) and ``data_group`` the ranks that hold the same shard (the group
a tensor-parallel step averages its gradients over).  Re-meshing a model
axis over ranks is ROADMAP A.8c(b).
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

A8C_B = "the re-mesh of a model axis over ranks: ROADMAP A.8c(b)"


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """A named mesh shape on one torch device: ``shape`` maps each axis
    name to its size, in ``axis_names`` order.  ``group`` is the
    ``torch.distributed`` group whose ranks make up the mesh (``None``: one
    process) and ``rank`` this process's rank in it.  ``model_group`` is
    set on a mesh whose model axis spans ranks: the ranks of this rank's
    data replica, shard ``s`` at rank ``s`` of it; ``data_group``, set
    with it, the ranks of this rank's shard, replica ``d`` at rank ``d``
    of it."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device
    group: Any = None
    rank: int = 0
    model_group: Any = None
    data_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def shard(self) -> int:
        """This rank's index on the model axis (0 in one process)."""
        return self.rank % self.sizes[-1] if self.group is not None else 0

    @property
    def replica(self) -> int:
        """This rank's data replica (0 in one process)."""
        return self.rank // self.sizes[-1] if self.group is not None else 0


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
    """The visible devices, data-major: ``(n // model, model)``.  Under a
    started process group, its ranks: ``(world // model, model)``, rank
    ``r`` shard ``r % model`` of replica ``r // model``; with ``model >
    1`` the mesh also holds its replica's ``model_group`` and its shard's
    ``data_group``.  Every rank of the group calls this (it makes the
    groups with ``dist.new_group``, the same on every rank)."""
    grouped = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if grouped else visible_devices(device)
    if model < 1 or n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    if not grouped:
        return LogicalMesh(("data", "model"), (n // model, model),
                           resolve_device(device))
    if model == 1:
        return LogicalMesh(("data", "model"), (n, 1), resolve_device(device),
                           group=dist.group.WORLD, rank=dist.get_rank())
    return _ranks_mesh(model, device)


def _ranks_mesh(k: int, device) -> LogicalMesh:
    """The started group's ranks as ``(world // k, k)``: rank ``r`` is
    shard ``r % k`` of replica ``r // k``, with its replica's
    ``model_group`` and its shard's ``data_group``.  Every rank calls
    this: it makes the groups with ``dist.new_group``, one a replica and
    one a shard, in the same order on every rank."""
    n, rank = dist.get_world_size(), dist.get_rank()
    replicas = [dist.new_group(list(range(d * k, (d + 1) * k)))
                for d in range(n // k)]
    shards = [dist.new_group(list(range(s, n, k))) for s in range(k)]
    return LogicalMesh(("data", "model"), (n // k, k),
                       resolve_device(device), group=dist.group.WORLD,
                       rank=rank, model_group=replicas[rank // k],
                       data_group=shards[rank % k])


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
        result = fn(mesh, *args)
        if world_size > 1:
            # no rank tears the group down while another may still be in
            # a collective of it (gloo aborts the process then)
            dist.barrier()
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
    """Tensor-parallel serving mesh ``("data", "model")``.

    In one process: shape ``(1, tp)`` on ``device``, every shard on it;
    ``tp`` defaults to the visible devices, as the reference counts its
    devices.  Under a started process group: its ranks, ``(world // tp,
    tp)`` (``tp`` defaults to the world), as the reference spans its
    devices; rank ``r`` is shard ``r % tp`` of replica ``r // tp``, and the
    mesh's ``model_group`` is its replica's ranks.  Every rank of the group
    calls this (it makes the groups with ``dist.new_group``); ``device``
    is this rank's."""
    grouped = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if grouped else None
    if tp is None:
        tp = n if grouped else visible_devices(device)
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if not grouped:
        return LogicalMesh(("data", "model"), (1, tp), resolve_device(device))
    if n % tp:
        raise ValueError(f"{n} ranks do not split into tp={tp}")
    return _ranks_mesh(tp, device)
