"""Checkpoints with atomic commit, async save and auto-resume (port of
``repro.checkpoint.checkpoint``), in the reference's on-disk layout::

    <dir>/step_00000123/
        manifest.json     # step, leaf count, flat paths, metadata
        proc_0.npz        # flat path -> ndarray
        COMMIT            # written last; present == the checkpoint is valid

A save writes into ``step_X.tmp0`` and renames it into place only once
``COMMIT`` exists inside, so a crash mid-save leaves nothing that
:func:`latest_step` picks up.  ``CheckpointManager.save(blocking=False)``
copies the tree to host memory, then writes on a thread.

Flat paths join dict keys, list indices and NamedTuple field names with
``/`` (``params/layers/0/attn/wq``, ``opt/mu/embed``, ``opt/step``), as
the reference joins its tree's.  Tensors keep their dtypes; bfloat16,
which numpy lacks, is stored as its uint16 bit pattern and the manifest
names the leaf's dtype.  :func:`load_checkpoint` without a template
returns the flat numpy arrays, so a reference-written checkpoint can be
carried into the port (:func:`repro_torch.convert.train_state_from_reference`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import flatten, unflatten

_BF16 = "bfloat16"


def _to_host(x) -> np.ndarray:
    """A host copy (never a view of a CPU tensor the caller may update)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        arr = x.cpu().numpy()
        return arr.copy() if x.device.type == "cpu" else arr
    return np.array(x)


def _dtype_name(x) -> str:
    return _BF16 if isinstance(x, torch.Tensor) and \
        x.dtype == torch.bfloat16 else str(_to_host_dtype(x))


def _to_host_dtype(x):
    return (str(x.dtype).replace("torch.", "") if isinstance(x, torch.Tensor)
            else np.asarray(x).dtype)


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def _snapshot(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat = flatten(tree)
    return ({k: _to_host(v) for k, v in flat.items()},
            {k: _dtype_name(v) for k, v in flat.items()})


def save_checkpoint(base: str, step: int, tree, *,
                    metadata: Optional[Dict[str, Any]] = None,
                    process_index: int = 0) -> str:
    """Synchronous atomic save; returns the committed directory."""
    return _write(base, step, _snapshot(tree), metadata, process_index)


def _write(base: str, step: int, snap, metadata, process_index: int = 0
           ) -> str:
    os.makedirs(base, exist_ok=True)
    final = _step_dir(base, step)
    tmp = final + f".tmp{process_index}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = snap
    np.savez(os.path.join(tmp, f"proc_{process_index}.npz"), **arrays)
    manifest = {"step": step, "n_leaves": len(arrays),
                "keys": sorted(arrays), "metadata": metadata or {},
                "dtypes": dtypes}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _leaf_from(arr: np.ndarray, like: torch.Tensor, dtype_name: str,
               in_place: bool):
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape {arr.shape} != {tuple(like.shape)}")
    if dtype_name == _BF16:
        t = torch.from_numpy(arr).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
    if in_place:
        return like.copy_(t)
    return t.to(device=like.device, dtype=like.dtype)


def load_checkpoint(base: str, step: int, template=None, *,
                    process_index: int = 0, in_place: bool = False
                    ) -> Tuple[Any, Dict[str, Any]]:
    """``(tree, metadata)``: the tree shaped like ``template`` (each leaf
    on the template leaf's device and dtype; with ``in_place`` copied into
    the template's own tensors, so a restore allocates no second state),
    or, without a template, the flat ``path -> ndarray`` dict (bfloat16
    leaves as float32)."""
    d = _step_dir(base, step)
    if not os.path.exists(os.path.join(d, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, f"proc_{process_index}.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    dtypes = manifest.get("dtypes", {})
    if template is None:
        for k, name in dtypes.items():
            if name == _BF16:
                arrays[k] = (arrays[k].astype(np.uint32) << 16).view(
                    np.float32)
        return arrays, manifest["metadata"]
    flat = flatten(template)
    leaves = {}
    for k, like in flat.items():
        if k not in arrays:
            raise KeyError(f"checkpoint missing leaf {k}")
        leaves[k] = _leaf_from(arrays[k], like, dtypes.get(k, ""), in_place)
    return unflatten(template, leaves), manifest["metadata"]


def latest_step(base: str) -> Optional[int]:
    """Newest committed step, or None."""
    if not os.path.isdir(base):
        return None
    steps = []
    for name in os.listdir(base):
        if name.startswith("step_") and "." not in name:
            if os.path.exists(os.path.join(base, name, "COMMIT")):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
    return max(steps) if steps else None


class CheckpointManager:
    """Async, garbage-collected checkpointing for a training loop."""

    def __init__(self, base: str, *, keep: int = 3, save_every: int = 100):
        self.base = base
        self.keep = keep
        self.save_every = save_every
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, tree, *, metadata=None, blocking: bool = True):
        self.wait()                       # one save in flight at a time
        # the host copy is taken now: the loop updates the state in place
        snap = _snapshot(tree)

        def work():
            try:
                _write(self.base, step, snap, metadata)
                self._gc()
            except BaseException as e:     # raised by the next wait()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            s for s in (int(n.split("_")[1]) for n in os.listdir(self.base)
                        if n.startswith("step_") and "." not in n)
            if os.path.exists(os.path.join(_step_dir(self.base, s),
                                           "COMMIT")))
        for s in steps[:-self.keep]:
            shutil.rmtree(_step_dir(self.base, s), ignore_errors=True)

    def restore_or_init(self, init_fn: Callable[[], Any]):
        """``(state, start_step)``: the newest committed step restored into
        the tensors of ``init_fn()``, else ``init_fn()`` and 0."""
        step = latest_step(self.base)
        state = init_fn()
        if step is None:
            return state, 0
        state, _ = load_checkpoint(self.base, step, state, in_place=True)
        return state, step
