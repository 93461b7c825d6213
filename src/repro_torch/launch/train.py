"""Training launcher (port of ``repro.launch.train``):
``python -m repro_torch.launch.train --arch <id> [...] [--device cpu]``.

Composes the training stack on ``--device`` (the card by default): a
reduced (default) or ``--full`` config, AdamW with the reference's
warmup, ``--microbatches`` gradient accumulation, per-block ``--remat``,
deterministic synthetic data, and the fault-tolerant
:class:`repro_torch.train.loop.TrainLoop` (auto-resume and async
checkpoints under ``--ckpt-dir``, the straggler watchdog).  The reference
places the state over a ``("data", "model")`` mesh of its devices by its
train layout.  The port runs one process on one device, or, inside a
started process group (:func:`rank_main` under
:func:`repro_torch.launch.mesh.run_local_ranks`), over its ranks:
``--model-parallel k`` gives the mesh ``(world // k, k)``, each rank
holding its blocks of the train layout (tensor-parallel training of the
dense decoder family, :func:`repro_torch.train.steps.make_train_step`),
and rank 0 prints.  A model axis outside a group raises, and so does
``--ckpt-dir`` with a model axis or over the ranks of a group:
checkpoints of a state over ranks belong to the re-mesh of a model axis,
ROADMAP A.8c(b).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch.distributed as dist

from ..configs import get_config
from ..data import SyntheticLM
from ..device import resolve_device
from ..optim import AdamWConfig
from ..train.loop import LoopConfig, TrainLoop
from ..train.steps import init_train_state, make_train_step
from .mesh import A8C_B, make_local_mesh
from .serve import extra_inputs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek_7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the model axis over the ranks of a started "
                    "process group (rank_main)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda; a rank's "
                    "device under a process group)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    k = args.model_parallel
    grouped = dist.is_available() and dist.is_initialized()
    ranks = dist.get_world_size() if grouped else 1
    if args.ckpt_dir and (k != 1 or ranks > 1):
        # every rank would write and restore on its own
        raise NotImplementedError("--ckpt-dir with --model-parallel > 1 or "
                                  "over the ranks of a group: checkpoints "
                                  f"of a state over ranks are {A8C_B}")
    if k != 1 and not grouped:
        raise NotImplementedError(
            "--model-parallel > 1 in one process: the port places a model "
            "axis over the ranks of a started process group (rank_main "
            "under repro_torch.launch.mesh.run_local_ranks), ROADMAP A.8c")
    mesh = make_local_mesh(model=k, device=dev) if grouped else None
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **kw: None)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    step_fn = make_train_step(cfg, opt_cfg, mesh=mesh,
                              microbatches=args.microbatches,
                              remat=args.remat)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch)

    def make_batch(step):
        tb = data.batch_at(step)
        return {"tokens": tb.tokens, "labels": tb.labels,
                **extra_inputs(cfg, args.batch)}

    loop = TrainLoop(step_fn, data, ckpt_dir=args.ckpt_dir,
                     cfg=LoopConfig(total_steps=args.steps),
                     make_batch=make_batch, log_fn=say)
    loop.run(lambda: init_train_state(cfg, 0, device=dev, mesh=mesh))
    final = loop.history[-1]["loss"] if loop.history else float("nan")
    where = dev if mesh is None else f"{mesh.size} ranks, mesh {mesh.shape}"
    say(f"[train] done on {where}: final loss {final:.4f} "
        f"(uniform {np.log(cfg.vocab):.3f})")
    return loop


def rank_main(mesh, argv):
    """:func:`main` on one rank of a started process group (the signature
    :func:`repro_torch.launch.mesh.run_local_ranks` calls): the rank's
    loss history (every rank's is the same)."""
    return main(argv).history


if __name__ == "__main__":
    main()
