"""Training launcher (port of ``repro.launch.train``):
``python -m repro_torch.launch.train --arch <id> [...] [--device cpu]``.

Composes the training stack in one process on ``--device`` (the card by
default): a reduced (default) or ``--full`` config, AdamW with the
reference's warmup, ``--microbatches`` gradient accumulation, per-block
``--remat``, deterministic synthetic data, and the fault-tolerant
:class:`repro_torch.train.loop.TrainLoop` (auto-resume and async
checkpoints under ``--ckpt-dir``, the straggler watchdog).  The reference
shards the state over a ``("data", "model")`` mesh by its production
rules; the port runs one device, and ``--model-parallel > 1`` raises
(tensor-parallel training, ROADMAP A.8c; data-parallel training over
ranks is ``repro_torch.train.steps.make_dp_train_step``).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import get_config
from ..data import SyntheticLM
from ..device import resolve_device
from ..optim import AdamWConfig
from ..train.loop import LoopConfig, TrainLoop
from ..train.steps import init_train_state, make_train_step
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
                    help="only 1: tensor-parallel training is ROADMAP A.8c")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda)")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel > 1 is tensor-parallel training over ranks, "
            "which is not ported: ROADMAP A.8c")
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              remat=args.remat)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch)

    def make_batch(step):
        tb = data.batch_at(step)
        return {"tokens": tb.tokens, "labels": tb.labels,
                **extra_inputs(cfg, args.batch)}

    loop = TrainLoop(step_fn, data, ckpt_dir=args.ckpt_dir,
                     cfg=LoopConfig(total_steps=args.steps),
                     make_batch=make_batch)
    loop.run(lambda: init_train_state(cfg, 0, device=dev))
    final = loop.history[-1]["loss"] if loop.history else float("nan")
    print(f"[train] done on {dev}: final loss {final:.4f} "
          f"(uniform {np.log(cfg.vocab):.3f})")
    return loop


if __name__ == "__main__":
    main()
