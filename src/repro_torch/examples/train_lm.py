"""End-to-end training example: a ~57M-parameter LLaMA-class model for a
few hundred steps on the deterministic synthetic pipeline, with the full
fault-tolerant loop (async checkpoints, auto-resume, straggler watchdog).
Port of the reference's ``examples/train_lm.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm
      [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..configs import get_config
from ..data import SyntheticLM
from ..device import resolve_device
from ..optim import AdamWConfig
from ..train.loop import LoopConfig, TrainLoop
from ..train.steps import init_train_state, make_train_step


def lm_100m():
    """The reference example's llama-family config (~57M params by
    ``param_count``)."""
    base = get_config("llama3_8b")
    return dataclasses.replace(
        base, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
        d_ff=1408, vocab=32768, head_dim=64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/train_lm_ckpt",
                    help="checkpoint directory (resumes from it)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = lm_100m()
    print(f"[train_lm] {cfg.name}-reduced: {cfg.param_count() / 1e6:.1f}M "
          f"params on {device}")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch)
    opt = AdamWConfig(lr=1e-3, total_steps=args.steps,
                      warmup_steps=args.steps // 10)
    step = make_train_step(cfg, opt, microbatches=2, remat=True)
    loop = TrainLoop(step, data, ckpt_dir=args.ckpt_dir,
                     cfg=LoopConfig(total_steps=args.steps, log_every=20,
                                    ckpt_every=100))
    loop.run(lambda: init_train_state(cfg, 0, device=device))

    losses = [h["loss"] for h in loop.history]
    print(f"[train_lm] loss: first5={np.mean(losses[:5]):.3f} "
          f"last5={np.mean(losses[-5:]):.3f} "
          f"(uniform={data.uniform_nll():.3f}, "
          f"oracle={data.oracle_nll():.3f})")
    if not np.mean(losses[-5:]) < data.uniform_nll() - 1.0:
        print("[train_lm] FAIL: the model did not learn")
        return 1
    print("[train_lm] OK — model learned the synthetic distribution")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
