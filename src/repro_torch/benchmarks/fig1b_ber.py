"""Benchmark: paper Fig. 1(b) — model quality against BER, by real
bit-error injection on a model trained here (port of the reference's
``benchmarks/fig1b_ber.py``, with its checks).

A reduced llama3_8b trains for 80 steps on the synthetic pipeline until it
clearly beats the uniform baseline; then the BER sweeps through the knee
on every operator domain at once (the kernel-free route, as the
reference's ``use_systolic_kernel=False``).  The claim under test: flat
below ~1e-5, collapse above ~1e-3 — the shape the fault-tolerant policy
exploits.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import random as prandom
from ..configs import get_config
from ..data import SyntheticLM
from ..device import resolve_device
from ..models import transformer as tf
from ..models.layers import FaultConfig
from ..optim import AdamWConfig
from ..train.steps import init_train_state, make_train_step, softmax_xent
from .common import main, report, table

OPS = ("q", "k", "v", "qkt", "sv", "o", "gate", "up", "down")
BERS = (0.0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2)
NOTE = ("note: the knee sits ~1 decade below the paper's OPT-1.3B "
        "(1e-4): a d=64 reduced model with ALL nine domains injected "
        "simultaneously has far less redundancy — the curve SHAPE, "
        "which the policy exploits, is what transfers.")


def train_small(steps: int = 80, device="cuda"):
    cfg = get_config("llama3_8b").reduced()
    data = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=16)
    state = init_train_state(cfg, 0, device=device)
    step = make_train_step(
        cfg, AdamWConfig(lr=3e-3, total_steps=steps, warmup_steps=5))
    m = None
    for i in range(steps):
        tb = data.batch_at(i)
        state, m = step(state, {"tokens": tb.tokens, "labels": tb.labels})
    return cfg, state.params, data, float(m["loss"])


def evaluate(device="cuda"):
    device = resolve_device(device)
    cfg, params, data, train_loss = train_small(device=device)
    toks = torch.as_tensor(data.batch_at(500).tokens, device=device)

    @torch.no_grad()
    def nll_at(ber: float, seed: int = 0) -> float:
        fi = None if ber == 0 else FaultConfig(
            bers={op: ber for op in OPS},
            key=prandom.PRNGKey(seed),
            use_systolic_kernel=False)
        logits, _, _ = tf.forward_logits(params, cfg, toks[:, :-1], fi=fi)
        return float(softmax_xent(logits, toks[:, 1:]))

    nlls = [float(np.mean([nll_at(b, s) for s in range(2 if b > 0 else 1)]))
            for b in BERS]
    ppls = [float(np.exp(min(n, 30))) for n in nlls]
    rows = [[f"{b:.0e}" if b else "0", f"{n:.4f}", f"{p:.1f}"]
            for b, n, p in zip(BERS, nlls, ppls)]
    txt = table("Fig 1(b) — quality vs BER (trained reduced LM, all "
                "operator domains injected)", ["BER", "NLL", "ppl"], rows)
    clean = nlls[0]
    mono = all(nlls[i + 1] >= nlls[i] - 0.05 for i in range(2, len(nlls) - 1))
    checks = [
        ("model actually trained", train_loss < data.uniform_nll() - 0.3,
         f"loss {train_loss:.3f} vs uniform {data.uniform_nll():.3f}"),
        ("quasi-error-free below 1e-6 (Fig 1b: flat at low BER)",
         abs(nlls[2] - clean) < 0.1, f"ΔNLL={nlls[2] - clean:+.4f}"),
        ("collapse above 1e-3 (Fig 1b: failure past the knee)",
         nlls[-2] > clean + 0.5, f"ΔNLL={nlls[-2] - clean:+.3f}"),
        ("knee shape (flat -> monotone rise)", mono, ""),
    ]
    res = report(txt, {"bers": list(BERS), "nll": nlls,
                       "train_loss": train_loss}, checks)
    res["text"] += "\n" + NOTE
    return res


if __name__ == "__main__":
    sys.exit(main(evaluate, __doc__))
