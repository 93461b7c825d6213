"""Training steps (port of ``repro.train.steps``; the loss only, for now —
``ServeEngine.score`` uses it)."""
from __future__ import annotations

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy.  logits (B, S, V) float32, labels
    (B, S) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(logz - gold)
