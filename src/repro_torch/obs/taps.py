"""Per-step serving-health taps (``repro.obs.taps.logit_taps`` only)."""
from __future__ import annotations

from typing import Dict

import torch


def logit_taps(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Batch-mean max logit and top1-top2 margin of a ``(batch, vocab)``
    slab — both fall as admitted BER corrupts the forward pass."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return {"logit_max": top2[:, 0].mean(),
            "logit_margin": (top2[:, 0] - top2[:, 1]).mean()}
