"""Per-step serving-health taps (``repro.obs.taps.logit_taps`` only)."""
from __future__ import annotations

from typing import Dict, Optional

import torch


def logit_taps(logits: torch.Tensor,
               lanes: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Batch-mean max logit and top1-top2 margin of a ``(batch, vocab)``
    slab — both fall as admitted BER corrupts the forward pass.  With
    ``lanes=N`` the batch folds N lanes lane-major and each tap is ``(N,)``,
    every lane's mean over its own rows (the reference's taps under
    ``jax.vmap``)."""
    top2 = torch.topk(logits, 2, dim=-1).values
    if lanes is not None:
        top2 = top2.reshape(lanes, -1, 2)
    return {"logit_max": top2[..., 0].mean(dim=-1),
            "logit_margin": (top2[..., 0] - top2[..., 1]).mean(dim=-1)}
