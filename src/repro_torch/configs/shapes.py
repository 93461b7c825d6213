"""Assigned input-shape cells (seq_len x global_batch) and applicability
(own copy of ``repro.configs.shapes``)."""
from __future__ import annotations

import dataclasses

from . import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the brief's applicability rules."""
    if cell.name == "long_500k" and not cfg.long_context_ok:
        return False, ("pure full-attention arch: 500k decode state is "
                       "unbounded (quadratic attention / O(S) KV cache); "
                       "run only for SSM/hybrid archs per the brief")
    return True, ""
