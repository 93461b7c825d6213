"""Model configs (own copy of the dense-decoder part of ``repro.configs``).

``get_config(arch_id)`` returns the exact published dims; ``reduced()``
yields the reference's small same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense (the only family ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    mlp: str = "gated"               # SwiGLU
    norm: str = "rms"
    pos: str = "rope"
    rope_theta: float = 10000.0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU tests (the reference's cut)."""
        return dataclasses.replace(
            self, n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2), d_ff=128, vocab=256,
            head_dim=16)


ARCH_IDS = ("llama3_8b",)


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"{arch_id!r} is not ported; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG
