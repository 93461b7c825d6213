"""Model configs (own copy of ``repro.configs``).

``get_config(arch_id)`` returns the exact published dims of each of the
reference's eleven architectures (dense, MoE, hybrid, SSM, VLM and
enc-dec families); ``reduced()`` yields the reference's small same-family
config for CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    mlp: str = "gated"               # gated (SwiGLU) | plain (GELU)
    norm: str = "rms"                # rms | ln
    pos: str = "rope"                # rope | learned | none
    rope_theta: float = 10000.0
    qk_norm: bool = False
    tie_embeddings: bool = False
    block_pattern: Tuple[str, ...] = ("attn",)   # hybrid: ("rec","rec","attn")
    window: Optional[int] = None     # sliding-window attention size
    n_encoder_layers: int = 0        # enc-dec (whisper)
    encoder_seq: int = 1500          # stub frame-embedding length
    prefix_tokens: int = 0           # vlm: stub patch-embedding prefix
    rwkv_head_dim: int = 64
    long_context_ok: bool = False    # constant-size decode state
    scale_embeds: bool = False       # gemma-style sqrt(d) embedding scale
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def param_count(self) -> int:
        """Approximate parameter count (the reference's formula)."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        mlp_dense = (3 if self.mlp == "gated" else 2) * d * f
        kinds = self._pattern_for_all_layers()
        n_attn, n_rec, n_rwkv = (kinds.count(k) for k in ("attn", "rec",
                                                         "rwkv"))
        total = 0
        if self.moe:
            moe_mlp = self.moe.n_experts * mlp_dense + d * self.moe.n_experts
            if self.moe.dense_residual:
                moe_mlp += mlp_dense
            total += n_attn * (attn + moe_mlp)
        else:
            total += n_attn * (attn + mlp_dense)
        total += n_rec * (3 * d * d + 4 * d + mlp_dense)   # rg-lru + mlp
        total += n_rwkv * (5 * d * d + 2 * d * 64 + 2 * d * f)
        total += self.n_encoder_layers * (attn + mlp_dense)
        if self.n_encoder_layers:                    # decoder cross-attn
            total += self.n_layers * attn
        emb = V * d * (1 if self.tie_embeddings else 2)
        return int(total + emb)

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6*N_active*D)."""
        if not self.moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp_dense = (3 if self.mlp == "gated" else 2) * d * f
        dense_total = self.param_count() - self.n_layers * (
            self.moe.n_experts * mlp_dense)
        return int(dense_total + self.n_layers * self.moe.top_k * mlp_dense)

    def _pattern_for_all_layers(self):
        pat = self.block_pattern
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU tests (the reference's cut;
        MoE: 4 experts, top-2)."""
        kw = dataclasses.asdict(self)
        if self.moe:
            kw["moe"] = MoEConfig(n_experts=4, top_k=min(2, self.moe.top_k),
                                  capacity_factor=self.moe.capacity_factor,
                                  dense_residual=self.moe.dense_residual)
        kw.update(
            n_layers=max(2, len(self.block_pattern)), d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128, vocab=256, head_dim=16,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            encoder_seq=16, prefix_tokens=8 if self.prefix_tokens else 0,
            window=min(self.window, 16) if self.window else None,
            rwkv_head_dim=8,
        )
        return ModelConfig(**kw)


ARCH_IDS = (
    "arctic_480b", "qwen3_moe_235b", "recurrentgemma_2b", "whisper_large_v3",
    "deepseek_7b", "command_r_plus_104b", "starcoder2_7b", "granite_20b",
    "rwkv6_3b", "paligemma_3b", "llama3_8b",
)


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG
