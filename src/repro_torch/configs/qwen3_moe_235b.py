"""Qwen3-MoE 235B-A22B-class: 128 experts top-8, GQA kv=4, QK-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from . import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8),
    mlp="gated", norm="rms", pos="rope", qk_norm=True, rope_theta=1e6,
)
