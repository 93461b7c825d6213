"""Snowflake Arctic 480B: dense-MoE hybrid, 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from . import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    moe=MoEConfig(n_experts=128, top_k=2, dense_residual=True),
    mlp="gated", norm="rms", pos="rope",
    notes="MoE in parallel with a dense residual MLP on every layer.",
)
