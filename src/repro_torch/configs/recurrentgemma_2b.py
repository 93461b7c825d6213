"""RecurrentGemma-2B (Griffin): RG-LRU + local attention, 2:1 pattern.
[arXiv:2402.19427; hf]"""
from . import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    block_pattern=("rec", "rec", "attn"), window=2048,
    mlp="gated", norm="rms", pos="rope", tie_embeddings=True, scale_embeds=True,
    long_context_ok=True,
    notes="RG-LRU recurrence; local attention window 2048 -> O(1) decode state.",
)
