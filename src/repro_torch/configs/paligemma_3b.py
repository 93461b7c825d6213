"""PaliGemma-3B backbone: gemma-2b decoder + SigLIP STUB frontend
(input_specs provides 256 precomputed patch embeddings). [arXiv:2407.07726]"""
from . import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257216, head_dim=256,
    prefix_tokens=256, tie_embeddings=True, scale_embeds=True,
    mlp="gated", norm="rms", pos="rope",
    notes="Prefix (image) tokens attend bidirectionally; text causal.",
)
