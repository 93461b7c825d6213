"""Command R+ 104B: GQA kv=8, no-bias LayerNorm, huge vocab.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from . import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000,
    mlp="gated", norm="ln", pos="rope", tie_embeddings=True,
)
