"""LLaMA-3-8B — the paper's case-study model (Sec. V). [arXiv:2407.21783]"""
from . import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    mlp="gated", norm="rms", pos="rope", rope_theta=5e5,
)
