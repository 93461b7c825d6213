"""DeepSeek-7B: llama-arch dense, MHA (kv=32). [arXiv:2401.02954; hf]"""
from . import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400,
    mlp="gated", norm="rms", pos="rope",
)
