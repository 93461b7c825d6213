"""RWKV6 (Finch) 3B: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from . import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab=65536,
    block_pattern=("rwkv",), mlp="plain", norm="ln", pos="none",
    rwkv_head_dim=64, long_context_ok=True,
    notes="Matrix-valued state per head; O(1) decode state (500k cell runs).",
)
