"""Whisper large-v3 backbone: enc-dec transformer; conv frontend is a STUB
(input_specs provides precomputed 1500-frame embeddings). [arXiv:2212.04356]"""
from . import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866,
    n_encoder_layers=32, encoder_seq=1500,
    mlp="plain", norm="ln", pos="learned",
)
