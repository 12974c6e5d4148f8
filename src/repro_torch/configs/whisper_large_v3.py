"""Whisper large-v3 -- enc-dec audio transformer, conv frontend stubbed [arXiv:2212.04356]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866,
    norm="ln", act="gelu", rope_pct=0.0,       # learned/sinusoidal positions
    is_encdec=True, n_encoder_layers=32, decoder_len=448,
    source="arXiv:2212.04356; frontend stub provides frame embeddings",
)
