"""Chameleon 34B -- early-fusion VLM, VQ image tokens, qk-norm [arXiv:2405.09818]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536,
    qk_norm=True,
    source="arXiv:2405.09818; patch-token embeddings via frontend stub",
)
