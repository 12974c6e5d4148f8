"""StarCoder2 15B -- GQA kv=4, RoPE, gelu [arXiv:2402.19173]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152,
    norm="ln", act="gelu", qkv_bias=True,
    source="arXiv:2402.19173; GQA kv=4 stresses KV-gather path",
)
