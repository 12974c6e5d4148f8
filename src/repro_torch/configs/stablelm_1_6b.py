"""StableLM 2 1.6B -- LN + partial rotary, MHA [hf:stabilityai/stablelm-2-1_6b]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352,
    norm="ln", rope_pct=0.25,
    source="hf:stabilityai/stablelm-2-1_6b; partial rotary 25%",
)
