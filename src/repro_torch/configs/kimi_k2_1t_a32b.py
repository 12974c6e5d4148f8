"""Kimi K2 -- trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, head_dim=112,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert_ff=2048,
                  n_shared_experts=1, first_moe_layer=1),
    source="arXiv:2501.kimi2 (paper-table); first layer dense, 1 shared expert",
)
