"""Jamba v0.1 -- Mamba+attention 1:7 interleave with 16-expert MoE [arXiv:2403.19887]."""
from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536,
    # 1 attention layer per 8 (1:7 attn:mamba), MoE every 2 layers
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert_ff=14336,
                  first_moe_layer=1, moe_every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    subquadratic=True,
    source="arXiv:2403.19887; 4 attn layers of 32, KV tiny at 500k",
)
