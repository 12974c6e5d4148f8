"""Architecture registry: --arch <id> resolves here.

The port's own copy of `repro.configs` (pure-Python dataclasses, the
same published numbers); it imports nothing of the reference."""
from . import (arctic_480b, chameleon_34b, granite_8b, jamba_v01_52b,
               kimi_k2_1t_a32b, qwen2_72b, rwkv6_3b, stablelm_1_6b,
               starcoder2_15b, whisper_large_v3)
from .base import SHAPES, ModelConfig, ShapeConfig, applicable_shapes

_MODULES = [kimi_k2_1t_a32b, arctic_480b, whisper_large_v3, rwkv6_3b,
            jamba_v01_52b, granite_8b, stablelm_1_6b, starcoder2_15b,
            qwen2_72b, chameleon_34b]

CONFIGS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_IDS = sorted(CONFIGS)


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch '{name}'; have {ARCH_IDS}")
    return CONFIGS[name]
