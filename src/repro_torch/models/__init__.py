"""The LM scaffold's models on PyTorch: decoder LMs over attention,
Mamba and RWKV blocks with dense or MoE feed-forwards, and the
Whisper-style encoder-decoder (every config of the reference), the
reference's API and the carrier of its parameters."""
from . import (common, convert, mamba, moe, registry, rwkv6, transformer,
               tuning, whisper)
from .registry import ModelAPI, get_model

__all__ = ["common", "convert", "mamba", "moe", "registry", "rwkv6",
           "transformer", "tuning", "whisper", "ModelAPI", "get_model"]
