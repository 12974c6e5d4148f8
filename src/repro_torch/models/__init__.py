"""The LM scaffold's models on PyTorch: decoder LMs over attention
blocks (dense and early-fusion VLM configs), the reference's API and the
carrier of its parameters."""
from . import common, convert, registry, transformer
from .registry import ModelAPI, get_model

__all__ = ["common", "convert", "registry", "transformer", "ModelAPI",
           "get_model"]
