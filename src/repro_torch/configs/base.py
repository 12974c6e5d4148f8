"""Config system: one dataclass covers all ten assigned architectures.

Every architecture file in this package instantiates `ModelConfig` with the
exact published numbers and registers it.  `reduced()` derives the tiny
same-family config used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# families: dense | moe | ssm | hybrid | encdec | vlm
# block kinds (hybrid layouts): 'attn' | 'mamba' | 'rwkv'


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int            # per-expert FFN hidden size
    n_shared_experts: int = 0   # always-on experts (Kimi K2 style)
    dense_residual: bool = False  # dense FFN in parallel with MoE (Arctic)
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss_weight: float = 1e-2
    # which layers are MoE: every `every`-th layer starting at `first`
    first_moe_layer: int = 0
    moe_every: int = 1


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # attention details
    head_dim: Optional[int] = None      # default d_model // n_heads
    qkv_bias: bool = False              # Qwen2
    qk_norm: bool = False               # Chameleon
    rope_theta: float = 10000.0
    rope_pct: float = 1.0               # StableLM partial rotary
    norm: str = "rms"                   # rms | ln
    act: str = "swiglu"                 # swiglu | gelu
    tie_embeddings: bool = False
    attn_window: Optional[int] = None   # sliding-window (banded) attention
    # hybrid layout: pattern of block kinds, tiled over n_layers
    block_pattern: Tuple[str, ...] = ("attn",)
    # subconfigs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # enc-dec (whisper)
    is_encdec: bool = False
    n_encoder_layers: int = 0
    decoder_len: int = 448              # whisper text context
    # long-context capability: True when decode state is O(1) or banded
    subquadratic: bool = False
    # numerics
    dtype: str = "bfloat16"
    # notes for DESIGN.md arch table
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def is_moe_layer(self, layer: int) -> bool:
        if self.moe is None:
            return False
        m = self.moe
        return layer >= m.first_moe_layer and \
            (layer - m.first_moe_layer) % m.moe_every == 0

    def param_count(self) -> float:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        hd = self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb
        enc_layers = self.n_encoder_layers if self.is_encdec else 0
        for layer in range(L + enc_layers):
            kind = self.block_kind(layer % max(L, 1))
            if kind == "attn":
                attn = d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd) \
                    + (self.n_heads * hd) * d
                total += attn
                if self.is_encdec and layer < L:   # decoder cross-attn
                    total += attn
            elif kind == "mamba":
                s = self.ssm or SSMConfig()
                di = s.expand * d
                total += d * di * 2 + di * (2 * s.d_state + 2) + di * d \
                    + di * s.d_conv
            elif kind == "rwkv":
                total += 4 * d * d + 6 * d   # r,k,v,o + decay/bonus params
            if self.is_moe_layer(layer % max(L, 1)):
                m = self.moe
                experts = m.n_experts + m.n_shared_experts
                total += experts * 3 * d * m.d_expert_ff
                total += d * m.n_experts  # router
                if m.dense_residual:
                    total += 3 * d * ff
            elif kind in ("attn", "mamba"):
                n_mats = 3 if self.act == "swiglu" else 2
                total += n_mats * d * ff
            elif kind == "rwkv":
                total += 3 * d * ff          # rwkv channel mix (r,k,v)
        return float(total)

    def active_param_count(self) -> float:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        expert_all = sum(
            (m.n_experts - m.top_k) * 3 * self.d_model * m.d_expert_ff
            for layer in range(self.n_layers) if self.is_moe_layer(layer))
        return float(full - expert_all)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kwargs = dataclasses.asdict(self)
        kwargs.update(
            n_layers=min(self.n_layers, 2 * len(self.block_pattern)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=256,
            vocab=512,
            head_dim=32,
        )
        if self.moe is not None:
            kwargs["moe"] = MoEConfig(
                n_experts=4, top_k=min(self.moe.top_k, 2), d_expert_ff=64,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                dense_residual=self.moe.dense_residual,
                first_moe_layer=min(self.moe.first_moe_layer, 1),
                moe_every=self.moe.moe_every,
            )
        else:
            kwargs["moe"] = None
        if self.ssm is not None:
            kwargs["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2)
        else:
            kwargs["ssm"] = None
        kwargs["block_pattern"] = tuple(self.block_pattern)
        if self.is_encdec:
            kwargs["n_encoder_layers"] = 2
            kwargs["decoder_len"] = 32
        return ModelConfig(**kwargs)


# ---------------------------------------------------------------------------
# Input shape sets (assigned): every LM arch runs all four unless skipped
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k only for sub-quadratic archs (assignment rule)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out
