"""The launcher's per-arch optimizer choice (counterpart of the part of
`repro.launch.steps` the training launcher needs).  The reference's
step-plan builders (`build_train_plan`, `build_prefill_plan`,
`build_decode_plan`, `LoweredPlan`) lower JAX shardings for its multi-pod
dry-run and wait for it (ROADMAP A11, slice 3d)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.optim import OptimizerConfig

# Arch -> optimizer: AdamW's 8 B/param fp32 moments do not fit for the
# >= 200B-param configs on 256 x 16 GiB chips; they use factored Adafactor
# (DESIGN.md §8 "giant-model memory honesty").
ADAFACTOR_THRESHOLD = 2.0e11


def optimizer_for(cfg: ModelConfig) -> OptimizerConfig:
    name = "adafactor" if cfg.param_count() > ADAFACTOR_THRESHOLD else "adamw"
    return OptimizerConfig(name=name)
