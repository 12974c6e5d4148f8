"""Performance knobs: the counterpart of `repro.models.tuning`, with the
reference's knobs, profiles and values.

    from repro_torch.models import tuning
    tuning.set_profile("baseline")   # the reference's first lowering
    tuning.set_profile("optimized")  # its shipping defaults

Two knobs change what the port runs on one device:

  rwkv_chunked_scan   a prompt whose length is a multiple of 256 runs
                      the two-level chunked wkv recurrence
                      (`rwkv6._wkv_chunked`) instead of the per-token one
  mamba_fused_params  under autograd, each chunk of Mamba's scan is
                      recomputed in the backward pass
                      (`torch.utils.checkpoint`), so the (B, chunk, di,
                      ds) tensors are never saved

Three more act under a mesh (`distributed.api.use_mesh`), where the
port reads them as the reference does (`models/moe.py`):

  moe_combine_bf16              `apply_moe_sharded` sums its combine
                                over 'model' in bfloat16, not float32
  moe_all_to_all                `apply_moe_auto` takes `apply_moe_a2a`
                                (when the sequence splits over 'model')
                                instead of `apply_moe_sharded`
  moe_decode_weight_stationary  `apply_moe_auto` takes
                                `apply_moe_decode` for one-token steps

`sequence_parallel` and `rwkv_batch_shard` only pick the specs of
`constrain`, which moves no values (every rank holds the global
activations), and `attn_chunk_remat`, `causal_chunk_unroll` and
`kv_onehot_write` pick between lowerings of the same function in JAX.
The port reads none of these five.
"""
from __future__ import annotations

attn_chunk_remat: bool = True
sequence_parallel: bool = True
moe_combine_bf16: bool = True
moe_all_to_all: bool = True
moe_decode_weight_stationary: bool = True
causal_chunk_unroll: bool = True
mamba_fused_params: bool = True
rwkv_chunked_scan: bool = True
rwkv_batch_shard: bool = True
kv_onehot_write: bool = True

_PROFILES = {
    "baseline": dict(attn_chunk_remat=False, sequence_parallel=False,
                     moe_combine_bf16=False, moe_all_to_all=False,
                     causal_chunk_unroll=False, rwkv_chunked_scan=False,
                     rwkv_batch_shard=False, kv_onehot_write=False,
                     moe_decode_weight_stationary=False,
                     mamba_fused_params=False),
    "optimized": dict(attn_chunk_remat=True, sequence_parallel=True,
                      moe_combine_bf16=True, moe_all_to_all=False,
                      causal_chunk_unroll=True, rwkv_chunked_scan=True,
                      rwkv_batch_shard=False, kv_onehot_write=True,
                      moe_decode_weight_stationary=True,
                      mamba_fused_params=True),
}


def set_profile(name: str) -> None:
    g = globals()
    for k, v in _PROFILES[name].items():
        g[k] = v


def set_knob(name: str, value: bool) -> None:
    if name not in _PROFILES["baseline"]:
        raise KeyError(name)
    globals()[name] = value


def snapshot() -> dict:
    return {k: globals()[k] for k in _PROFILES["baseline"]}
