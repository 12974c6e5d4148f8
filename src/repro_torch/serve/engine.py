"""Decode engine: continuous batching over the model API -- the
counterpart of `repro.serve.engine`.

The engine owns a fixed-capacity slot batch and drives the Scheduler:

    loop:
      admit_waiting()  -> prefill new slots (per-slot prefill, padded)
      pre_decode()     -> extend block tables / preempt
      decode step      -> one token for every slot (inactive: token 0)
      post_decode()    -> sampling, EOS bookkeeping, slot recycling

Each prompt runs into a fresh width-1 cache, padded to a power-of-two
bucket (at most max_context), then is merged into the batch cache at its
slot with its true length as pos.  The restamped pos hides the pad
tokens (id 0) from attention; a Mamba or RWKV state and the MoE
capacity consume them, as the reference's do (ROADMAP C7).  Prompts go through the flash kernel,
decode steps through the paged kernel over the dense cache
(`models/common.py`); `use_kernels=False` runs the plain attention.  An
inactive slot's pos keeps growing, as in the reference; past max_context
its writes are dropped and it attends to the whole cache.

The engine serves decoder-only configs: an encoder-decoder raises
NotImplementedError with the reference launcher's words (its own engine
never takes one; `models.whisper` runs through `registry.get_model`).

Sampling: greedy takes the first index of the largest bfloat16 logit,
as the reference's argmax of their float32 cast does.  Temperature
sampling draws from a `torch.Generator` on the engine's device seeded
with `ecfg.seed`: the same distribution as the reference's
`jax.random.categorical`, not its threefry stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry, transformer
from .kv_blocks import PoolConfig
from .scheduler import Request, Scheduler


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    max_context: int = 512
    block_size: int = 16
    pool_blocks: Optional[int] = None   # default: 75% of dense worst case
    temperature: float = 0.0            # 0 => greedy
    seed: int = 0


def require_decoder_only(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: serve launcher drives decoder-only archs")


class Engine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 use_kernels: bool = True):
        require_decoder_only(cfg)
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.use_kernels = use_kernels
        self.device = params["embed"].device
        worst = ecfg.max_batch * (ecfg.max_context // ecfg.block_size)
        pool_cfg = PoolConfig(
            n_blocks=ecfg.pool_blocks or max(int(0.75 * worst), 1),
            block_size=ecfg.block_size,
            max_blocks_per_seq=ecfg.max_context // ecfg.block_size,
        )
        self.sched = Scheduler(pool_cfg, ecfg.max_batch)
        self.cache = transformer.init_cache(cfg, ecfg.max_batch,
                                            ecfg.max_context, self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(ecfg.seed)
        #: host seconds of each prefill (with its sampling), by bucket,
        #: and of each decode step (tokens in to tokens sampled)
        self.prefill_times: List[tuple] = []
        self.decode_times: List[float] = []

    # -- per-slot prefill -----------------------------------------------------

    def bucket(self, plen: int) -> int:
        """Prompts are bucketed to power-of-two lengths, at most
        max_context."""
        bucket = 1
        while bucket < plen:
            bucket *= 2
        return min(bucket, self.ecfg.max_context)

    def prefill_slot(self, slot_id: int, prompt: List[int]) -> torch.Tensor:
        """Run the prompt through the model into this slot's cache rows;
        returns the next-token logits (V,) of the last REAL position."""
        plen = len(prompt)
        toks = torch.zeros((1, self.bucket(plen)), dtype=torch.int32)
        toks[0, :plen] = torch.tensor(prompt, dtype=torch.int32)
        sub = transformer.init_cache(self.cfg, 1, self.ecfg.max_context,
                                     self.device)
        x, new_sub, _ = transformer.forward(
            self.params, self.cfg, tokens=toks.to(self.device), cache=sub,
            use_kernels=self.use_kernels, cache_start=0)
        new_sub = _restamp_pos(new_sub, torch.tensor(
            [plen], dtype=torch.int32, device=self.device))
        self.cache = transformer.merge_cache(self.cache, new_sub, slot_id)
        return x[0, plen - 1] @ transformer.head_matrix(self.params, self.cfg)

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step of every slot: tokens (B, 1) -> logits (B, V)."""
        logits, self.cache = transformer.decode_step(
            self.params, self.cfg, self.cache, tokens,
            use_kernels=self.use_kernels)
        return logits[:, 0]

    # -- main loop ------------------------------------------------------------

    def run(self, requests: List[Request], max_steps: int = 10_000
            ) -> Dict[int, List[int]]:
        for r in requests:
            self.sched.submit(r)

        steps = 0
        while not self.sched.idle and steps < max_steps:
            steps += 1
            self.sched.tick()

            for slot in self.sched.admit_waiting():
                t0 = time.perf_counter()
                logits = self.prefill_slot(slot.slot_id, slot.req.prompt)
                tok = self._sample(logits[None])[0]
                self.prefill_times.append(
                    (self.bucket(len(slot.req.prompt)),
                     time.perf_counter() - t0))
                self.sched.post_decode(slot, tok)

            active = self.sched.pre_decode()
            if not active:
                continue
            t0 = time.perf_counter()
            tokens = torch.zeros((self.ecfg.max_batch, 1), dtype=torch.int32)
            for slot in active:
                seq = slot.req.prompt + slot.req.generated
                tokens[slot.slot_id, 0] = seq[-1]
            sampled = self._sample(self.decode(tokens.to(self.device)))
            self.decode_times.append(time.perf_counter() - t0)
            for slot in list(active):
                self.sched.post_decode(slot, sampled[slot.slot_id])

        return {r.req_id: r.generated for r in self.sched.finished}

    def _sample(self, logits: torch.Tensor) -> List[int]:
        """(n, V) logits -> n token ids."""
        if self.ecfg.temperature <= 0.0:
            return logits.argmax(dim=-1).tolist()
        probs = torch.softmax(logits.float() / self.ecfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0].tolist()


def _restamp_pos(cache, pos):
    out = dict(cache)
    out["pos"] = pos
    return out


def make_engine(cfg: ModelConfig, params=None,
                gen: Optional[torch.Generator] = None,
                ecfg: Optional[EngineConfig] = None, device=None,
                use_kernels: bool = True) -> Engine:
    """An engine over `params`, or over seeded ones made on `device`
    (None = the card) from `gen` (None = seed 0)."""
    require_decoder_only(cfg)
    ecfg = ecfg or EngineConfig()
    if params is None:
        params = registry.get_model(cfg).init(gen, device)
    return Engine(cfg, params, ecfg, use_kernels=use_kernels)
