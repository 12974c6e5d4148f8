"""Deterministic, resumable, sharded data pipeline: the counterpart of
`repro.data.pipeline`.

  * determinism  -- batch `i` is a pure function of (seed, i); restart at
                    step N reproduces exactly the batches N, N+1, ...
  * sharding     -- host h of H draws only its 1/H slice of the global
                    batch (no coordination, no duplicate samples);
  * resumability -- pipeline state is one integer (the step), checkpointed
                    next to the params.

Two sources with one interface: `SyntheticLM` (random tokens) and
`PackedFileDataset` (a memory-mapped token file, for real corpora).
Batches are {'tokens', 'labels'}: int32 tensors on the pipeline's device
(None = the card), labels the tokens shifted by one.

`SyntheticLM`'s tokens are not the reference's: the reference draws
them with JAX's threefry, which the port does not re-create.  Batch `i`
of host `h` comes from a CPU `torch.Generator` seeded with a splitmix64
mix of (seed, i, h) and then moves to the device, so the card and the
CPU see the same batch.  `PackedFileDataset`'s batches are the
reference's byte for byte.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    host_id: int = 0
    n_hosts: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, step: int, host_id: int) -> int:
    """The generator seed of one (step, host) batch: independent streams
    for every triple, as the reference folds step and host into its key."""
    return _splitmix64(_splitmix64(_splitmix64(seed & _MASK64) ^ step)
                       ^ host_id)


def _split(arr: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


class SyntheticLM:
    """Counter-based seeding -> O(1) state; batch i is pure f(seed, i)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step = 0

    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    def restore(self, state: Dict[str, int]):
        self.step = int(state["step"])

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        c = self.cfg
        gen = torch.Generator().manual_seed(
            stream_seed(c.seed, step, c.host_id))
        toks = torch.randint(0, c.vocab, (c.host_batch, c.seq_len + 1),
                             generator=gen, dtype=torch.int32)
        return _split(toks.to(self.device))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = self.batch_at(self.step)
        self.step += 1
        return b


class PackedFileDataset:
    """Memory-mapped uint16/uint32 token file, deterministic strided reads.

    File layout: flat token ids.  Sample j for step i is the window starting
    at ((i * global_batch + host_offset + j) * seq_len) mod usable length --
    sequential disk access, no shuffle buffer state to checkpoint.
    """

    def __init__(self, cfg: DataConfig, path: str, dtype=np.uint16,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.usable = (len(self.tokens) - 1) // cfg.seq_len
        if self.usable <= 0:
            raise ValueError(f"{path}: too few tokens for seq_len")
        self.step = 0

    def state(self):
        return {"step": self.step}

    def restore(self, state):
        self.step = int(state["step"])

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        c = self.cfg
        base = step * c.global_batch + c.host_id * c.host_batch
        rows = []
        for j in range(c.host_batch):
            w = (base + j) % self.usable
            rows.append(np.asarray(
                self.tokens[w * c.seq_len: w * c.seq_len + c.seq_len + 1],
                dtype=np.int32))
        return _split(torch.from_numpy(np.stack(rows)).to(self.device))

    def __iter__(self):
        return self

    def __next__(self):
        b = self.batch_at(self.step)
        self.step += 1
        return b


def write_token_file(path: str, tokens: np.ndarray):
    tokens.astype(np.uint16).tofile(path)


def make_pipeline(cfg: DataConfig, path: Optional[str] = None, device=None):
    if path and os.path.exists(path):
        return PackedFileDataset(cfg, path, device=device)
    return SyntheticLM(cfg, device=device)
