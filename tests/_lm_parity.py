"""Shared inputs of the LM parity tests (`tests/test_torch_lm*.py`,
`tests/test_torch_whisper.py`, `tests/test_torch_train.py`):
the same parameters and inputs for the reference and the port.

Both packages get the reference's seeded parameter tree, its zero biases
(Mamba's conv and dt biases and RWKV's w0 too), unit norm scales and
Mamba's D, and RWKV's 0.5 token-shift mixes replaced by seeded noise
(so every such parameter is exercised), as numpy leaves: to the
reference as jnp arrays, to the port through
`convert.params_from_reference`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import CONFIGS as R_CONFIGS
from repro.models import registry as rreg
from repro_torch.configs import CONFIGS
from repro_torch.device import to_tensor
from repro_torch.models import common as tcommon, convert
from repro_torch.tree import tree_map

TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=0.08, atol=0.08)}


def configs(arch, dtype="bfloat16"):
    rc = dataclasses.replace(R_CONFIGS[arch].reduced(), dtype=dtype)
    tc = dataclasses.replace(CONFIGS[arch].reduced(), dtype=dtype)
    return rc, tc


def _perturb(tree, rng, path=()):
    """Biases and norm parameters -> seeded noise (they init to 0 / 1)."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_perturb(v, rng, path) for v in tree]
    a = np.asarray(tree)
    name = path[-1]
    if name in ("bq", "bk", "bv", "bias", "conv_b", "dt_bias", "w0"):
        return (rng.normal(size=a.shape) * 0.1).astype(a.dtype)
    if name in ("scale", "D"):
        return (1.0 + rng.normal(size=a.shape) * 0.1).astype(a.dtype)
    if name.startswith("mix_"):
        return (0.5 + rng.normal(size=a.shape) * 0.1).astype(a.dtype)
    return a


def shared_params(rc, tc, seed=1):
    """(reference params as jnp, port params on the CPU), equal leaves."""
    ref = rreg.get_model(rc).init(jax.random.PRNGKey(seed))
    leaves = _perturb(jax.tree.map(np.asarray, ref),
                      np.random.default_rng(seed))
    ref = jax.tree.map(jnp.asarray, leaves)
    return ref, convert.params_from_reference(leaves, tc, device="cpu")


def inputs(tc, batch, seq, seed=2):
    """The same (reference, port) model inputs: tokens, or embeds for
    the early-fusion VLM."""
    rng = np.random.default_rng(seed)
    if tc.family == "vlm":
        e = rng.normal(size=(batch, seq, tc.d_model)).astype(np.float32)
        rdt = jnp.bfloat16 if tc.dtype == "bfloat16" else jnp.float32
        return ({"embeds": jnp.asarray(e, dtype=rdt)},
                {"embeds": torch.from_numpy(e).to(tcommon.dtype_of(tc))})
    toks = rng.integers(0, tc.vocab, (batch, seq)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def frames(tc, batch, n, seed=3):
    """The same (reference, port) stub frame embeddings (batch, n, d) of
    the encoder-decoder, in the config's dtype."""
    e = np.random.default_rng(seed).normal(
        size=(batch, n, tc.d_model)).astype(np.float32)
    rdt = jnp.bfloat16 if tc.dtype == "bfloat16" else jnp.float32
    return jnp.asarray(e, dtype=rdt), torch.from_numpy(e).to(
        tcommon.dtype_of(tc))


def cut(batch, lo, hi):
    return {k: v[:, lo:hi] for k, v in batch.items()}


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def shared_train_params(rc, seed=1):
    """The trainer's state in both packages: (reference params as jnp,
    the same tree -- the reference's stacked layout -- as port tensors on
    the CPU, copied so in-place updates touch no reference buffer)."""
    ref = rreg.get_model(rc).init(jax.random.PRNGKey(seed))
    leaves = _perturb(jax.tree.map(np.asarray, ref),
                      np.random.default_rng(seed))
    port = tree_map(lambda a: to_tensor(a, "cpu").clone(), leaves)
    return jax.tree.map(jnp.asarray, leaves), port


def train_batch(vocab, batch, seq, seed):
    """One (reference, port) batch of tokens and next-token labels."""
    toks = np.random.default_rng(seed).integers(
        0, vocab, (batch, seq + 1)).astype(np.int32)
    ref = {"tokens": jnp.asarray(toks[:, :-1]),
           "labels": jnp.asarray(toks[:, 1:])}
    port = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}
    return ref, port
