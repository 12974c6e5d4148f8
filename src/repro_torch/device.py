"""Where the port runs: the explicit device of every entry point.

Entry points (generators, `csr_from_numpy`, `plan.compile`, the graph
drivers) take `device=None`, which means the card.  Without a card they
refuse rather than quietly running the plain versions on the CPU; a
caller who wants the CPU asks for it with `device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """None -> "cuda" (the current card, with its index); a CUDA device
    without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_numpy(a) -> np.ndarray:
    """Host numpy view (or copy, for a device tensor) of a tensor or
    array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_tensor(a, device) -> torch.Tensor:
    """numpy array -> tensor on `device`, keeping its dtype and bytes; a
    bfloat16 array (numpy's `ml_dtypes` type, which `torch.from_numpy`
    refuses) crosses as its raw 16-bit words."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.require(np.asarray(a), requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def stable_argsort(keys: np.ndarray, device=None) -> np.ndarray:
    """`np.argsort(keys, kind="stable")`, sorted on `device`.

    A stable sort's permutation is unique, so the result is the same
    wherever it runs; on the card tens of millions of keys sort in
    milliseconds instead of seconds of host time."""
    if device is None or torch.device(device).type == "cpu":
        return np.argsort(keys, kind="stable")
    t = torch.from_numpy(np.ascontiguousarray(keys)).to(device)
    return torch.sort(t, stable=True).indices.cpu().numpy()


def unique(keys: np.ndarray, device=None) -> np.ndarray:
    """`np.unique(keys)` (1-D, sorted), computed on `device`."""
    if device is None or torch.device(device).type == "cpu":
        return np.unique(keys)
    t = torch.from_numpy(np.ascontiguousarray(keys)).to(device)
    return torch.unique(t, sorted=True).cpu().numpy()


def unique_inverse(keys: np.ndarray, device=None):
    """`np.unique(keys, return_inverse=True)` (1-D), computed on
    `device`."""
    if device is None or torch.device(device).type == "cpu":
        uniq, inv = np.unique(keys, return_inverse=True)
        return uniq, inv.reshape(-1)
    t = torch.from_numpy(np.ascontiguousarray(keys)).to(device)
    uniq, inv = torch.unique(t, sorted=True, return_inverse=True)
    return uniq.cpu().numpy(), inv.cpu().numpy()
