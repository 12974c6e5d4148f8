"""The bfloat16 tolerance that the card tests and `chip_smoke.py` hold
each kernel to against its plain version: one copy, so they cannot
drift apart."""
from __future__ import annotations

import numpy as np
import torch

BF16_ULP_FLOOR = 2.0 ** -8      # smallest |value| a bf16 ulp is taken at


def within_bf16_ulp(got, want) -> bool:
    """Every |got - want| within one bfloat16 ulp of want, 2^(e - 7) for
    |want| in [2^e, 2^(e+1)), taken at no less than |want| = 2^-8: two
    float32 results that differ by their summation order (about 1e-6)
    and are each rounded to bfloat16 once land within one ulp of each
    other wherever a ulp exceeds that difference, which is not so for
    outputs near 0.  NaN where want is NaN.  Tensors on any device, or
    arrays."""

    def f32(a):
        if isinstance(a, torch.Tensor):
            return a.detach().float()
        return torch.from_numpy(np.array(a, dtype=np.float32))

    g, w = f32(got), f32(want)
    g = g.to(w.device)
    nan = torch.isnan(w)
    if not torch.equal(nan, torch.isnan(g)):
        return False
    g, w = g[~nan], w[~nan]
    mag = w.abs().clamp(min=BF16_ULP_FLOOR)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((g - w).abs() <= ulp).all())
