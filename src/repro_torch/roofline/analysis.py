"""Roofline analysis of traced steps: the counterpart of
`repro.roofline.analysis`.

Three terms per (arch x shape x mesh), all in seconds a step per card:

    compute    = counted FLOPs / peak FLOP/s
    memory     = counted bytes / HBM bandwidth
    collective = collective wire bytes / link bandwidth

The counts come from `op_costs`: the step traced once, every op priced
(the reference reads them from compiled HLO).

Hardware constants: one NVIDIA H100 SXM (H100 80GB HBM3) at its 700 W
power limit -- 989e12 FLOP/s bf16 dense on the tensor cores, 3.35e12
B/s HBM3, 450e9 B/s of NVLink each way.  A card set below 700 W runs
slower under load; `analyze` takes the rates as arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .op_costs import Costs

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


@dataclasses.dataclass
class Roofline:
    flops: float                 # per card per step
    hbm_bytes: float             # per card per step
    collective_bytes: float      # wire bytes per card per step
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # 6 * N_active * tokens (whole job)
    useful_flops_frac: float     # model_flops / (cards * counted FLOPs)
    collectives: Dict[str, float]
    collective_counts: Dict[str, int]

    def summary(self) -> str:
        return (f"compute {self.compute_s*1e3:8.3f} ms | "
                f"memory {self.memory_s*1e3:8.3f} ms | "
                f"collective {self.collective_s*1e3:8.3f} ms "
                f"-> {self.bottleneck}-bound; "
                f"useful-FLOP frac {self.useful_flops_frac:5.3f}")


def analyze(costs: Costs, *, n_chips: int, model_flops: float = 0.0,
            peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
            link_bw: float = LINK_BW) -> Roofline:
    """The roofline of one step's counted `costs` on each of `n_chips`
    cards."""
    flops = costs.flops
    hbm = costs.bytes
    compute_s = flops / peak_flops
    memory_s = hbm / hbm_bw
    collective_s = costs.total_collective_bytes / link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    total = flops * n_chips
    return Roofline(
        flops=flops, hbm_bytes=hbm,
        collective_bytes=costs.total_collective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_flops_frac=(model_flops / total) if total else 0.0,
        collectives=dict(costs.collective_bytes),
        collective_counts={k: int(v) for k, v in
                           costs.collective_counts.items()},
    )


def model_flops_train(n_active_params: float, n_tokens: float) -> float:
    return 6.0 * n_active_params * n_tokens


def model_flops_decode(n_active_params: float, n_tokens: float) -> float:
    return 2.0 * n_active_params * n_tokens
