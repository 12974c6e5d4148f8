"""Staged cycle accounting and the topdown metric tree over hardware
events.

Counterpart of `repro.telemetry.topdown`, pure Python:

  * `TopdownStages` / `stage_cycles` / `machine_stages` -- every
    simulated SpMV cycle attributed to one category (Retiring,
    Frontend, Backend-{L1, L2, LLC, DRAM, contention, bandwidth}); the
    stages sum bit-exactly to the total, because the total is defined
    as their left-to-right sum over `STAGE_FIELDS`
    (`parallel.parallel_metrics` uses it);
  * `topdown_tree` / `topdown_summary` -- the VTune-style tree the paper
    reads (bound split, per-level effectiveness, MPKI family, prefetch
    coverage and accuracy, mechanism service rates), flattened into
    `TopdownSummary` rows.

Latency attribution uses the machine model's constants
(`l3_hit_cycles`, `dram_cycles`, `mlp`), as the analytic model does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

from . import events as ev
from .events import EventCounters

# CSR SpMV inner-loop issue cost per nonzero, load-port bound (same constant
# as cache_model.analytic_metrics_from_profile)
COMPUTE_CPN = 2.9
# victim/miss-cache/stream-buffer hits are near-side fills, not DRAM trips
MECH_HIT_CYCLES = 3.0

# Canonical stage order.  `TopdownStages.total_cycles()` sums the fields
# in THIS order, left to right -- the single definition both the time
# model and the reports use, which is what makes the exactness contract
# bitwise rather than approximate.
STAGE_FIELDS = ("retiring", "frontend", "backend_l1", "backend_l2",
                "backend_llc", "backend_dram", "backend_contention",
                "backend_bandwidth")


@dataclasses.dataclass(frozen=True)
class TopdownStages:
    """One run's cycles attributed to topdown categories (all in cycles).

    retiring            useful SpMV issue work (nnz x COMPUTE_CPN)
    frontend            instruction-delivery excess when SMT
                        oversubscription shares issue ports
    backend_l1          demand hits in the private first level(s) --
                        latency hidden by the OOO window in this model,
                        so the stage is identically 0; it is kept so the
                        accounting names every level it *considered*
    backend_l2          L2 misses served near-side by the paper's §V
                        structures (victim/miss cache, stream buffers)
                        at MECH_HIT_CYCLES
    backend_llc         L2 misses served by the (shared) LLC
    backend_dram        demand lines fetched from DRAM (latency)
    backend_contention  queueing inflation of miss latency near DRAM
                        bandwidth saturation
    backend_bandwidth   per-socket DRAM bandwidth floor: cycles the
                        socket's memory link needs beyond the critical
                        thread's latency estimate
    """

    retiring: float = 0.0
    frontend: float = 0.0
    backend_l1: float = 0.0
    backend_l2: float = 0.0
    backend_llc: float = 0.0
    backend_dram: float = 0.0
    backend_contention: float = 0.0
    backend_bandwidth: float = 0.0

    def total_cycles(self) -> float:
        """THE canonical total: left-to-right sum over STAGE_FIELDS.

        `repro_torch.parallel.parallel_metrics` defines its cycle total via
        this method, so `sum(stages) == metrics.total_cycles` is exact
        by construction, not within tolerance."""
        total = 0.0
        for f in STAGE_FIELDS:
            total = total + getattr(self, f)
        return total

    def fractions(self) -> Dict[str, float]:
        """Stage shares of the total (all 0.0 for an empty run)."""
        total = self.total_cycles()
        if total <= 0.0:
            return {f: 0.0 for f in STAGE_FIELDS}
        return {f: getattr(self, f) / total for f in STAGE_FIELDS}

    def bound(self) -> str:
        """Name of the dominant stage (ties break in STAGE_FIELDS order)."""
        best, best_v = STAGE_FIELDS[0], getattr(self, STAGE_FIELDS[0])
        for f in STAGE_FIELDS[1:]:
            v = getattr(self, f)
            if v > best_v:
                best, best_v = f, v
        return best

    def memory_frac(self) -> float:
        """Share of cycles stalled on the memory system (everything past
        the frontend/retiring split)."""
        total = self.total_cycles()
        if total <= 0.0:
            return 0.0
        mem = (self.backend_l1 + self.backend_l2 + self.backend_llc
               + self.backend_dram + self.backend_contention
               + self.backend_bandwidth)
        return mem / total

    def as_dict(self) -> Dict[str, float]:
        return {f: getattr(self, f) for f in STAGE_FIELDS}

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "TopdownStages":
        return cls(**{f: float(d.get(f, 0.0)) for f in STAGE_FIELDS})


def stage_cycles(c: EventCounters, machine, nnz: int,
                 smt_factor: float = 1.0,
                 queue_factor: float = 1.0) -> TopdownStages:
    """Attribute one thread's replay to topdown stages.

    `machine` is a `MachineModel`-shaped object.  `smt_factor` >= 1 is
    the issue-port oversubscription multiplier (threads beyond the
    socket's cores share ports; the excess is instruction-delivery
    pressure, i.e. frontend-bound).  `queue_factor` >= 1 inflates the
    miss stalls near DRAM saturation; the inflation lands in
    `backend_contention`.  The bandwidth stage belongs to the machine
    roll-up (`machine_stages`), not to a single thread.
    """
    retiring = nnz * COMPUTE_CPN
    frontend = retiring * (smt_factor - 1.0) if smt_factor > 1.0 else 0.0
    mech_hits = c[ev.VICTIM_HIT] + c[ev.MISS_CACHE_HIT] + c[ev.STREAM_HIT]
    backend_l2 = mech_hits * MECH_HIT_CYCLES / machine.mlp
    backend_llc = c[ev.L3_DEMAND_HIT] * machine.l3_hit_cycles / machine.mlp
    backend_dram = c[ev.L3_DEMAND_MISS] * machine.dram_cycles / machine.mlp
    if queue_factor > 1.0:
        stall = backend_l2 + backend_llc + backend_dram
        contention = stall * queue_factor - stall
    else:
        contention = 0.0
    return TopdownStages(
        retiring=retiring, frontend=frontend,
        backend_l1=0.0, backend_l2=backend_l2,
        backend_llc=backend_llc, backend_dram=backend_dram,
        backend_contention=contention, backend_bandwidth=0.0)


def machine_stages(thread_stages: Sequence[TopdownStages],
                   bw_cycles: float) -> TopdownStages:
    """Roll per-thread stages into the machine-level attribution.

    The machine runs as long as its critical (slowest) thread, plus
    whatever the per-socket DRAM link needs beyond that -- so the
    machine stages are the critical thread's stages with the bandwidth
    floor excess in `backend_bandwidth`.  `total_cycles()` of the
    result is the run's total, exactly.
    """
    if not thread_stages:
        return TopdownStages()
    crit = thread_stages[0]
    crit_total = crit.total_cycles()
    for s in thread_stages[1:]:
        t = s.total_cycles()
        if t > crit_total:
            crit, crit_total = s, t
    excess = bw_cycles - crit_total
    return dataclasses.replace(
        crit, backend_bandwidth=excess if excess > 0.0 else 0.0)


@dataclasses.dataclass(frozen=True)
class MetricNode:
    """One node of the topdown tree."""

    name: str
    value: float
    unit: str                       # 'frac' | 'mpki' | 'rate' | 'cycles' | ...
    description: str = ""
    children: Tuple["MetricNode", ...] = ()

    def flatten(self, prefix: str = "") -> Dict[str, float]:
        key = f"{prefix}{self.name}"
        out = {key: self.value}
        for ch in self.children:
            out.update(ch.flatten(prefix=f"{key}."))
        return out

    def render(self, indent: int = 0) -> str:
        if self.unit == "frac":
            val = f"{100.0 * self.value:6.2f} %"
        elif self.unit == "mpki":
            val = f"{self.value:8.3f} /kinst"
        else:
            val = f"{self.value:10.4g} {self.unit}"
        lines = ["  " * indent + f"{self.name:<24s} {val}"]
        for ch in self.children:
            lines.append(ch.render(indent + 1))
        return "\n".join(lines)


def topdown_tree(c: EventCounters, machine, nnz: int) -> MetricNode:
    """Build the topdown tree for one replayed trace.

    `machine` is a `MachineModel`-shaped object; `nnz` sizes the
    instruction stream (instructions = nnz * machine.instr_per_nnz).
    The tree's first child is the staged split (`stage_cycles`); the
    memory-bound / MPKI / prefetch / mechanism groups follow,
    plus the per-level cache `effectiveness` group.
    """
    kinst = nnz * machine.instr_per_nnz / 1e3
    stages = stage_cycles(c, machine, nnz)
    total = stages.total_cycles()
    den = total if total > 0.0 else 1.0
    fr = stages.fractions()

    staged = MetricNode(
        "stages", 1.0 if total > 0.0 else 0.0, "frac",
        "staged cycle attribution (sums bit-exactly to the total)",
        children=tuple(
            MetricNode(f, fr[f], "frac", "staged share of total cycles")
            for f in STAGE_FIELDS))

    memory_bound = MetricNode(
        "memory_bound",
        (stages.backend_l2 + stages.backend_llc + stages.backend_dram) / den,
        "frac", "cycles stalled on the memory hierarchy",
        children=(
            MetricNode("l3_bound", stages.backend_llc / den, "frac",
                       "L2 misses served by L3"),
            MetricNode("dram_bound", stages.backend_dram / den, "frac",
                       "demand lines fetched from DRAM"),
            MetricNode("mechanism_bound", stages.backend_l2 / den, "frac",
                       "misses served by victim/miss-cache/stream buffers"),
        ))

    mpki = MetricNode(
        "mpki", c.per_kinst(ev.L2_DEMAND_MISS, kinst), "mpki",
        "L2 demand misses per kilo-instruction (paper Eq. 1)",
        children=(
            MetricNode("l3_mpki", c.per_kinst(ev.L3_DEMAND_MISS, kinst),
                       "mpki", "L3 demand misses / kinst (paper Eq. 2)"),
            MetricNode("prefetch_mpki",
                       c.per_kinst(ev.L2_PREFETCH_FILL, kinst),
                       "mpki", "prefetch L2 fills / kinst (paper Eq. 3)"),
        ))

    pf_hit = c[ev.L2_PREFETCH_HIT]
    prefetch = MetricNode(
        "prefetch", pf_hit / max(pf_hit + c[ev.L2_DEMAND_MISS], 1), "frac",
        "coverage: demanded lines the prefetcher brought in early",
        children=(
            MetricNode("accuracy",
                       c.rate(ev.L2_PREFETCH_HIT, ev.L2_PREFETCH_FILL),
                       "frac", "prefetched lines that were ever demanded"),
        ))

    l2_miss = max(c[ev.L2_DEMAND_MISS], 1)
    mech_children = []
    for name, event in (("victim_hit_rate", ev.VICTIM_HIT),
                        ("miss_cache_hit_rate", ev.MISS_CACHE_HIT),
                        ("stream_hit_rate", ev.STREAM_HIT)):
        if c[event]:
            mech_children.append(MetricNode(
                name, c[event] / l2_miss, "frac",
                f"L2 misses served ({event})"))
    mech_served = (c[ev.VICTIM_HIT] + c[ev.MISS_CACHE_HIT]
                   + c[ev.STREAM_HIT])
    mechanisms = MetricNode(
        "mechanisms", mech_served / l2_miss, "frac",
        "L2 misses served by the paper's §V structures",
        children=tuple(mech_children))

    # per-level cache effectiveness: fraction of the demand stream that
    # REACHED each level which the level served (the staged view's "why":
    # a DRAM-bound run is one whose upper levels stopped being effective)
    eff_children = []
    for lname in ("L1", "L2", "L3"):
        hits = c[f"{lname}_DEMAND_HIT"]
        reached = hits + c[f"{lname}_DEMAND_MISS"]
        if reached:
            eff_children.append(MetricNode(
                f"{lname.lower()}_eff", hits / reached, "frac",
                f"demand accesses reaching {lname} that {lname} served"))
    effectiveness = MetricNode(
        "effectiveness",
        eff_children[0].value if eff_children else 0.0, "frac",
        "per-level hit rate over the traffic each level actually saw",
        children=tuple(eff_children))

    return MetricNode(
        "spmv", total / max(nnz, 1), "cycles/nnz",
        "estimated cycles per nonzero (1 core)",
        children=(staged, memory_bound, mpki, prefetch, mechanisms,
                  effectiveness))


@dataclasses.dataclass(frozen=True)
class TopdownSummary:
    """Flat headline numbers for reports (one row per sweep point)."""

    l2_mpki: float
    l3_mpki: float
    prefetch_mpki: float
    pf_coverage: float
    pf_accuracy: float
    memory_bound: float
    dram_bound: float
    mech_served_frac: float
    victim_hit_rate: float
    miss_cache_hit_rate: float
    stream_hit_rate: float
    cycles_per_nnz: float
    gflops_est: float
    # staged attribution (fractions of total cycles) + level effectiveness
    retiring_frac: float = 0.0
    mech_bound: float = 0.0       # backend_l2 share (mechanism service cycles)
    llc_bound: float = 0.0        # backend_llc share
    l2_eff: float = 0.0           # L2 demand hit rate (traffic L2 saw)
    llc_eff: float = 0.0          # L3 demand hit rate (traffic L3 saw)

    FIELDS = ("l2_mpki", "l3_mpki", "prefetch_mpki", "pf_coverage",
              "pf_accuracy", "memory_bound", "dram_bound",
              "mech_served_frac", "victim_hit_rate", "miss_cache_hit_rate",
              "stream_hit_rate", "cycles_per_nnz", "gflops_est",
              "retiring_frac", "mech_bound", "llc_bound", "l2_eff",
              "llc_eff")

    def as_dict(self) -> Dict[str, float]:
        return {f: getattr(self, f) for f in self.FIELDS}

    def bound(self) -> str:
        """Dominant single-stream bound category (bandwidth/contention are
        machine-level stages; see `TopdownStages.bound` for those)."""
        cats = (("retiring", self.retiring_frac),
                ("backend_l2", self.mech_bound),
                ("backend_llc", self.llc_bound),
                ("backend_dram", self.dram_bound))
        best, best_v = cats[0]
        for name, v in cats[1:]:
            if v > best_v:
                best, best_v = name, v
        return best


def topdown_summary(c: EventCounters, machine, nnz: int) -> TopdownSummary:
    """Flatten `topdown_tree` into the report row -- the tree is the single
    source of the formulas; this only renames nodes."""
    flat = topdown_tree(c, machine, nnz).flatten()
    cycles_per_nnz = flat["spmv"]
    return TopdownSummary(
        l2_mpki=flat["spmv.mpki"],
        l3_mpki=flat["spmv.mpki.l3_mpki"],
        prefetch_mpki=flat["spmv.mpki.prefetch_mpki"],
        pf_coverage=flat["spmv.prefetch"],
        pf_accuracy=flat["spmv.prefetch.accuracy"],
        memory_bound=flat["spmv.memory_bound"],
        dram_bound=flat["spmv.memory_bound.dram_bound"],
        mech_served_frac=flat["spmv.mechanisms"],
        victim_hit_rate=flat.get("spmv.mechanisms.victim_hit_rate", 0.0),
        miss_cache_hit_rate=flat.get(
            "spmv.mechanisms.miss_cache_hit_rate", 0.0),
        stream_hit_rate=flat.get("spmv.mechanisms.stream_hit_rate", 0.0),
        cycles_per_nnz=cycles_per_nnz,
        gflops_est=(2.0 * machine.freq_ghz / cycles_per_nnz
                    if cycles_per_nnz > 0.0 else 0.0),
        retiring_frac=flat["spmv.stages.retiring"],
        mech_bound=flat["spmv.stages.backend_l2"],
        llc_bound=flat["spmv.stages.backend_llc"],
        l2_eff=flat.get("spmv.effectiveness.l2_eff", 0.0),
        llc_eff=flat.get("spmv.effectiveness.l3_eff", 0.0),
    )


__all__ = ["COMPUTE_CPN", "MECH_HIT_CYCLES", "STAGE_FIELDS", "TopdownStages",
           "stage_cycles", "machine_stages", "MetricNode", "topdown_tree",
           "TopdownSummary", "topdown_summary"]
