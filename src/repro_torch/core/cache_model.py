"""Machine description and the analytic cache model of the paper's
metrics.

Counterpart of `repro.core.cache_model`, host-side numpy as there.  The
paper measures five compound metrics (L2/L3 misses per kilo-instruction,
prefetch misses, L2 stall cycles, GFLOPS) on a dual Xeon E5-2690 (Sandy
Bridge); the models here describe that machine (`SANDY_BRIDGE`), not
the card the port runs on, because they are what `plan.compile` scores
candidates with and the scores must equal the reference's:

  * `simulate_exact` -- trace-driven replay of one core's CSR SpMV
    stream through `repro_torch.telemetry.hierarchy.Hierarchy.default`;
  * `analytic_metrics` -- the Che / working-set approximation over the
    empirical x-line popularity, the compiler's 'analytic' oracle for
    matrices too large to replay.

Every float is computed in the reference's operation order, so the
predicted GFLOPS are bit-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.device import to_numpy

from .formats import CSR


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Sandy Bridge E5-2690 x2 (paper §II-B) -- all sizes in bytes."""

    name: str = "2x Xeon E5-2690 (Sandy Bridge)"
    freq_ghz: float = 2.9
    cores_per_socket: int = 8
    sockets: int = 2
    line_bytes: int = 64
    l2_bytes: int = 256 * 1024          # per core
    l3_bytes: int = 20 * 1024 * 1024    # per socket, shared
    l3_hit_cycles: float = 31.0
    dram_cycles: float = 200.0
    dram_bw_gbs: float = 51.2           # per socket (4ch DDR3-1600)
    elem_bytes: int = 8                 # f64 values (paper uses doubles)
    idx_bytes: int = 4
    # calibration constants (documented in EXPERIMENTS.md §Paper-validation)
    instr_per_nnz: float = 35.0         # CSR inner loop (compiled -O2, f64;
                                        # includes loop control + addr calc --
                                        # calibrated so the R-MAT L2 plateau
                                        # lands at the paper's ~26/kinst
    mlp: float = 6.0                    # avg outstanding misses (OOO window)
    x_cache_frac: float = 0.85          # cache fraction holding x lines
    prefetch_streams: int = 16          # trackable sequential streams / core
    pf_shutoff_util: float = 0.65       # DRAM utilization that kills the
                                        # prefetcher (paper §II-B, §IV-C)


SANDY_BRIDGE = MachineModel()


@dataclasses.dataclass(frozen=True)
class CacheMetrics:
    """The paper's five compound metrics (Eqs. 1-5) + raw components."""

    l2_miss_rate: float        # demand misses / kilo-instruction  (Eq. 1)
    l3_miss_rate: float        # demand misses / kilo-instruction  (Eq. 2)
    prefetch_miss_rate: float  # prefetch L2 fills / kinst          (Eq. 3)
    l2_stall_frac: float       # stalled cycles / total cycles      (Eq. 4)
    gflops: float              # 2*nnz / runtime / 1e9              (Eq. 5)
    # components
    x_miss_l2_per_access: float
    x_miss_l3_per_access: float
    dram_utilization: float
    threads: int
    nnz: int


# ---------------------------------------------------------------------------
# Exact trace-driven simulator (small/medium sizes).  The simulator itself
# lives in repro_torch.telemetry.hierarchy; this entry point keeps the
# reference's counter dictionary.
# ---------------------------------------------------------------------------

def simulate_exact(csr: CSR, machine: MachineModel = SANDY_BRIDGE,
                   sweeps: int = 2) -> dict:
    """Trace-driven simulation of one core running CSR SpMV.

    Replays the full demand stream (matrix values+indices, row pointers, x
    gathers, y writes) through L2 -> L3 with a stream prefetcher filling L2.
    Returns per-sweep counters for the final (warm) sweep.

    Delegates to `repro_torch.telemetry.hierarchy.Hierarchy.default`
    (fully-associative LRU L2/L3 and a next-line prefetcher); richer
    geometries and the paper's §V mechanisms are available through that
    module directly.
    """
    from repro_torch.telemetry import events as tev
    from repro_torch.telemetry.hierarchy import Hierarchy

    c = Hierarchy.default(machine).run_spmv(csr, machine, sweeps=sweeps)
    return {
        "l2_demand": c[tev.L2_DEMAND_MISS],
        "l3_demand": c[tev.L3_DEMAND_MISS],
        "pf_fills": c[tev.L2_PREFETCH_FILL],
        "accesses": c[tev.ACCESS],
    }


# ---------------------------------------------------------------------------
# Analytic model (Che approximation over empirical line popularity)
# ---------------------------------------------------------------------------

def _che_hit_rate(counts: np.ndarray, capacity_lines: float,
                  stream_rate: float = 0.0) -> float:
    """LRU hit rate under the independent-reference model with empirical
    per-line access counts, via the Che characteristic-time approximation.

    `stream_rate` models cache pollution by streaming (use-once) lines
    inserted at `stream_rate` lines per x-access: they occupy `stream_rate*T`
    slots of the capacity (the paper's finding F1 -- "the L3 rarely contains
    relevant data" -- emerges from exactly this competition).

    hit = sum_i p_i * (1 - exp(-p_i * T)),  where T solves
          sum_i (1 - exp(-p_i * T)) + stream_rate * T = C.
    """
    counts = counts[counts > 0].astype(np.float64)
    n_lines = counts.size
    if n_lines == 0:
        return 1.0
    if capacity_lines >= n_lines and stream_rate <= 0.0:
        return 1.0
    # compress to (distinct value, multiplicity): popularity arrays hold
    # millions of lines but only O(100) distinct counts -- the Che sums
    # collapse to weighted sums, making the 2^26 sweep cheap
    vals, wts = np.unique(counts, return_counts=True)
    total = float((vals * wts).sum())
    p = vals / total
    w = wts.astype(np.float64)
    # T is measured in x-accesses; one x-access per count unit.
    lo, hi = 1.0, 1e18
    for _ in range(80):
        mid = np.sqrt(lo * hi)
        filled = float(np.sum(w * (-np.expm1(-p * mid)))) + stream_rate * mid
        if filled > capacity_lines:
            hi = mid
        else:
            lo = mid
    T = np.sqrt(lo * hi)
    return float(min(1.0, np.sum(w * p * (-np.expm1(-p * T)))))


def x_line_popularity(csr: CSR, machine: MachineModel = SANDY_BRIDGE
                      ) -> np.ndarray:
    """Empirical access counts per 64B line of x (the gathered operand)."""
    per_line = machine.line_bytes // machine.elem_bytes
    lines = to_numpy(csr.indices).astype(np.int64) // per_line
    return np.bincount(lines, minlength=-(-csr.n_cols // per_line))


@dataclasses.dataclass(frozen=True)
class MatrixProfile:
    """Everything the analytic model needs, detached from a concrete CSR --
    enables the paper's full 2^11..2^26 sweep without materializing the
    5x10^8-nnz matrices."""
    n_rows: int
    n_cols: int
    nnz: int
    line_counts: np.ndarray      # x-access counts per 64B line
    stream_servable: float       # fraction of prefetcher-servable accesses
    n_band_groups: int


def profile_of(csr: CSR, machine: MachineModel = SANDY_BRIDGE
               ) -> MatrixProfile:
    from . import structure as _structure

    rep = _structure.analyze(csr)
    return MatrixProfile(
        n_rows=csr.n_rows, n_cols=csr.n_cols, nnz=csr.nnz,
        line_counts=x_line_popularity(csr, machine),
        stream_servable=rep.stream_servable,
        n_band_groups=rep.n_band_groups,
    )


def profile_fd(n_rows: int, nnz_per_row: int = 9,
               machine: MachineModel = SANDY_BRIDGE) -> MatrixProfile:
    """Synthetic FD profile: banded accesses are uniform over x lines and
    ~fully stream-servable."""
    per_line = machine.line_bytes // machine.elem_bytes
    n_lines = -(-n_rows // per_line)
    nnz = n_rows * nnz_per_row
    counts = np.full(n_lines, nnz / max(n_lines, 1))
    return MatrixProfile(n_rows=n_rows, n_cols=n_rows, nnz=nnz,
                         line_counts=counts, stream_servable=0.995,
                         n_band_groups=3)


def profile_rmat(n_rows: int, nnz_per_row: int = 8,
                 machine: MachineModel = SANDY_BRIDGE,
                 a: float = 0.57, b: float = 0.19, c: float = 0.19
                 ) -> MatrixProfile:
    """Synthetic R-MAT profile via the exact column-marginal argument.

    The marginal probability of column j is a product of per-level Bernoulli
    factors with P(right) = b + d; rows analogously with P(down) = c + d.
    Summing 8 adjacent columns (one 64B f64 line) marginalizes the bottom 3
    column levels away, so LINE popularity classes are indexed by the number
    of set high bits.  Duplicate-edge dedup is applied at CELL level: a
    (row, col) cell with Poisson(m * p_row * p_col) draws contributes
    1 - exp(-m p_r p_c) distinct nonzeros -- this is what clips the hub
    columns that a flat dedup factor would overweight (and what makes the
    paper's "every L2 miss also misses L3" emerge at the top of the sweep).
    """
    import math as _math

    levels = int(np.log2(n_rows))
    high = max(levels - 3, 1)
    q_col = b + (1.0 - a - b - c)          # P(right) = b + d
    q_row = c + (1.0 - a - b - c)          # P(down)  = c + d
    m_draws = float(n_rows) * nnz_per_row

    k_r = np.arange(levels + 1)
    row_sizes = np.array([_math.comb(levels, int(k)) for k in k_r],
                         dtype=np.float64)
    p_r = q_row ** k_r * (1 - q_row) ** (levels - k_r)

    def dedup_count(p_col: float) -> float:
        """Expected distinct nonzeros in one column of marginal p_col."""
        lam = m_draws * p_r * p_col
        return float(np.sum(row_sizes * (-np.expm1(-lam))))

    # Column-count distribution after dedup, by class (k set bits).
    k_c = np.arange(levels + 1)
    col_sizes = np.array([_math.comb(levels, int(k)) for k in k_c],
                         dtype=np.float64)
    col_vals = np.array([dedup_count(
        q_col ** int(k) * (1 - q_col) ** (levels - int(k))) for k in k_c])
    nnz = float(np.sum(col_sizes * col_vals))

    # The paper PERMUTES rows and columns, so a 64B line holds 8 columns
    # drawn ~uniformly from the column-count multiset (NOT 8 R-MAT
    # siblings).  Sample line counts as sums of 8 Poisson draws; chunked to
    # bound memory at 2^26 (67M columns).
    rng = np.random.default_rng(12345)
    probs = col_sizes / col_sizes.sum()
    cdf = np.cumsum(probs)
    n_lines = n_rows // 8
    counts = np.empty(n_lines, dtype=np.float64)
    chunk = min(n_lines, 1 << 20)
    for lo in range(0, n_lines, chunk):
        hi = min(lo + chunk, n_lines)
        u = rng.random((hi - lo) * 8)
        cls = np.searchsorted(cdf, u).clip(0, levels)
        lam = col_vals[cls].astype(np.float64)
        counts[lo:hi] = rng.poisson(lam).reshape(-1, 8).sum(axis=1)
    return MatrixProfile(n_rows=n_rows, n_cols=n_rows, nnz=int(nnz),
                         line_counts=counts, stream_servable=0.02,
                         n_band_groups=1)


def analytic_metrics(csr: CSR, machine: MachineModel = SANDY_BRIDGE,
                     threads: int = 1,
                     structured_frac: float | None = None) -> CacheMetrics:
    """The paper's five metrics for `csr` (empirical profile)."""
    return analytic_metrics_from_profile(
        profile_of(csr, machine), machine, threads=threads,
        structured_frac=structured_frac)


def analytic_metrics_from_profile(
        prof: MatrixProfile, machine: MachineModel = SANDY_BRIDGE,
        threads: int = 1,
        structured_frac: float | None = None) -> CacheMetrics:
    """The paper's five metrics from a (possibly synthetic) profile."""
    nnz = prof.nnz
    n = prof.n_rows
    lb = machine.line_bytes
    instr = nnz * machine.instr_per_nnz

    if structured_frac is None:
        # stream-servable accesses are handled by the prefetcher / adjacent
        # fills; only the remainder behaves like random demand traffic.
        structured_frac = prof.stream_servable
    # a prefetcher can only track `prefetch_streams` concurrent bands
    n_bands = min(max(prof.n_band_groups, 1), machine.prefetch_streams)

    # ---- problem working set (Table I accounting: 2m+n+1 matrix + 2 vectors)
    ws_bytes = (nnz * (machine.elem_bytes + machine.idx_bytes)
                + (n + 1) * machine.idx_bytes + 2 * n * machine.elem_bytes)
    ws_lines = ws_bytes / lb
    fits_l2 = ws_lines <= machine.l2_bytes / lb
    sockets_used = 1 if threads <= machine.cores_per_socket else machine.sockets
    fits_l3 = ws_lines <= (machine.l3_bytes * sockets_used) / lb

    # ---- streaming traffic (matrix arrays + y + structured x) --------------
    # structured x bytes: each trackable band group streams its x window once
    x_stream_bytes_per_nnz = (
        structured_frac * n_bands * prof.n_cols * machine.elem_bytes
        / max(nnz, 1))
    stream_bytes_per_nnz = (
        machine.elem_bytes + machine.idx_bytes                    # val + idx
        + machine.idx_bytes * (n + 1) / max(nnz, 1)               # rowptr
        + 2 * machine.elem_bytes * n / max(nnz, 1)                # y rd+wr
        + x_stream_bytes_per_nnz                                  # x windows
    )
    stream_lines_per_nnz = stream_bytes_per_nnz / lb
    # streams pollute the caches only when they do not fit (use-once lines)
    stream_rate_l2 = 0.0 if fits_l2 else stream_lines_per_nnz
    stream_rate_l3 = 0.0 if fits_l3 else stream_lines_per_nnz

    # ---- x-gather demand misses (per access) --------------------------------
    counts = prof.line_counts
    # per-core L2: each thread sees 1/threads of the rows; popularity
    # distribution is unchanged by the random permutation, counts scale down.
    l2_cap = machine.x_cache_frac * machine.l2_bytes / lb
    per_core_counts = counts / max(threads, 1)
    hit_l2_rand = _che_hit_rate(per_core_counts, l2_cap, stream_rate_l2)
    # if the whole problem fits in L2, everything hits after warmup
    if fits_l2:
        hit_l2_rand = 1.0
    x_miss_l2 = (1.0 - structured_frac) * (1.0 - hit_l2_rand)

    # shared L3 (per socket): threads on a socket share hub lines, and the
    # streaming matrix data competes for the same capacity (finding F1).
    l3_cap = machine.x_cache_frac * machine.l3_bytes * sockets_used / lb
    hit_l3_rand = _che_hit_rate(counts, l3_cap,
                                stream_rate_l3 * max(threads, 1))
    if fits_l3:
        hit_l3_rand = 1.0
    # L3 miss given L2 miss (inclusive hierarchy, IRM): conditional ratio
    x_miss_l3 = x_miss_l2 * (1.0 - hit_l3_rand) / max(1.0 - hit_l2_rand, 1e-12) \
        if hit_l2_rand < 1.0 else 0.0
    x_miss_l3 = min(x_miss_l3, x_miss_l2)

    # ---- two-pass solve: prefetcher state depends on *demand* DRAM traffic
    # (Intel manual / paper §II-B: the prefetcher stays off when the DRAM
    # link is congested with demand requests -- FD generates none, so its
    # prefetcher keeps running; R-MAT's gather misses shut it down).
    threads_per_socket = min(threads, machine.cores_per_socket)
    bw_bytes_per_cyc_core = (machine.dram_bw_gbs * 1e9 /
                             (machine.freq_ghz * 1e9)) / threads_per_socket
    compute_cpn = 2.9   # load-port bound: 3 loads / 2 ports + fma + loop ctl

    pf_on = True
    for _ in range(4):  # fixed-point: pf state <-> DRAM demand utilization
        if fits_l2:
            pf_fills_per_nnz = 0.0
            stream_demand_l2 = 0.0
        elif pf_on:
            pf_fills_per_nnz = stream_lines_per_nnz
            stream_demand_l2 = 0.005 * stream_lines_per_nnz
        else:
            # paper §IV-C: congestion shuts the prefetcher off; stream lines
            # become demand misses
            pf_fills_per_nnz = 0.0
            stream_demand_l2 = stream_lines_per_nnz
        stream_demand_l3 = 0.0 if fits_l3 else 0.9 * stream_demand_l2

        l2_miss_per_nnz = x_miss_l2 + stream_demand_l2
        l3_miss_per_nnz = x_miss_l3 + stream_demand_l3

        demand_bytes_per_nnz = l3_miss_per_nnz * lb
        dram_lines_per_nnz = (
            l3_miss_per_nnz + (0.0 if fits_l3 else pf_fills_per_nnz))
        dram_bytes_per_nnz = dram_lines_per_nnz * lb

        stall_cpn = (
            (l2_miss_per_nnz - l3_miss_per_nnz) * machine.l3_hit_cycles
            + l3_miss_per_nnz * machine.dram_cycles
        ) / machine.mlp

        bw_cpn = dram_bytes_per_nnz / max(bw_bytes_per_cyc_core, 1e-12)
        eff_cpn = max(compute_cpn + stall_cpn, bw_cpn)
        dram_util = min(1.0, bw_cpn / eff_cpn) if eff_cpn > 0 else 0.0
        demand_util = min(
            1.0, (demand_bytes_per_nnz / max(bw_bytes_per_cyc_core, 1e-12))
            / max(eff_cpn, 1e-12))
        new_pf_on = demand_util < machine.pf_shutoff_util
        if new_pf_on == pf_on:
            break
        pf_on = new_pf_on

    # when DRAM saturates, queueing delay raises stalls further
    if dram_util > 0.8:
        stall_cpn *= 1.0 / max(1e-3, (1.05 - dram_util)) ** 0.5
        eff_cpn = max(compute_cpn + stall_cpn, bw_cpn)

    stall_frac = stall_cpn / max(eff_cpn, 1e-12)
    # bandwidth-bound cycles also show up as L2-pending stalls (paper Fig 4:
    # parallel FD stalls rise from prefetch-induced DRAM congestion even
    # though demand miss rates stay low)
    if not fits_l3:
        stall_frac = max(stall_frac,
                         (eff_cpn - compute_cpn) / max(eff_cpn, 1e-12))
    stall_frac = min(stall_frac, 0.95)

    # ---- compose the paper's metrics ---------------------------------------
    kinst = instr / 1e3
    runtime_s = eff_cpn * nnz / (machine.freq_ghz * 1e9) / max(threads, 1)
    gflops = 2.0 * nnz / runtime_s / 1e9

    return CacheMetrics(
        l2_miss_rate=l2_miss_per_nnz * nnz / kinst,
        l3_miss_rate=l3_miss_per_nnz * nnz / kinst,
        prefetch_miss_rate=pf_fills_per_nnz * nnz / kinst,
        l2_stall_frac=stall_frac,
        gflops=gflops,
        x_miss_l2_per_access=x_miss_l2,
        x_miss_l3_per_access=x_miss_l3,
        dram_utilization=dram_util,
        threads=threads,
        nnz=nnz,
    )


def table1_capacity(machine: MachineModel = SANDY_BRIDGE,
                    nnz_per_row: float = 9.0, parallel: bool = False) -> dict:
    """Paper Table I: max nnz such that the whole problem fits a cache level.

    problem bytes = nnz*(8+4) + (rows+1)*4 + 2*rows*8, rows = nnz/nnz_per_row.
    """
    def solve(cap_bytes):
        per_nnz = (machine.elem_bytes + machine.idx_bytes
                   + (machine.idx_bytes + 2 * machine.elem_bytes) / nnz_per_row)
        return int(cap_bytes / per_nnz)

    l2 = machine.l2_bytes * (16 if parallel else 1)
    l3 = machine.l3_bytes * (2 if parallel else 1)
    return {"L2": solve(l2), "L3": solve(l3)}


__all__ = ["MachineModel", "SANDY_BRIDGE", "CacheMetrics", "simulate_exact",
           "x_line_popularity", "MatrixProfile", "profile_of", "profile_fd",
           "profile_rmat", "analytic_metrics",
           "analytic_metrics_from_profile", "table1_capacity"]
