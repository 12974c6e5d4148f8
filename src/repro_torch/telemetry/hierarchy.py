"""Composable trace-driven memory-hierarchy simulator.

Counterpart of `repro.telemetry.hierarchy`, pure Python and numpy as
there (the replay is one Python call per address):

  * `SetAssocCache`        set-associative LRU (ways=None: fully
                           associative)
  * `SequentialPrefetcher` the next-line multi-stream prefetcher of the
                           paper's Sandy Bridge model
  * `VictimCache`, `MissCache`, `StreamBuffers`
                           the paper's §V miss-path mechanisms (Jouppi)
  * `CacheLevel`, `Hierarchy`, `HierarchySpec`
                           levels, the stack that replays address traces
                           into `events.EventCounters`, and its
                           declarative description
  * `spmv_address_trace`, `hyb_address_trace`, `format_address_trace`,
    `overlay_address_trace`
                           the line-id streams a CPU core issues for a
                           planned matrix.  The HYB trace walks the heavy
                           stream in the container's column-sorted order,
                           the CPU execution the paper models -- not the
                           order of the card's segmented kernel.

The simulator is functional, not cycle-accurate: it answers which
structure served each access, and `telemetry.topdown` attributes the
latency.  `Hierarchy.default(machine)` is the configuration
`core.cache_model.simulate_exact` replays.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.device import to_numpy

from .events import (ACCESS, L2_PREFETCH_FILL, L2_PREFETCH_HIT,
                     MISS_CACHE_HIT, MISS_CACHE_PROBE, STREAM_ALLOC,
                     STREAM_FILL, STREAM_HIT, STREAM_PROBE, VICTIM_HIT,
                     VICTIM_PROBE, EventCounters, register_event)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

class SetAssocCache:
    """Set-associative LRU cache over line ids.

    ways=None (or >= capacity) degenerates to one fully-associative set.
    Each resident line carries a
    "prefetched, not yet demanded" flag so prefetch usefulness is countable.
    """

    __slots__ = ("n_sets", "ways", "sets", "capacity_lines")

    def __init__(self, capacity_lines: int, ways: Optional[int] = None):
        capacity_lines = max(int(capacity_lines), 1)
        if ways is None or ways <= 0 or ways >= capacity_lines:
            self.n_sets, self.ways = 1, capacity_lines
        else:
            self.n_sets = max(capacity_lines // ways, 1)
            self.ways = ways
        self.capacity_lines = self.n_sets * self.ways
        self.sets = [OrderedDict() for _ in range(self.n_sets)]

    def lookup(self, line: int):
        """Demand access: returns (hit, first_hit_on_prefetched_line)."""
        s = self.sets[line % self.n_sets]
        if line in s:
            was_pf = s[line]
            if was_pf:
                s[line] = False
            s.move_to_end(line)
            return True, was_pf
        return False, False

    def contains(self, line: int) -> bool:
        return line in self.sets[line % self.n_sets]

    def insert(self, line: int, prefetched: bool = False) -> Optional[int]:
        """Fill `line`; returns the evicted line id, if any."""
        s = self.sets[line % self.n_sets]
        if line in s:
            s.move_to_end(line)
            return None
        s[line] = prefetched
        if len(s) > self.ways:
            victim, _ = s.popitem(last=False)
            return victim
        return None

    def resident_lines(self) -> int:
        return sum(len(s) for s in self.sets)


class SequentialPrefetcher:
    """Next-line prefetcher: tracks up to `n_streams` ascending line streams;
    on a stream hit it prefetches the next `depth` lines."""

    __slots__ = ("streams", "n_streams", "depth")

    def __init__(self, n_streams: int = 16, depth: int = 2):
        self.streams: OrderedDict = OrderedDict()  # last line -> None
        self.n_streams = n_streams
        self.depth = depth

    def observe(self, line: int):
        """Returns the list of lines to prefetch."""
        hits = None
        if line - 1 in self.streams or line in self.streams:
            self.streams.pop(line - 1, None)
            self.streams.pop(line, None)
            hits = [line + k for k in range(1, self.depth + 1)]
        self.streams[line] = None
        if len(self.streams) > self.n_streams:
            self.streams.popitem(last=False)
        return hits or []


# ---------------------------------------------------------------------------
# Miss-path mechanisms (paper §V candidates, Jouppi 1990 designs)
# ---------------------------------------------------------------------------

class VictimCache:
    """Small fully-associative buffer of lines recently evicted from the
    attached level.  On a miss it is probed first; a hit swaps the line
    back (the subsequent demand fill into the level models the swap)."""

    name = "victim"

    def __init__(self, n_entries: int = 16):
        self.cap = max(int(n_entries), 1)
        self.entries: OrderedDict = OrderedDict()

    def probe(self, line: int, counters: EventCounters) -> bool:
        counters.inc(VICTIM_PROBE)
        if line in self.entries:
            del self.entries[line]
            counters.inc(VICTIM_HIT)
            return True
        return False

    def on_evict(self, line: int) -> None:
        self.entries[line] = True
        self.entries.move_to_end(line)
        if len(self.entries) > self.cap:
            self.entries.popitem(last=False)


class MissCache:
    """Small fully-associative buffer filled with recently *missed* lines.
    Catches short-term conflict re-misses without storing evictions."""

    name = "miss"

    def __init__(self, n_entries: int = 16):
        self.cap = max(int(n_entries), 1)
        self.entries: OrderedDict = OrderedDict()

    def probe(self, line: int, counters: EventCounters) -> bool:
        counters.inc(MISS_CACHE_PROBE)
        if line in self.entries:
            self.entries.move_to_end(line)
            counters.inc(MISS_CACHE_HIT)
            return True
        self.entries[line] = True
        if len(self.entries) > self.cap:
            self.entries.popitem(last=False)
        return False

    def on_evict(self, line: int) -> None:
        pass


class StreamBuffers:
    """N FIFO stream buffers on the miss path.  A miss that matches a
    buffer head is served from the buffer (which then fetches one more
    line); a miss that matches nothing reallocates the LRU buffer to a new
    sequential stream of `depth` lines."""

    name = "stream"

    def __init__(self, n_streams: int = 4, depth: int = 4):
        self.n_streams = max(int(n_streams), 1)
        self.depth = max(int(depth), 1)
        self.buffers: OrderedDict = OrderedDict()  # id -> deque of lines
        self._next_id = 0

    def probe(self, line: int, counters: EventCounters) -> bool:
        counters.inc(STREAM_PROBE)
        for bid, dq in self.buffers.items():
            if dq and dq[0] == line:
                dq.popleft()
                dq.append(line + self.depth)   # keep the run primed
                counters.inc(STREAM_FILL)
                self.buffers.move_to_end(bid)
                counters.inc(STREAM_HIT)
                return True
        # no buffer tracks this stream: (re)allocate the LRU buffer
        if len(self.buffers) >= self.n_streams:
            self.buffers.popitem(last=False)
        self.buffers[self._next_id] = deque(
            line + k for k in range(1, self.depth + 1))
        self._next_id += 1
        counters.inc(STREAM_ALLOC)
        counters.inc(STREAM_FILL, self.depth)
        return False

    def on_evict(self, line: int) -> None:
        pass


# ---------------------------------------------------------------------------
# Levels and the hierarchy
# ---------------------------------------------------------------------------

class CacheLevel:
    """One cache level plus the mechanisms attached to its miss path."""

    __slots__ = ("name", "cache", "mechanisms", "hit_event", "miss_event")

    def __init__(self, name: str, capacity_lines: int,
                 ways: Optional[int] = None,
                 mechanisms: Sequence = ()):
        self.name = name
        self.cache = SetAssocCache(capacity_lines, ways)
        self.mechanisms = list(mechanisms)
        self.hit_event = register_event(
            f"{name}_DEMAND_HIT", f"demand accesses that hit in {name}")
        self.miss_event = register_event(
            f"{name}_DEMAND_MISS", f"demand accesses that missed {name}")


class Hierarchy:
    """A stack of cache levels with an optional hardware prefetcher.

    The prefetcher observes every demand access *before* the cache lookup
    (hardware cannot tell operands apart -- the paper's mechanism for why
    R-MAT gathers pollute the stream table) and fills every level.
    """

    def __init__(self, levels: Sequence[CacheLevel],
                 prefetcher: Optional[SequentialPrefetcher] = None,
                 pf_level: int = 0):
        """`pf_level` is the index of the level the prefetcher fills into
        and filters against (the L2 in Sandy Bridge terms) -- 0 for the
        two-level stack, 1 when a private L1 sits in front."""
        self.levels = list(levels)
        self.prefetcher = prefetcher
        self.pf_level = pf_level

    # -- construction -------------------------------------------------------

    @classmethod
    def default(cls, machine) -> "Hierarchy":
        """The `cache_model.simulate_exact` configuration: fully-associative
        LRU L2/L3 + a `machine.prefetch_streams`-stream next-line
        prefetcher."""
        return cls.build(machine)

    @classmethod
    def build(cls, machine, ways: Optional[int] = None,
              l2_bytes: Optional[int] = None, l3_bytes: Optional[int] = None,
              l3_ways: Optional[int] = None, prefetcher: bool = True,
              l2_mechanisms: Sequence = ()) -> "Hierarchy":
        """Hierarchy from a `MachineModel`-shaped object (duck-typed: needs
        line_bytes / l2_bytes / l3_bytes / prefetch_streams).

        `ways` sets the L2 associativity only; `l3_ways` the L3's (each
        None -> fully associative), so associativity sweeps on one level
        don't contaminate the other."""
        lb = machine.line_bytes
        levels = [
            CacheLevel("L2", (l2_bytes or machine.l2_bytes) // lb, ways,
                       mechanisms=l2_mechanisms),
            CacheLevel("L3", (l3_bytes or machine.l3_bytes) // lb, l3_ways),
        ]
        pf = (SequentialPrefetcher(machine.prefetch_streams)
              if prefetcher else None)
        return cls(levels, pf)

    # -- replay -------------------------------------------------------------

    def access(self, line: int, counters: EventCounters,
               prefetchable: bool = True) -> str:
        """One demand access; returns the name of what served it."""
        counts = counters.counts
        counts[ACCESS] = counts.get(ACCESS, 0) + 1
        levels = self.levels
        pf = self.prefetcher
        if pf is not None and prefetchable:
            l2cache = levels[self.pf_level].cache
            for pline in pf.observe(line):
                if not l2cache.contains(pline):
                    counts[L2_PREFETCH_FILL] = \
                        counts.get(L2_PREFETCH_FILL, 0) + 1
                    # fill bottom-up (L3 then L2)
                    for li in range(len(levels) - 1, self.pf_level - 1, -1):
                        lv = levels[li]
                        ev = lv.cache.insert(
                            pline, prefetched=(li == self.pf_level))
                        if ev is not None:
                            for m in lv.mechanisms:
                                m.on_evict(ev)
        for li, lv in enumerate(levels):
            hit, was_pf = lv.cache.lookup(line)
            if hit:
                counts[lv.hit_event] = counts.get(lv.hit_event, 0) + 1
                if was_pf and li == self.pf_level:
                    counts[L2_PREFETCH_HIT] = \
                        counts.get(L2_PREFETCH_HIT, 0) + 1
                return lv.name
            counts[lv.miss_event] = counts.get(lv.miss_event, 0) + 1
            served = None
            for m in lv.mechanisms:
                if m.probe(line, counters):
                    served = m.name
                    break
            # demand fill on miss
            ev = lv.cache.insert(line)
            if ev is not None:
                for m in lv.mechanisms:
                    m.on_evict(ev)
            if served is not None:
                return served
        return "DRAM"

    def replay(self, trace, counters: Optional[EventCounters] = None
               ) -> EventCounters:
        """Replay an iterable of line ids; returns the filled counters."""
        c = counters if counters is not None else EventCounters()
        if isinstance(trace, np.ndarray):
            trace = trace.tolist()
        access = self.access
        for line in trace:
            access(line, c)
        return c

    def run_trace(self, trace, sweeps: int = 2) -> EventCounters:
        """Replay `trace` `sweeps` times against warm state; counters of
        the final (warm) sweep are returned."""
        if isinstance(trace, np.ndarray):
            trace = trace.tolist()
        c = EventCounters()
        for _ in range(max(sweeps, 1)):
            c = EventCounters()
            self.replay(trace, c)
        return c

    def run_spmv(self, csr, machine, sweeps: int = 2) -> EventCounters:
        """Replay the CSR SpMV demand stream `sweeps` times; counters of
        the final (warm) sweep are returned."""
        return self.run_trace(spmv_address_trace(csr, machine).tolist(),
                              sweeps=sweeps)


# ---------------------------------------------------------------------------
# The SpMV address trace (paper Fig. 2's access stream, all five operands)
# ---------------------------------------------------------------------------

def spmv_address_trace(csr, machine) -> np.ndarray:
    """The exact line-id sequence one core issues running CSR SpMV.

    Per row r: rowptr, y, then per nonzero p: value, col-index, x[col[p]].
    Regions are laid out disjointly (16-line guard gaps), as in the
    reference, so the counters are the reference's.
    """
    lb = machine.line_bytes
    ebytes, ibytes = machine.elem_bytes, machine.idx_bytes
    indptr = to_numpy(csr.indptr).astype(np.int64)
    cols = to_numpy(csr.indices).astype(np.int64)
    n = csr.n_rows
    nnz = int(cols.shape[0])

    x_base = 0
    x_lines = -(-n * ebytes // lb)
    val_base = x_base + x_lines + 16
    val_lines = -(-nnz * ebytes // lb)
    idx_base = val_base + val_lines + 16
    idx_lines = -(-nnz * ibytes // lb)
    ptr_base = idx_base + idx_lines + 16
    y_base = ptr_base + (-(-(n + 1) * ibytes // lb)) + 16

    rows = np.arange(n, dtype=np.int64)
    rows_rep = np.repeat(rows, np.diff(indptr))
    p = np.arange(nnz, dtype=np.int64)

    trace = np.empty(2 * n + 3 * nnz, dtype=np.int64)
    head = 2 * rows + 3 * indptr[:-1]            # row-header positions
    trace[head] = ptr_base + (rows * ibytes) // lb
    trace[head + 1] = y_base + (rows * ebytes) // lb
    body = 2 * (rows_rep + 1) + 3 * p            # nonzero positions
    trace[body] = val_base + (p * ebytes) // lb
    trace[body + 1] = idx_base + (p * ibytes) // lb
    trace[body + 2] = x_base + (cols * ebytes) // lb
    return trace


def hyb_address_trace(hyb, machine, light_counts=None) -> np.ndarray:
    """The demand stream of the hybrid row-split execution: the light ELL
    launch (row-major over the (n_rows, light_width) slab) followed by
    the heavy launch over the column-sorted COO stream.  Because the
    heavy stream is column-sorted, its x gathers ascend -- hub-row
    gathers turn from a random walk into one streaming pass, which is
    the locality the hybrid split buys.  Regions are disjoint with the
    same 16-line guard layout as `spmv_address_trace`.

    `light_counts` (per-row count of *real* light entries, 0 for heavy
    rows) restricts the light stream to demand accesses at slab
    addresses -- the accounting `spmv_address_trace` uses for every
    other format, where padding is lane fill the vector unit streams
    for free, not a gathered demand miss.  Without it the full slab is
    streamed, padding slots priced like real ones (the conservative raw
    kernel stream).  `format_address_trace` always passes the counts,
    so planned traces are comparable across formats."""
    lb = machine.line_bytes
    ebytes, ibytes = machine.elem_bytes, machine.idx_bytes
    n, w = hyb.n_rows, hyb.light_width
    hnnz = int(hyb.hvals.shape[0])
    lidx = to_numpy(hyb.indices).astype(np.int64).reshape(-1)
    hcols = to_numpy(hyb.hcols).astype(np.int64)
    hrows = to_numpy(hyb.hrows).astype(np.int64)

    x_base = 0
    x_lines = -(-hyb.n_cols * ebytes // lb)
    lval_base = x_base + x_lines + 16
    lval_lines = -(-n * w * ebytes // lb)
    lidx_base = lval_base + lval_lines + 16
    lidx_lines = -(-n * w * ibytes // lb)
    y_base = lidx_base + lidx_lines + 16
    y_lines = -(-n * ebytes // lb)
    hval_base = y_base + y_lines + 16
    hval_lines = -(-hnnz * ebytes // lb)
    hrow_base = hval_base + hval_lines + 16
    hrow_lines = -(-hnnz * ibytes // lb)
    hcol_base = hrow_base + hrow_lines + 16

    # light launch: per row: y, then per real slot: value, index, x[index]
    rows = np.arange(n, dtype=np.int64)
    if light_counts is None:
        counts = np.full(n, w, dtype=np.int64)
    else:
        counts = np.minimum(np.asarray(light_counts, dtype=np.int64), w)
    total = int(counts.sum())
    cum0 = np.concatenate([[0], np.cumsum(counts)[:-1]]) if n else \
        np.zeros(0, dtype=np.int64)
    row_of = np.repeat(rows, counts)                 # row of light entry j
    inner = np.arange(total, dtype=np.int64) - cum0[row_of] \
        if total else np.zeros(0, dtype=np.int64)
    slot = row_of * w + inner                        # row-major slab slot
    light = np.empty(n + 3 * total, dtype=np.int64)
    light[rows + 3 * cum0] = y_base + (rows * ebytes) // lb
    body = row_of + 1 + 3 * np.arange(total, dtype=np.int64)
    light[body] = lval_base + (slot * ebytes) // lb
    light[body + 1] = lidx_base + (slot * ibytes) // lb
    light[body + 2] = x_base + (lidx[slot] * ebytes) // lb

    # heavy launch: per nonzero: value, row id, col id, x[col] (ascending)
    p = np.arange(hnnz, dtype=np.int64)
    heavy = np.empty(4 * hnnz, dtype=np.int64)
    heavy[0::4] = hval_base + (p * ebytes) // lb
    heavy[1::4] = hrow_base + (p * ibytes) // lb
    heavy[2::4] = hcol_base + (p * ibytes) // lb
    heavy[3::4] = x_base + (hcols * ebytes) // lb
    # carry merge: one y combine per distinct heavy row
    hr = np.unique(hrows)
    tail = y_base + (hr * ebytes) // lb
    return np.concatenate([light, heavy, tail])


def format_address_trace(csr, format_name: str, machine,
                         container=None) -> np.ndarray:
    """Format-aware demand trace for a planned matrix.

    'hyb' plans get the split light/heavy stream (`hyb_address_trace` of
    the plan's container, rebuilt from the CSR if absent); every other
    format -- including 'csr-seg', whose win is thread balance, not
    stream shape -- replays the flat CSR stream of `spmv_address_trace`.
    """
    if format_name == "hyb":
        from repro_torch.core.formats import HYB

        if not isinstance(container, HYB):
            container = HYB.from_csr(csr, device="cpu")
        lengths = csr.row_lengths()
        light_counts = np.where(lengths > container.threshold, 0, lengths) \
            if len(lengths) else lengths
        return hyb_address_trace(container, machine,
                                 light_counts=light_counts)
    return spmv_address_trace(csr, machine)


def _y_region_base(csr, format_name: str, machine, container=None) -> int:
    """First line id of the y region in `format_address_trace`'s layout
    for this matrix -- the overlay pass's y combines must land on the
    *same* lines the base kernel writes, or the simulator would price
    them as cold compulsory misses they are not."""
    lb = machine.line_bytes
    ebytes, ibytes = machine.elem_bytes, machine.idx_bytes
    if format_name == "hyb":
        from repro_torch.core.formats import HYB

        if not isinstance(container, HYB):
            container = HYB.from_csr(csr, device="cpu")
        n, w = container.n_rows, container.light_width
        x_lines = -(-container.n_cols * ebytes // lb)
        lval_lines = -(-n * w * ebytes // lb)
        lidx_lines = -(-n * w * ibytes // lb)
        return x_lines + 16 + lval_lines + 16 + lidx_lines + 16
    n, nnz = csr.n_rows, csr.nnz
    x_lines = -(-n * ebytes // lb)
    val_lines = -(-nnz * ebytes // lb)
    idx_lines = -(-nnz * ibytes // lb)
    ptr_lines = -(-(n + 1) * ibytes // lb)
    return x_lines + 16 + val_lines + 16 + idx_lines + 16 + ptr_lines + 16


def overlay_address_trace(csr, format_name: str, rows, cols, machine,
                          container=None) -> np.ndarray:
    """Demand stream of an overlaid plan: the base plan's format trace
    followed by the delta pass, priced as a column-sorted COO stream.

    The overlay executes after the planned kernel: per delta nonzero it
    reads the delta value / row id / col id (fresh sequential regions
    past the base layout, 16-line guards) and gathers x[col]; one y
    combine per distinct delta row then lands on the base layout's y
    region.  Column-sorting the stream makes the x gathers ascend --
    the same locality argument as the hybrid heavy stream -- which is
    why a small overlay prices at a near-streaming marginal cost rather
    than a second random walk over x.  An empty delta returns the base
    trace unchanged."""
    base = format_address_trace(csr, format_name, machine,
                                container=container)
    rows = to_numpy(rows).astype(np.int64).reshape(-1)
    cols = to_numpy(cols).astype(np.int64).reshape(-1)
    k = int(rows.shape[0])
    if k == 0:
        return base
    lb = machine.line_bytes
    ebytes, ibytes = machine.elem_bytes, machine.idx_bytes
    order = np.lexsort((rows, cols))             # column-sorted COO
    r, c = rows[order], cols[order]

    dval_base = (int(base.max()) + 17) if base.size else 0
    dval_lines = -(-k * ebytes // lb)
    drow_base = dval_base + dval_lines + 16
    drow_lines = -(-k * ibytes // lb)
    dcol_base = drow_base + drow_lines + 16

    p = np.arange(k, dtype=np.int64)
    delta = np.empty(4 * k, dtype=np.int64)
    delta[0::4] = dval_base + (p * ebytes) // lb
    delta[1::4] = drow_base + (p * ibytes) // lb
    delta[2::4] = dcol_base + (p * ibytes) // lb
    delta[3::4] = (c * ebytes) // lb             # x region starts at line 0
    y_base = _y_region_base(csr, format_name, machine, container=container)
    tail = y_base + (np.unique(r) * ebytes) // lb
    return np.concatenate([base, delta, tail])


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """Declarative description of a hierarchy (what sweeps iterate over)."""

    l2_bytes: Optional[int] = None       # None -> machine default
    l3_bytes: Optional[int] = None
    ways: Optional[int] = None           # L2 associativity; None -> full
    l3_ways: Optional[int] = None        # L3 associativity; None -> full
    prefetcher: bool = True
    victim_entries: int = 0
    miss_entries: int = 0
    stream_buffers: int = 0
    stream_depth: int = 4

    def instantiate(self, machine) -> Hierarchy:
        mechs: List = []
        if self.victim_entries:
            mechs.append(VictimCache(self.victim_entries))
        if self.miss_entries:
            mechs.append(MissCache(self.miss_entries))
        if self.stream_buffers:
            mechs.append(StreamBuffers(self.stream_buffers,
                                       self.stream_depth))
        return Hierarchy.build(
            machine, ways=self.ways, l2_bytes=self.l2_bytes,
            l3_bytes=self.l3_bytes, l3_ways=self.l3_ways,
            prefetcher=self.prefetcher, l2_mechanisms=mechs)

    def label(self) -> str:
        parts = []
        if self.victim_entries:
            parts.append(f"victim{self.victim_entries}")
        if self.miss_entries:
            parts.append(f"miss{self.miss_entries}")
        if self.stream_buffers:
            parts.append(f"stream{self.stream_buffers}x{self.stream_depth}")
        if self.ways is not None:
            parts.append(f"{self.ways}way")
        if not self.prefetcher:
            parts.append("nopf")
        return "+".join(parts) if parts else "baseline"


__all__ = ["SetAssocCache", "SequentialPrefetcher", "VictimCache",
           "MissCache", "StreamBuffers", "CacheLevel", "Hierarchy",
           "HierarchySpec", "spmv_address_trace", "hyb_address_trace",
           "format_address_trace", "overlay_address_trace"]
