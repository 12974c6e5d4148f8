"""Named hardware-event counters of the memory-hierarchy simulator.

Counterpart of `repro.telemetry.events`: the VTune event set the paper
collects (L2/L3 demand misses, prefetcher fills) plus the counters of
the §V candidate mechanisms (victim cache, miss cache, stream buffers).
Every event is a named, documented counter; mechanisms may register
their own.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

# ---------------------------------------------------------------------------
# Event names (module-level constants so call sites are grep-able)
# ---------------------------------------------------------------------------

ACCESS = "ACCESS"                      # demand accesses issued by the kernel
L2_DEMAND_HIT = "L2_DEMAND_HIT"
L2_DEMAND_MISS = "L2_DEMAND_MISS"
L3_DEMAND_HIT = "L3_DEMAND_HIT"
L3_DEMAND_MISS = "L3_DEMAND_MISS"      # demand lines fetched from DRAM
L2_PREFETCH_FILL = "L2_PREFETCH_FILL"  # lines the HW prefetcher pulled to L2
L2_PREFETCH_HIT = "L2_PREFETCH_HIT"    # first demand hit on a prefetched line
VICTIM_PROBE = "VICTIM_PROBE"
VICTIM_HIT = "VICTIM_HIT"              # L2 miss rescued by the victim cache
MISS_CACHE_PROBE = "MISS_CACHE_PROBE"
MISS_CACHE_HIT = "MISS_CACHE_HIT"      # L2 miss rescued by the miss cache
STREAM_PROBE = "STREAM_PROBE"
STREAM_HIT = "STREAM_HIT"              # L2 miss served at a stream-buffer head
STREAM_ALLOC = "STREAM_ALLOC"          # stream buffers (re)allocated
STREAM_FILL = "STREAM_FILL"            # lines fetched into stream buffers

_REGISTRY: Dict[str, str] = {
    ACCESS: "demand accesses issued by the kernel trace",
    L2_DEMAND_HIT: "demand accesses that hit in L2",
    L2_DEMAND_MISS: "demand accesses that missed L2",
    L3_DEMAND_HIT: "L2 misses that hit in L3",
    L3_DEMAND_MISS: "demand lines fetched from DRAM",
    L2_PREFETCH_FILL: "lines the sequential prefetcher filled into L2",
    L2_PREFETCH_HIT: "first demand hit on a line brought in by prefetch",
    VICTIM_PROBE: "victim-cache probes (one per L2 miss when attached)",
    VICTIM_HIT: "L2 misses served by swapping a line back from the victim cache",
    MISS_CACHE_PROBE: "miss-cache probes (one per L2 miss when attached)",
    MISS_CACHE_HIT: "L2 misses served by the miss cache",
    STREAM_PROBE: "stream-buffer probes (one per L2 miss when attached)",
    STREAM_HIT: "L2 misses served at the head of a stream buffer",
    STREAM_ALLOC: "stream buffers allocated/replaced on miss",
    STREAM_FILL: "lines fetched from memory into stream buffers",
}


def register_event(name: str, description: str) -> str:
    """Register a new named event (idempotent); returns the name."""
    _REGISTRY.setdefault(name, description)
    return name


def known_events() -> Mapping[str, str]:
    return dict(_REGISTRY)


def describe(name: str) -> str:
    return _REGISTRY.get(name, "(unregistered event)")


class EventCounters:
    """A bag of named monotone counters.

    Unknown names are allowed (mechanisms may register events lazily), but
    `validate()` flags anything never registered -- useful in tests.
    """

    __slots__ = ("counts",)

    def __init__(self, initial: Mapping[str, int] | None = None):
        self.counts: Dict[str, int] = dict(initial or {})

    def inc(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def __getitem__(self, name: str) -> int:
        return self.counts.get(name, 0)

    def get(self, name: str, default: int = 0) -> int:
        return self.counts.get(name, default)

    def as_dict(self) -> Dict[str, int]:
        return dict(self.counts)

    def reset(self) -> None:
        self.counts.clear()

    def merge(self, other: "EventCounters") -> "EventCounters":
        out = EventCounters(self.counts)
        for k, v in other.counts.items():
            out.inc(k, v)
        return out

    def validate(self) -> Iterable[str]:
        """Names present in the counters but never registered."""
        return sorted(k for k in self.counts if k not in _REGISTRY)

    # -- derived conveniences used all over the reports ---------------------

    def rate(self, num: str, den: str) -> float:
        d = self.counts.get(den, 0)
        return self.counts.get(num, 0) / d if d else 0.0

    def per_kinst(self, name: str, kinst: float) -> float:
        return self.counts.get(name, 0) / kinst if kinst else 0.0

    def __eq__(self, other) -> bool:
        """Value equality over nonzero counts (zero entries are equivalent
        to absent ones), so a replayed and a checkpoint-restored counter
        bag compare equal.  Instances stay unhashable (mutable)."""
        if not isinstance(other, EventCounters):
            return NotImplemented
        a = {k: v for k, v in self.counts.items() if v}
        b = {k: v for k, v in other.counts.items() if v}
        return a == b

    __hash__ = None

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v}" for k, v in sorted(self.counts.items()))
        return f"EventCounters({inner})"


__all__ = ["ACCESS", "L2_DEMAND_HIT", "L2_DEMAND_MISS", "L3_DEMAND_HIT",
           "L3_DEMAND_MISS", "L2_PREFETCH_FILL", "L2_PREFETCH_HIT",
           "VICTIM_PROBE", "VICTIM_HIT", "MISS_CACHE_PROBE",
           "MISS_CACHE_HIT", "STREAM_PROBE", "STREAM_HIT", "STREAM_ALLOC",
           "STREAM_FILL", "register_event", "known_events", "describe",
           "EventCounters"]
