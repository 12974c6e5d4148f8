"""Memory-hierarchy simulation and topdown metrics (counterpart of
`repro.telemetry`'s events, hierarchy and topdown modules).

  events     named hardware-event counters (L2_DEMAND_MISS, VICTIM_HIT, ...)
  hierarchy  set-associative caches, prefetcher and the §V mechanisms;
             trace replay and the planned matrices' address traces
  topdown    staged cycle attribution and the VTune-style metric tree

Host-side Python and numpy: these model the Sandy Bridge machine the
reference scores plans for.
"""
from . import events, hierarchy, topdown
from .events import EventCounters, known_events, register_event
from .hierarchy import (CacheLevel, Hierarchy, HierarchySpec, MissCache,
                        SequentialPrefetcher, SetAssocCache, StreamBuffers,
                        VictimCache, format_address_trace, hyb_address_trace,
                        overlay_address_trace, spmv_address_trace)
from .topdown import (STAGE_FIELDS, MetricNode, TopdownStages,
                      machine_stages, stage_cycles, topdown_summary,
                      topdown_tree)

__all__ = [
    "events", "hierarchy", "topdown",
    "EventCounters", "known_events", "register_event",
    "CacheLevel", "Hierarchy", "HierarchySpec", "MissCache",
    "SequentialPrefetcher", "SetAssocCache", "StreamBuffers", "VictimCache",
    "spmv_address_trace", "format_address_trace", "hyb_address_trace",
    "overlay_address_trace",
    "MetricNode", "topdown_tree", "topdown_summary",
    "STAGE_FIELDS", "TopdownStages", "stage_cycles", "machine_stages",
]
