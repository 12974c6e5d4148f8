"""Memory-hierarchy simulation, topdown metrics and the paper's sweeps
(counterpart of `repro.telemetry`).

  events     named hardware-event counters (L2_DEMAND_MISS, VICTIM_HIT, ...)
  hierarchy  set-associative caches, prefetcher and the §V mechanisms;
             trace replay and the planned matrices' address traces
  topdown    staged cycle attribution and the VTune-style metric tree
  sweep      geometry x mechanism x reorder x thread sweeps, and whole
             analytics run on the card (`graph_sweep`)
  runner     sharded, checkpointed, resumable sweep execution
  report     CSV / JSON / markdown and the gap reports

The hierarchy models the Sandy Bridge machine the reference scores
plans for; its replay is host-side Python and numpy.
"""
from . import events, hierarchy, report, runner, sweep, topdown
from .events import EventCounters, known_events, register_event
from .hierarchy import (CacheLevel, Hierarchy, HierarchySpec, MissCache,
                        SequentialPrefetcher, SetAssocCache, StreamBuffers,
                        VictimCache, format_address_trace, hyb_address_trace,
                        overlay_address_trace, spmv_address_trace)
from .report import (graph_gap_report, graph_report, plan_cache_report,
                     scaling_gap_report, scaling_report)
from .runner import (SweepCell, SweepConfig, execute_cells, graph_cells,
                     mech_cells, scaling_cells, sort_cells)
from .sweep import GraphPoint, ScalingPoint, graph_sweep, scaling_sweep
from .topdown import (STAGE_FIELDS, MetricNode, TopdownStages,
                      machine_stages, stage_cycles, topdown_summary,
                      topdown_tree)

__all__ = [
    "events", "hierarchy", "report", "runner", "sweep", "topdown",
    "EventCounters", "known_events", "register_event",
    "CacheLevel", "Hierarchy", "HierarchySpec", "MissCache",
    "SequentialPrefetcher", "SetAssocCache", "StreamBuffers", "VictimCache",
    "spmv_address_trace", "format_address_trace", "hyb_address_trace",
    "overlay_address_trace",
    "MetricNode", "topdown_tree", "topdown_summary",
    "STAGE_FIELDS", "TopdownStages", "stage_cycles", "machine_stages",
    "SweepCell", "SweepConfig", "execute_cells", "mech_cells",
    "scaling_cells", "graph_cells", "sort_cells",
    "ScalingPoint", "scaling_sweep", "scaling_report", "scaling_gap_report",
    "GraphPoint", "graph_sweep", "graph_report", "graph_gap_report",
    "plan_cache_report",
]
