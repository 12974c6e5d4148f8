"""The port stands alone: no module of `repro_torch`, and not the chip
smoke script, imports JAX, the reference package or `msgpack` (the card's
machine has none of them), and the port reads its own data files."""
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro|msgpack)(\.|\s|$)", re.MULTILINE)
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.name} imports {hits}"


#: the streaming and serving slice: each module and the names it must
#: carry (the reference's, where the reference has them)
SLICE_MODULES = {
    "repro_torch.core.delta": ("EdgeDelta", "csr_lookup", "csr_diff",
                               "apply_delta"),
    "repro_torch.plan.fingerprint": ("delta_fingerprint",
                                     "chain_fingerprint",
                                     "forget_fingerprint"),
    "repro_torch.plan.cache": ("PlanCache", "compile_kwargs"),
    "repro_torch.plan.overlay": ("OverlaidPlan", "overlay",
                                 "overlay_eligible",
                                 "DEFAULT_STALENESS_BUDGET"),
    "repro_torch.graph.drivers": ("warm_start_params", "WARM_START_PARAM"),
    "repro_torch.serve_graph.requests": ("AnalyticRequest", "AnalyticResult",
                                         "GraphMutation", "MutationResult"),
    "repro_torch.serve_graph.admission": ("AdmissionController",),
    "repro_torch.serve_graph.scheduler": ("GraphScheduler",
                                          "RunningRequest"),
    "repro_torch.serve_graph.engine": ("GraphEngine", "GraphEngineConfig"),
    # the scoring slice
    "repro_torch.core.generators": ("banded_matrix", "uniform_random_matrix",
                                    "paper_sizes"),
    "repro_torch.core.spmv": ("power_iteration", "pagerank"),
    "repro_torch.core.structure": ("x_access_stream",
                                   "reuse_distance_histogram"),
    "repro_torch.core.cache_model": (
        "MachineModel", "SANDY_BRIDGE", "CacheMetrics", "x_line_popularity",
        "MatrixProfile", "profile_of", "profile_fd", "profile_rmat",
        "analytic_metrics", "analytic_metrics_from_profile",
        "table1_capacity", "simulate_exact"),
    "repro_torch.core.partition": ("rowblock_equal", "rowblock_balanced",
                                   "nnz_split", "col_stripes",
                                   "sort_rows_by_nnz"),
    "repro_torch.telemetry.events": ("register_event", "EventCounters",
                                     "L2_DEMAND_MISS", "STREAM_FILL"),
    "repro_torch.telemetry.hierarchy": (
        "SetAssocCache", "SequentialPrefetcher", "VictimCache", "MissCache",
        "StreamBuffers", "CacheLevel", "Hierarchy", "HierarchySpec",
        "spmv_address_trace", "hyb_address_trace", "format_address_trace",
        "overlay_address_trace"),
    "repro_torch.telemetry.topdown": ("stage_cycles", "machine_stages",
                                      "topdown_tree", "topdown_summary",
                                      "STAGE_FIELDS", "COMPUTE_CPN"),
    "repro_torch.parallel.engine": ("ParallelSpec", "partitioned_traces",
                                    "nnz_partitioned_traces",
                                    "replay_parallel"),
    "repro_torch.parallel.scaling": ("ParallelMetrics", "parallel_metrics",
                                     "simulate_parallel"),
    "repro_torch.checkpoint.manager": ("CheckpointManager",),
    "repro_torch.checkpoint.msgpack_codec": ("packb", "unpackb"),
    "repro_torch.plan.costmodel": (
        "FEATURE_NAMES", "features_for", "CostModel", "fit", "model_bytes",
        "model_digest", "LabelPoint", "label_matrix", "run_label_cell",
        "pick_winner", "evaluate", "save_corpus", "load_corpus",
        "default_model", "set_default_model", "label_cells", "harvest",
        "main"),
    "repro_torch.plan.serial": ("model_state", "model_from_state",
                                "save_model", "load_model", "plan_state",
                                "plan_from_state", "save_plan",
                                "load_plan"),
    "repro_torch.plan.compiler": ("REPLAY_NNZ_MAX", "REORDER_MARGIN"),
    # the measurement slice: sweeps, runner, reports, graph telemetry,
    # harvest, plan serialization, row-sharded plans, the traffic model
    "repro_torch.telemetry.sweep": (
        "MECHANISMS", "SweepPoint", "ScalingPoint", "GraphPoint",
        "run_point", "run_mech_cell", "run_sweep", "reorder_sweep",
        "run_scaling_cell", "scaling_sweep", "graph_sweep",
        "run_graph_cell", "geometry_sweep"),
    "repro_torch.telemetry.runner": (
        "SweepCell", "SweepConfig", "sort_cells", "mech_cells",
        "scaling_cells", "graph_cells", "run_cell", "encode_point",
        "decode_point", "execute_cells", "build_cells", "main"),
    "repro_torch.telemetry.report": (
        "to_csv", "to_json", "to_markdown", "gap_report",
        "plan_cache_report", "scaling_report", "scaling_gap_report",
        "partition_gap_report", "graph_report", "graph_gap_report",
        "reorder_gap_report"),
    "repro_torch.graph.telemetry": ("iteration_counters",
                                    "iteration_summaries",
                                    "iteration_bounds"),
    "repro_torch.kernels._layout": ("ShardedELL", "prepare_ell_shards",
                                    "round_up"),
    "repro_torch.distributed.spmv": ("row_mesh", "default_row_partition",
                                     "spmv_row_sharded",
                                     "spmv_row_sharded_prepared"),
    "repro_torch.core.traffic": ("TrafficReport", "gather_policy",
                                 "stream_policy", "col_blocked_policy",
                                 "bell_policy"),
    # the LM serving slice: configs, the decoder, scheduler and engine
    "repro_torch.configs.base": ("ModelConfig", "MoEConfig", "SSMConfig",
                                 "ShapeConfig", "SHAPES",
                                 "applicable_shapes"),
    "repro_torch.configs.spmv_paper": ("SpMVExperimentConfig", "CONFIG"),
    "repro_torch.distributed.api": ("constrain", "current_mesh", "use_mesh",
                                    "resolve_axis", "logical_spec",
                                    "shard_map", "P", "mesh_dict", "psum",
                                    "pmean", "pmax", "all_gather",
                                    "all_to_all", "ppermute", "psum_scatter",
                                    "axis_index", "axis_size", "transport",
                                    "observe_collectives"),
    # the mesh slice: meshes, shard_map, sharding rules, collectives,
    # the pipeline schedule and the MoE mesh paths
    "repro_torch.launch.mesh": ("make_mesh", "make_production_mesh",
                                "make_local_mesh", "mesh_dict", "launch",
                                "world_plan", "TIMEOUT"),
    "repro_torch.distributed.sharding": (
        "spec_for_leaf", "param_specs", "opt_state_specs", "batch_specs",
        "cache_specs", "block_of", "spec_axes"),
    "repro_torch.distributed.collectives": (
        "ring_allgather_matmul", "lse_merge_attention",
        "reduce_scatter_grads", "crosspod_allreduce_compressed"),
    # the partitioned step: differentiable collectives, the rank layout
    "repro_torch.distributed.autograd": ("all_gather", "psum", "enter",
                                         "pmax"),
    "repro_torch.distributed.partition": (
        "RankLayout", "require_partitioned", "is_partitioned", "cut",
        "assemble", "batch_block", "cache_block", "SLICE_3G"),
    "repro_torch.distributed.pipeline": ("PipelineConfig", "pipeline_apply",
                                         "make_pipelined_mlp",
                                         "reference_apply"),
    "repro_torch.models.common": (
        "apply_norm", "apply_rope", "apply_attention", "apply_mlp",
        "_qk_norm", "_sdpa_chunked", "lm_loss", "init_norm",
        "init_attention", "init_mlp", "dense_init", "embed_init",
        "attn_chunk_for", "dtype_of"),
    "repro_torch.models.transformer": (
        "layer_layout", "split_layout", "init_block", "apply_block",
        "init_block_cache", "init_params", "init_cache", "slice_cache",
        "merge_cache", "forward", "head_matrix", "loss_fn", "prefill",
        "decode_step"),
    "repro_torch.models.registry": ("ModelAPI", "get_model",
                                    "random_train_batch", "fake_mode",
                                    "train_input_specs",
                                    "prefill_input_specs",
                                    "decode_input_specs", "input_specs"),
    # the MoE, Mamba and RWKV blocks and the knobs
    "repro_torch.models.tuning": ("set_profile", "set_knob", "snapshot",
                                  "_PROFILES", "rwkv_chunked_scan",
                                  "mamba_fused_params"),
    "repro_torch.models.moe": ("init_moe", "apply_moe", "apply_moe_auto",
                               "apply_moe_sharded", "apply_moe_a2a",
                               "apply_moe_decode", "dispatch_structure_demo",
                               "route"),
    "repro_torch.models.mamba": ("SCAN_CHUNK", "init_mamba", "_causal_conv",
                                 "_ssm_params", "apply_mamba",
                                 "init_mamba_state"),
    "repro_torch.models.rwkv6": ("init_rwkv_time", "init_rwkv_channel",
                                 "_group_norm", "_token_shift",
                                 "apply_rwkv_time", "_wkv_subchunk",
                                 "_wkv_chunked", "apply_rwkv_channel",
                                 "init_rwkv_state", "_LW_CLIP"),
    "repro_torch.models.convert": ("params_from_reference",
                                   "params_to_reference",
                                   "opt_state_from_reference",
                                   "cache_to_reference",
                                   "cache_from_reference",
                                   "cache_into_reference"),
    # the encoder-decoder
    "repro_torch.models.whisper": ("sinusoids", "init_enc_block",
                                   "init_dec_block", "init_params",
                                   "encode", "decode", "init_cache",
                                   "loss_fn", "prefill", "decode_step"),
    "repro_torch.serve.scheduler": ("Request", "Slot", "Scheduler"),
    "repro_torch.serve.engine": ("EngineConfig", "Engine", "make_engine"),
    "repro_torch.launch.serve": ("synthetic_requests", "main"),
    # the training slice: optimizers, data, fault supervisor, train step,
    # launcher, and the trees they walk
    "repro_torch.tree": ("leaves_with_path", "leaves", "unflatten",
                         "tree_map", "map_with_path", "structure"),
    "repro_torch.optim.adamw": (
        "OptimizerConfig", "AdamWState", "AdafactorState", "cosine_lr",
        "global_norm", "clip_by_global_norm", "adamw_init", "adamw_update",
        "adafactor_init", "adafactor_update", "make_optimizer",
        "optimizer_bytes_per_param"),
    "repro_torch.optim.grad_compress": (
        "CompressionState", "compress_init", "quantize_int8",
        "dequantize_int8", "compress_grads", "decompress_grads",
        "crosspod_allreduce_compressed"),
    "repro_torch.data.pipeline": ("DataConfig", "SyntheticLM",
                                  "PackedFileDataset", "write_token_file",
                                  "make_pipeline"),
    "repro_torch.distributed.fault": ("WorkerState", "HeartbeatMonitor",
                                      "StragglerDetector", "RescalePlan",
                                      "plan_elastic_rescale", "Supervisor"),
    "repro_torch.train.loop": ("TrainConfig", "make_train_step",
                               "init_train_state", "loss_and_grads"),
    "repro_torch.launch.steps": ("ADAFACTOR_THRESHOLD", "optimizer_for",
                                 "LoweredPlan", "params_and_shardings",
                                 "build_train_plan", "build_prefill_plan",
                                 "build_decode_plan", "build_plan"),
    "repro_torch.launch.train": ("build", "main"),
    # the dry-run and the roofline
    "repro_torch.launch.dryrun": ("tokens_per_step", "model_flops",
                                  "run_cell", "main"),
    "repro_torch.roofline.op_costs": ("Costs", "CostCounter", "op_cost",
                                      "costs_of_rows", "top_ops"),
    "repro_torch.roofline.analysis": ("PEAK_FLOPS", "HBM_BW", "LINK_BW",
                                      "Roofline", "analyze",
                                      "model_flops_train",
                                      "model_flops_decode"),
    "repro_torch.roofline.reanalyze": ("reanalyze_record", "main"),
    "repro_torch.roofline.report": ("MOVE_HINTS", "fmt_bytes", "load",
                                    "table", "diagnosis", "main"),
}

#: names each package exports, as the reference's `__init__` does
PACKAGE_EXPORTS = {
    "repro_torch.telemetry": (
        "report", "runner", "sweep", "SweepCell", "SweepConfig",
        "execute_cells", "mech_cells", "scaling_cells", "graph_cells",
        "sort_cells", "ScalingPoint", "scaling_sweep", "scaling_report",
        "scaling_gap_report", "GraphPoint", "graph_sweep", "graph_report",
        "graph_gap_report", "plan_cache_report"),
    "repro_torch.plan": ("save_plan", "load_plan", "plan_state",
                         "plan_from_state", "harvest"),
    "repro_torch.distributed": ("api", "row_mesh", "spmv_row_sharded"),
    "repro_torch.serve": ("Engine", "EngineConfig", "make_engine",
                          "Request", "Scheduler"),
    "repro_torch.models": ("ModelAPI", "get_model", "whisper"),
    "repro_torch.optim": ("grad_compress", "AdamWState", "AdafactorState",
                          "OptimizerConfig", "adamw_init", "adamw_update",
                          "adafactor_init", "adafactor_update", "cosine_lr",
                          "make_optimizer", "optimizer_bytes_per_param"),
    "repro_torch.data": ("DataConfig", "SyntheticLM", "PackedFileDataset",
                         "make_pipeline", "write_token_file"),
    "repro_torch.train": ("TrainConfig", "make_train_step",
                          "init_train_state"),
}


@pytest.mark.parametrize("module", sorted(SLICE_MODULES))
def test_streaming_and_serving_modules(module):
    import importlib

    mod = importlib.import_module(module)
    missing = [n for n in SLICE_MODULES[module] if not hasattr(mod, n)]
    assert not missing, f"{module} lacks {missing}"
    assert (REPO / "src" / (module.replace(".", "/") + ".py")) in FILES


@pytest.mark.parametrize("package", sorted(PACKAGE_EXPORTS))
def test_package_exports(package):
    import importlib

    mod = importlib.import_module(package)
    missing = [n for n in PACKAGE_EXPORTS[package] if not hasattr(mod, n)]
    assert not missing, f"{package} lacks {missing}"
    assert set(PACKAGE_EXPORTS[package]) <= set(mod.__all__)


def test_port_reads_its_own_cost_model_copy():
    """The shipped model and corpus the port loads lie under
    `repro_torch/plan/_data/`, byte-identical to the reference's."""
    from repro_torch.plan import costmodel

    own = REPO / "src" / "repro_torch" / "plan" / "_data"
    assert Path(costmodel.DEFAULT_MODEL_DIR).resolve() == own / "costmodel"
    ref = REPO / "src" / "repro" / "plan" / "_data"
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(own)
                                     for p in own.rglob("*") if p.is_file())
    assert all((own / f).read_bytes() == (ref / f).read_bytes()
               for f in files)


def test_port_imports_without_jax_loaded():
    """Importing every port module in a fresh interpreter loads neither
    jax nor repro."""
    import subprocess
    import sys

    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro', "
            "'msgpack') or m.startswith(('jax.', 'repro.', 'msgpack.'))]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
