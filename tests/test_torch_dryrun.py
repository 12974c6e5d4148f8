"""Parity of the port's dry-run (`repro_torch.models.registry.input_specs`,
`repro_torch.launch.steps`, `repro_torch.launch.dryrun`) with the
reference's, in this process.

  * `input_specs`: shapes, dtypes and tree structure of every
    (arch x applicable shape) cell at full size equal the reference's
    `ShapeDtypeStruct`s (the plans' spec trees and donations:
    `tests/test_torch_dryrun_plans*.py`);
  * per-rank memory: `LoweredPlan.memory` equals the reference's compiled
    `memory_analysis()` on a (2, 4) mesh of eight host devices
    (`tests/_dryrun_reference.py`, a subprocess);
  * `run_cell` on one rank and on the production meshes, and the two
    trace fixes (a prefill reads no position on the host; the MoE routed
    counts are shape-static) keep their results.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as R_CONFIGS, SHAPES as R_SHAPES
from repro.configs.base import applicable_shapes
from repro.models import registry as rreg

# the reference's dry-run sets XLA_FLAGS to 512 host devices when it is
# imported; put them back, so that a later first use of JAX in this
# process (another test file of a worker) sees the devices it expects
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as rdryrun  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS
from repro_torch.configs import CONFIGS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, steps
from repro_torch.models import moe, registry, tuning
from repro_torch.models.common import cache_index
from repro_torch.tree import leaves, structure

TESTS = os.path.dirname(os.path.abspath(__file__))
CELLS = [(arch, shape) for arch in sorted(R_CONFIGS)
         for shape in applicable_shapes(R_CONFIGS[arch])]


@pytest.fixture(autouse=True)
def _restore_knobs():
    """`run_cell` sets a profile, as the reference's does: put the knobs
    back after each test."""
    saved = tuning.snapshot()
    yield
    for name, v in saved.items():
        tuning.set_knob(name, v)


def test_every_cell_is_listed():
    assert len(CELLS) == 32
    assert sorted(CONFIGS) == sorted(R_CONFIGS)


def _shapes(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in leaves(tree)]


def _ref_shapes(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    got = registry.input_specs(CONFIGS[arch], SHAPES[shape])
    want = rreg.input_specs(R_CONFIGS[arch], R_SHAPES[shape])
    assert structure(got) == str(jax.tree.structure(want))
    assert _shapes(got) == _ref_shapes(want)
    assert all(type(x).__name__ == "FakeTensor" for x in leaves(got))


def test_per_rank_memory_equals_the_reference_memory_analysis():
    arch, batch, seq = "stablelm-1.6b", 8, 64
    out = subprocess.run(
        [sys.executable, os.path.join(TESTS, "_dryrun_reference.py"), arch,
         str(batch), str(seq)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    mesh = {"data": 2, "model": 4}
    cfg = get_config(arch).reduced()
    for kind, (arg, alias) in want.items():
        plan = steps.build_plan(cfg, ShapeConfig("t", seq, batch, kind),
                                mesh)
        assert plan.memory(mesh) == {"argument_size_in_bytes": arg,
                                     "alias_size_in_bytes": alias}, kind
    assert want == {"train": [672772, 670724], "prefill": [137216, 0],
                    "decode": [168992, 32784]}


@pytest.mark.parametrize("arch,shape", CELLS[::4])
def test_tokens_and_model_flops_equal_the_reference(arch, shape):
    assert dryrun.tokens_per_step(SHAPES[shape]) == \
        rdryrun.tokens_per_step(R_SHAPES[shape])
    assert dryrun.model_flops(CONFIGS[arch], SHAPES[shape]) == \
        rdryrun.model_flops(R_CONFIGS[arch], R_SHAPES[shape])


# ---------------------------------------------------------------------------
# run_cell and the command line
# ---------------------------------------------------------------------------

@pytest.fixture
def reduced(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_run_cell_on_one_rank_writes_an_ok_record(reduced, shape):
    rec = dryrun.run_cell("granite-8b", shape, local=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == {"data": 1, "model": 1} and rec["n_chips"] == 1
    assert rec["cost"]["matmul flops"] > 0
    assert rec["cost"]["flops"] >= rec["cost"]["matmul flops"]
    assert rec["flops_per_chip"] == rec["cost"]["flops"]
    assert rec["bottleneck"] in ("compute", "memory")
    assert rec["collective_s"] == 0.0 and rec["collectives"] == {}
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "alias_size_in_bytes"}
    assert "compile_s" not in rec and rec["lower_s"] >= 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_run_cell_on_a_production_mesh_ends_in_slice_3f(multi_pod):
    """Slice 3f's per-rank costs: Granite-8B's decode_32k at full size is
    an ok record with the reference's per-chip keys, from rank 0's
    partitioned step on a fake world of 256 or 512 ranks (the plan's
    per-rank memory and the model FLOPs as before); a family outside the
    slice still ends in NotImplementedError, naming slice 3g."""
    rec = dryrun.run_cell("granite-8b", "decode_32k", multi_pod)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_chips"] == (512 if multi_pod else 256)
    cfg = get_config("granite-8b")
    mesh = dryrun.production_mesh(multi_pod)
    plan = steps.build_plan(cfg, SHAPES["decode_32k"], mesh)
    assert rec["memory"] == plan.memory(mesh)
    assert rec["model_flops"] == dryrun.model_flops(cfg, SHAPES["decode_32k"])
    assert rec["flops_per_chip"] == rec["cost"]["flops"] > 0
    assert rec["hbm_bytes_per_chip"] == rec["cost"]["bytes accessed"]
    # FSDP's gathers of the weights' data blocks, Megatron's sums
    assert set(rec["collectives"]) == {"all-gather", "all-reduce"}
    assert rec["collective_bytes_per_chip"] == sum(
        rec["collectives"].values())
    assert rec["collective_s"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < rec["useful_flops_frac"] <= 1
    # decode: 2 x params x tokens of which rank 0 does its share
    assert rec["cost"]["matmul flops"] * rec["n_chips"] >= \
        rec["model_flops"] * 0.9
    assert not torch.distributed.is_initialized()
    other = dryrun.run_cell("jamba-v0.1-52b", "decode_32k", multi_pod)
    assert other["status"] == "error"
    assert other["error"].startswith("NotImplementedError")
    assert "slice 3g" in other["error"]


def test_main_writes_records_and_fails_on_an_error(reduced, tmp_path):
    out = tmp_path / "d.jsonl"
    dryrun.main(["--local", "--arch", "rwkv6-3b", "--shape", "decode_32k",
                 "--out", str(out), "--save-trace", "--trace-dir",
                 str(tmp_path / "tr")])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok"]
    assert (tmp_path / "tr" / "rwkv6-3b_decode_32k_local.ops.jsonl").exists()
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "rwkv6-3b", "--shape", "decode_32k",
                     "--both-meshes", "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok", "error", "error"]


# ---------------------------------------------------------------------------
# The two trace fixes keep their results
# ---------------------------------------------------------------------------

def test_cache_index_takes_a_known_start_without_reading_positions():
    with registry.fake_mode():
        pos = torch.zeros(3, dtype=torch.int32)
        with pytest.raises(Exception):
            cache_index(pos, 32, 8, False)          # a host read
        assert cache_index(pos, 32, 8, False, start=0).start == 0
        assert cache_index(pos, 32, 8, False, start=30).start == 24
    real = torch.tensor([5, 5, 5], dtype=torch.int32)
    assert cache_index(real, 32, 8, False).start == \
        cache_index(real, 32, 8, False, start=5).start == 5


@pytest.mark.parametrize("seed", range(3))
def test_routed_counts_equal_bincount(seed):
    cfg = get_config("jamba-v0.1-52b").reduced()
    rng = np.random.default_rng(seed)
    t, e = 37, cfg.moe.n_experts
    logits = torch.from_numpy(rng.normal(size=(t, e)).astype(np.float32))
    probs = torch.softmax(logits, dim=-1)
    top_e = torch.topk(probs, cfg.moe.top_k, dim=-1).indices
    me, ce, z = moe.router_stats(cfg, logits, probs, top_e)
    want = torch.bincount(top_e.reshape(-1), minlength=e).float() \
        * (1.0 / (t * cfg.moe.top_k))
    assert torch.equal(ce, want)
