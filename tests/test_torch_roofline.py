"""Parity of the port's roofline (`repro_torch.roofline`) with the
reference's (`repro.roofline`), in this process.

The reference prices the ops of compiled HLO (`hlo_costs`); the port
prices the aten ops of a step traced once (`op_costs.CostCounter`).
Held here:
  * the golden program of `tests/test_roofline.py` as torch code: the
    loop's and the last matmul's FLOPs, the psum's wire bytes and calls
    on a two-rank gloo world, and `top_ops`' rows;
  * each collective's kind and ring-factor wire bytes, and the op
    conventions (views free, a slice update and a gather moved twice);
  * `Costs` arithmetic and `analyze`'s `Roofline`, field for field;
  * matmul FLOPs of prefill, decode and train at reduced size on one
    device, for one arch of each family, against the reference's HLO dot
    FLOPs -- exactly, with every difference named as the op behind it;
  * `report`'s tables and `reanalyze`'s records.
"""
import copy
import dataclasses
import json

import jax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _roofline_golden import golden_program, golden_rank
from test_roofline import GOLDEN
from repro.configs import get_config as r_get_config
from repro.configs.base import ShapeConfig as RShape
from repro.launch import steps as rsteps
from repro.launch.mesh import make_local_mesh as r_local_mesh
from repro.roofline import analysis as ranalysis
from repro.roofline import hlo_costs
from repro.roofline import report as rreport
from repro.models import tuning as rtuning
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import api
from repro_torch.distributed.api import P
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import World
from repro_torch.models import registry, tuning
from repro_torch.models.transformer import layer_layout, split_layout
from repro_torch.roofline import analysis, op_costs, reanalyze, report
from repro_torch.tree import leaves

LOOP_DOT = 2 * 8 * 16 * 16          # (8, 16) x (16, 16)


@pytest.fixture(autouse=True)
def default_knobs():
    """Both packages' knobs at their defaults (all on) in each test, and
    as they were after it: `run_cell` sets a profile, as the
    reference's does, and a worker runs other files before this one."""
    saved = [(mod, mod.snapshot()) for mod in (tuning, rtuning)]
    for mod, snap in saved:
        for name in snap:
            mod.set_knob(name, True)
    yield
    for mod, snap in saved:
        for name, v in snap.items():
            mod.set_knob(name, v)

FINAL_DOT = 2 * 32 * 64 * 8         # (32, 64) x (64, 8)


def ref_dots(hlo_text):
    """The reference's dot rows (value, opcode, name, multiplier, tag)."""
    return [r for r in hlo_costs.top_ops(hlo_text, by="flops", k=10 ** 9)
            if r[1] == "dot"]


# ---------------------------------------------------------------------------
# The counter on the golden program
# ---------------------------------------------------------------------------

def test_golden_program_counts_the_reference_dot_flops():
    with op_costs.CostCounter() as cc:
        golden_program()
    c = cc.costs()
    want = sum(r[0] for r in ref_dots(GOLDEN))
    assert c.matmul_flops == 10 * LOOP_DOT + FINAL_DOT == want
    assert c.collective_bytes == {} and c.unknown_trip_counts == 0
    # the loop's matmul first, its multiplier the trip count
    got = [(v, m) for v, _, _, m, _ in cc.top_ops(by="matmul_flops", k=2)]
    ref = [(v, m) for v, _, _, m, _ in hlo_costs.top_ops(GOLDEN, by="flops",
                                                         k=2)]
    assert got == ref == [(10 * LOOP_DOT, 10), (FINAL_DOT, 1)]
    assert cc.top_ops(by="matmul_flops")[0][1:3] == ("mm", "aten.mm.default")


def _collectives_rank(rank):
    """Each collective of `distributed.api` once, inside a shard_map over
    two ranks, under the counter."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2,), ("data",))

    def body(_):
        x = torch.ones(8, 16)
        api.pmax(x, "data")
        api.all_gather(x, "data")
        api.psum_scatter(x, "data")
        api.all_to_all(torch.ones(2, 64), "data")
        api.ppermute(x, "data", [(0, 1), (1, 0)])
        return torch.ones(1)

    with op_costs.CostCounter() as cc:
        api.shard_map(body, mesh, (P(),), P("data"))(torch.zeros(1))
    c = cc.costs()
    return dict(c.collective_bytes), dict(c.collective_counts)


@pytest.fixture(scope="module")
def two_ranks():
    with World(2, "cpu") as world:
        yield world


def test_golden_psum_on_two_ranks_is_the_reference_all_reduce(two_ranks):
    mc = hlo_costs.module_costs(GOLDEN)
    for matmul, wire, calls, flops in two_ranks.run(golden_rank):
        assert matmul == 10 * LOOP_DOT + FINAL_DOT
        assert wire == mc.collective_bytes == {"all-reduce": 2 * 512 * 10}
        assert calls == mc.collective_counts == {"all-reduce": 10}
        assert flops == matmul + 10 * 8 * 16     # the psum's adds


def test_each_collective_reports_its_ring_wire_bytes(two_ranks):
    f = ranalysis._WIRE_FACTOR
    x = 8 * 16 * 4                                  # a (8, 16) float32
    want = {"all-reduce": f["all-reduce"] * x,      # pmax: operand
            "all-gather": f["all-gather"] * 2 * x   # its result
            + 2 * 4,                                # the output's assembly
            "reduce-scatter": f["reduce-scatter"] * x,
            "all-to-all": f["all-to-all"] * x,
            "collective-permute": f["collective-permute"] * x}
    for wire, calls in two_ranks.run(_collectives_rank):
        assert wire == want
        assert calls == {"all-reduce": 1, "all-gather": 2,
                         "reduce-scatter": 1, "all-to-all": 1,
                         "collective-permute": 1}


def test_a_collective_over_one_member_moves_nothing():
    seen = []
    mesh = {"data": 1}

    class OneRank(dict):
        def get_local_rank(self, axis):
            return 0

    with api.observe_collectives(lambda *a: seen.append(a)):
        api.shard_map(lambda x: api.psum(x, "data"), OneRank(mesh), (P(),),
                      P())(torch.ones(3))
    assert seen == []


def test_op_conventions():
    """Views are free; a slice update moves the slice twice (the
    reference's dynamic-update-slice), a gather its result twice and the
    indices; elementwise ops one flop an element, a softmax five with one
    transcendental."""
    buf = torch.zeros(16, 8)
    new = torch.ones(2, 8)
    idx = torch.tensor([1, 3, 5])
    with op_costs.CostCounter() as cc:
        v = buf.t().reshape(-1)[:64].view(8, 8)
        buf[2:4] = new
        g = buf[idx]
        e = torch.exp(v)
        s = torch.softmax(v, dim=-1)
        a = e + s
    rows = {r["op"]: r for r in cc.rows()}
    assert "aten.t.default" not in rows and "aten.view.default" not in rows
    assert rows["aten.copy_.default"]["bytes"] == 2 * 2 * 8 * 4
    assert rows["aten.index.Tensor"]["bytes"] == 2 * 3 * 8 * 4 + 3 * 8
    assert rows["aten.exp.default"]["transcendental"] == 64
    assert rows["aten._softmax.default"]["flops"] == 5 * 64
    assert rows["aten._softmax.default"]["transcendental"] == 64
    assert rows["aten.add.Tensor"]["flops"] == 64
    assert rows["aten.add.Tensor"]["bytes"] == 3 * 64 * 4
    assert all(r["matmul_flops"] == 0 for r in rows.values())
    assert g.shape == (3, 8) and a.shape == (8, 8)


# ---------------------------------------------------------------------------
# Costs and the analysis
# ---------------------------------------------------------------------------

def _port_costs(rc):
    return op_costs.Costs(**{f.name: copy.deepcopy(getattr(rc, f.name))
                             for f in dataclasses.fields(rc)})


def test_costs_arithmetic_equals_the_reference():
    rc = hlo_costs.module_costs(GOLDEN)
    pc = _port_costs(rc)
    for k in (1.0, 3.0, 0.5):
        r, p = rc.scaled(k), pc.scaled(k)
        for f in dataclasses.fields(rc):
            assert getattr(p, f.name) == getattr(r, f.name), f.name
    r, p = rc.scaled(2.0), pc.scaled(2.0)
    r.add(hlo_costs.module_costs(GOLDEN))
    p.add(_port_costs(hlo_costs.module_costs(GOLDEN)))
    for f in dataclasses.fields(rc):
        assert getattr(p, f.name) == getattr(r, f.name), f.name
    assert p.total_collective_bytes == r.total_collective_bytes


@pytest.mark.parametrize("unknown_trip", [False, True])
@pytest.mark.parametrize("n_chips,mflops", [(4, 1e6), (256, 3.0e15),
                                            (1, 0.0)])
def test_analyze_equals_the_reference(n_chips, mflops, unknown_trip):
    hlo = GOLDEN.replace(', backend_config={"known_trip_count":{"n":"10"}}',
                         "") if unknown_trip else GOLDEN
    want = ranalysis.analyze({}, hlo, n_chips=n_chips, model_flops=mflops)
    got = analysis.analyze(_port_costs(hlo_costs.module_costs(hlo)),
                           n_chips=n_chips, model_flops=mflops,
                           peak_flops=ranalysis.PEAK_FLOPS,
                           hbm_bw=ranalysis.HBM_BW,
                           link_bw=ranalysis.LINK_BW)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()


def test_the_card_constants_and_model_flops():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    c = op_costs.Costs(flops=989e12, bytes=3.35e12,
                       collective_bytes={"all-reduce": 450e9})
    rl = analysis.analyze(c, n_chips=1)
    assert (rl.compute_s, rl.memory_s, rl.collective_s) == (1.0, 1.0, 1.0)
    for n, t in ((1e9, 1e6), (7.3e10, 4096.0)):
        assert analysis.model_flops_train(n, t) == \
            ranalysis.model_flops_train(n, t)
        assert analysis.model_flops_decode(n, t) == \
            ranalysis.model_flops_decode(n, t)


# ---------------------------------------------------------------------------
# Matmul FLOPs of the steps against the reference's HLO dots
# ---------------------------------------------------------------------------

FAMILIES = {"dense": "stablelm-1.6b", "moe": "arctic-480b",
            "jamba": "jamba-v0.1-52b", "rwkv": "rwkv6-3b",
            "whisper": "whisper-large-v3"}
BATCH, SEQ = 2, 64
ONE_RANK = {"data": 1, "model": 1}


class OuterProducts(TorchDispatchMode):
    """FLOPs of the matmuls whose contraction is 1: outer products,
    which XLA's algebraic simplifier emits as a multiply, not a dot."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__.split(".")[0]
        if name in ("mm", "bmm", "addmm", "baddbmm"):
            a = args[1] if name.startswith(("addmm", "baddbmm")) else args[0]
            if a.shape[-1] == 1:
                self.flops += 2 * out.numel()
        return out


def superblock_recompute(cfg, tokens):
    """The reference checkpoints each super-block of `period` layers
    (`transformer.forward`'s scanned `superblock`); its recompute keeps a
    dense MLP's last matmul (w_down) unless the layer ends the
    super-block.  The port checkpoints each layer, and torch's early stop
    never reruns a layer's last matmul."""
    if cfg.is_encdec:
        return 0
    prefix, period, n_super = split_layout(cfg)
    block = layer_layout(cfg)[prefix:prefix + period]
    dense = sum(1 for pos, (kind, is_moe) in enumerate(block)
                if not is_moe and kind != "rwkv" and pos < period - 1)
    return n_super * dense * 2 * tokens * cfg.d_ff * cfg.d_model


def mamba_inner_recompute(cfg, tokens):
    """Mamba's checkpointed chunk body (x_proj and dt_proj; checkpointed
    under `tuning.mamba_fused_params`) runs a third time in the port's
    backward, once per Mamba layer; XLA merges the reference's inner
    recompute with its super-block's."""
    n = sum(1 for kind, _ in layer_layout(cfg) if kind == "mamba") \
        if not cfg.is_encdec and tuning.mamba_fused_params else 0
    if not n:
        return 0
    di = cfg.ssm.expand * cfg.d_model
    dt_rank = max(cfg.d_model // 16, 1)          # `mamba.init_mamba`'s
    return n * (2 * tokens * di * (dt_rank + 2 * cfg.ssm.d_state)
                + 2 * tokens * dt_rank * di)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_matmul_flops_equal_the_reference_dots(family, kind):
    arch = FAMILIES[family]
    rplan = rsteps.build_plan(r_get_config(arch).reduced(),
                              RShape("t", SEQ, BATCH, kind), r_local_mesh())
    rows = ref_dots(jax.jit(rplan.fn).lower(*rplan.in_specs).compile()
                    .as_text())
    ref = sum(r[0] for r in rows)

    cfg = get_config(arch).reduced()
    plan = steps.build_plan(cfg, ShapeConfig("t", SEQ, BATCH, kind),
                            ONE_RANK)
    with registry.fake_mode(), op_costs.CostCounter() as cc, \
            OuterProducts() as outer:
        plan.fn(*plan.in_specs)
    port = cc.costs().matmul_flops

    # the ops behind the differences, all of them in the train step:
    # the reference's `tuning.attn_chunk_remat` checkpoints each
    # attention chunk inside the checkpointed block, so its backward
    # recomputes QK^T once more
    nested = sum(r[0] for r in rows
                 if "checkpoint/checkpoint/rematted_computation/" in r[4])
    tokens = BATCH * SEQ
    extra_ref = nested + (superblock_recompute(cfg, tokens)
                          if kind == "train" else 0)
    extra_port = outer.flops + (mamba_inner_recompute(cfg, tokens)
                                if kind == "train" else 0)
    if kind != "train":
        assert nested == 0 and outer.flops == 0
    if family in ("dense", "moe", "whisper") or kind != "train":
        assert extra_ref == nested and extra_port == 0
    assert port == ref - extra_ref + extra_port, (port, ref, extra_ref,
                                                  extra_port)
    if family == "dense" and kind == "prefill":
        assert port == ref == 84_148_224


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


@pytest.mark.parametrize("arch,kind", [
    ("stablelm-1.6b", "train"), ("stablelm-1.6b", "prefill"),
    ("stablelm-1.6b", "decode"), ("whisper-large-v3", "decode")])
def test_floor_bytes_are_the_inputs_the_step_reads(arch, kind):
    """Train: parameters and optimizer moments read and written back,
    the batch read (the step counter, a host constant, is read by no
    op).  Prefill and decode: parameters and inputs read once, a decode
    step's cache left out, a table read through a gather (the token
    embedding, Whisper's decoder positions) left out too; Whisper's
    decode step reads no encoder weight."""
    cfg = get_config(arch).reduced()
    plan = steps.build_plan(cfg, ShapeConfig("t", SEQ, BATCH, kind),
                            ONE_RANK)
    cc = plan.trace()
    params = plan.in_specs[0]
    if kind == "train":
        opt = plan.in_specs[1]
        assert not cc.touches(opt.step)
        want = 2 * (_nbytes(params) + _nbytes(opt) - _nbytes(opt.step)) \
            + _nbytes(plan.in_specs[2])
    else:
        unread = {"dec_pos", "enc_norm", "enc_stack"} if cfg.is_encdec \
            else {"embed"}
        assert unread == {k for k, v in params.items() if leaves(v)
                          and not any(cc.touches(x) for x in leaves(v))}
        want = _nbytes({k: v for k, v in params.items() if k not in unread}) \
            + _nbytes(plan.in_specs[-1])
    assert plan.floor_bytes(cc) == want


# ---------------------------------------------------------------------------
# Report and reanalyze
# ---------------------------------------------------------------------------

def _records():
    """Reference-shaped records: ok and failed cells on both meshes."""
    recs = []
    for i, (arch, shape, kind, bottleneck) in enumerate((
            ("granite-8b", "train_4k", "train", "compute"),
            ("granite-8b", "decode_32k", "decode", "memory"),
            ("jamba-v0.1-52b", "prefill_32k", "prefill", "collective"))):
        for mp in (False, True):
            mesh = ({"pod": 2, "data": 16, "model": 16} if mp
                    else {"data": 16, "model": 16})
            rec = {"arch": arch, "shape": shape, "kind": kind, "mesh": mesh,
                   "n_chips": 512 if mp else 256, "status": "ok",
                   "compute_s": 0.01 * (i + 1), "memory_s": 0.02 / (i + 1),
                   "collective_s": 0.003 * i, "bottleneck": bottleneck,
                   "useful_flops_frac": 0.25 + 0.1 * i,
                   "collectives": {"all-reduce": 1.5e9 * i,
                                   "all-gather": 2.0e6}}
            recs.append(rec)
    recs.append({"arch": "qwen2-72b", "shape": "train_4k", "kind": "train",
                 "mesh": {"data": 16, "model": 16}, "n_chips": 256,
                 "status": "error", "error": "NotImplementedError: " + "x" * 80})
    return recs


def test_report_equals_the_reference(tmp_path):
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    got, want = report.load(str(path)), rreport.load(str(path))
    for mp in (False, True):
        assert report.table(got, multi_pod=mp) == \
            rreport.table(want, multi_pod=mp)
    assert report.diagnosis(got) == rreport.diagnosis(want).replace(
        "already MXU-bound", "already bound by the tensor cores")
    assert report.fmt_bytes(3.5e9) == rreport.fmt_bytes(3.5e9)
    out = tmp_path / "roofline.md"
    report.main(["--in", str(path), "--out", str(out)])
    assert rreport.table(want) in out.read_text()


def test_reanalyze_rederives_a_record(tmp_path, monkeypatch):
    """A one-rank dry-run record, re-derived from its saved per-op trace,
    equals the original; without the trace it is left as it was."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    rec = dryrun.run_cell("stablelm-1.6b", "decode_32k", local=True,
                          trace_dir=str(tmp_path), save_trace=True)
    assert rec["status"] == "ok", rec.get("error")
    again = reanalyze.reanalyze_record(json.loads(json.dumps(rec)),
                                       str(tmp_path))
    assert again.pop("reanalyzed") is True
    assert again == json.loads(json.dumps(rec))
    gone = reanalyze.reanalyze_record(dict(rec), str(tmp_path / "none"))
    assert gone["reanalyzed"] is False
    rows = [json.loads(line) for line in open(reanalyze.trace_path(
        rec, str(tmp_path)))]
    assert set(rows[0]) == set(op_costs.ROW_FIELDS)
    table = report.table({("stablelm-1.6b", "decode_32k", "local"): rec},
                         multi_pod="local")
    assert "| stablelm-1.6b | decode_32k | decode |" in table
