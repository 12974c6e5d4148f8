"""Port vs reference: plans through checkpoints (`plan.serial`'s plan
half) and the cost-model harvest.

For every format -- dia, ell, csr, csr-seg, hyb, bell and ell-sharded,
and a reordered plan -- `plan_state` gives the reference's tree: the
same leaves, byte-equal arrays (dtypes included), and a meta record
equal to the reference's but for `compile_stats`' timings.  A plan
saved by either package loads in the other and multiplies as the
original does; a sharded plan loaded without a mesh refuses with the
reference's message.  (The port writes zlib, the codec of the shipped
artifacts, and reads zlib and -- where the optional `zstandard` imports
-- zstd, the reference's default codec there; the cross-loads pin zlib,
and a reference save under its default codec loads in the port too.)
The seed-0 harvest at log2n 8 equals the shipped corpus rows, and
`label_cells` the reference's grid.
"""
import dataclasses
import json
import os

import msgpack
import numpy as np
import pytest
import torch
from _torch_parity import int_operands, port_csr

from repro import plan as rplan
from repro.core.partition import rowblock_equal as r_equal
from repro.plan import costmodel as rcm
from repro.telemetry import runner as rrun
from repro_torch import plan as tplan
from repro_torch.checkpoint import CheckpointManager, packb
from repro_torch.distributed import row_mesh
from repro_torch.plan import costmodel as tcm
from repro_torch.telemetry import runner as trun

SHARDS = 4

#: name -> (family, compile options); 'ell-sharded' adds a 4-part mesh
PLANS = {
    "dia": ("fd", {"format": "dia"}),
    "ell": ("fd", {"format": "ell"}),
    "csr": ("rmat", {"format": "csr"}),
    "csr-seg": ("rmat", {"format": "csr-seg"}),
    "hyb": ("rmat", {}),
    "bell": ("fd", {"format": "bell"}),
    "ell-sharded": ("rmat", {}),
    "rcm-csr": ("rmat", {"format": "csr", "reorder": "rcm"}),
    "unscored-plain": ("fd", {"use_pallas": False}),
}


def _ref_save(plan, path, step=0):
    from repro.checkpoint.manager import CheckpointManager

    rplan.save_plan(plan, path, step=step,
                    manager=CheckpointManager(path, codec="zlib"))


def _pair(name):
    family, opts = PLANS[name]
    ref, x = int_operands(family, 256, 5, "plus_times")
    port = port_csr(ref)
    opts = dict(dict(reorder="none", predictor="none"), **opts)
    if name == "ell-sharded":
        # the reference's sharded compile needs a mesh only to store it
        rp = rplan.compile(ref, mesh=object(), partition=r_equal(ref, SHARDS),
                           **opts)
        tp = tplan.compile(port, mesh=row_mesh(["cpu"] * SHARDS), **opts)
    else:
        rp = rplan.compile(ref, **opts)
        tp = tplan.compile(port, device="cpu", **opts)
    return rp, tp, x


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _meta(blob):
    meta = msgpack.unpackb(np.asarray(blob, np.uint8).tobytes(),
                           strict_map_key=False)
    meta["compile_stats"] = {k: v for k, v in meta["compile_stats"].items()
                             if not k.endswith("_s")}
    return meta


def _same_state(ref_state, port_state):
    r, t = _flat(ref_state), _flat(port_state)
    assert sorted(r) == sorted(t)
    assert _meta(r.pop("meta")) == _meta(t.pop("meta"))
    for key in r:
        a, b = np.asarray(r[key]), np.asarray(t[key])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), key
        assert a.tobytes() == b.tobytes(), key


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_state_is_the_references(name):
    from repro.plan.serial import plan_state as r_state

    rp, tp, _ = _pair(name)
    assert tp.format_name == rp.format_name
    _same_state(r_state(rp), tplan.plan_state(tp))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plans_cross_load_both_ways(name, tmp_path):
    from repro.plan.serial import plan_state as r_state

    rp, tp, x = _pair(name)
    mesh = row_mesh(["cpu"] * SHARDS) if name == "ell-sharded" else None
    want = tp.execute(x)
    # reference -> port
    _ref_save(rp, str(tmp_path / "ref"), step=2)
    got, step = tplan.load_plan(str(tmp_path / "ref"), mesh=mesh,
                                device="cpu")
    assert step == 2 and got.format_name == rp.format_name
    assert torch.equal(got.execute(x), want)
    _same_state(r_state(rp), tplan.plan_state(got))
    # port -> reference: the same plan as the reference's own round trip
    # (whose restore narrows int64 leaves to int32 with x64 off)
    tplan.save_plan(tp, str(tmp_path / "port"))
    back, _ = rplan.load_plan(str(tmp_path / "port"))
    own, _ = rplan.load_plan(str(tmp_path / "ref"))
    _same_state(r_state(own), r_state(back))
    if name != "ell-sharded":
        assert np.array_equal(np.asarray(back.execute(x)),
                              np.asarray(rp.execute(x)))


def test_sharded_plan_without_a_mesh_refuses_like_the_reference(tmp_path):
    rp, tp, x = _pair("ell-sharded")
    tplan.save_plan(tp, str(tmp_path / "ck"))
    errors = []
    for load in (lambda: rplan.load_plan(str(tmp_path / "ck"))[0],
                 lambda: tplan.load_plan(str(tmp_path / "ck"),
                                         device="cpu")[0]):
        p = load()
        assert p.mesh is None and p.format_name == "ell-sharded"
        with pytest.raises(ValueError) as e:
            p.execute(x)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == (
        "sharded plan has no mesh bound; pass mesh= to load_plan or set "
        "plan.mesh")
    # rebound with mesh=
    again, _ = tplan.load_plan(str(tmp_path / "ck"),
                               mesh=row_mesh(["cpu"] * SHARDS))
    assert torch.equal(again.execute(x), tp.execute(x))


@pytest.mark.parametrize("name", ["hyb", "csr", "rcm-csr"])
def test_reference_default_codec_save_loads_in_the_port(name, tmp_path):
    """A reference `save_plan` with default settings (zstd where
    `zstandard` imports) loads with the port's `load_plan`: byte-equal
    arrays and an equal `execute`."""
    from repro.checkpoint import manager as rman
    from repro.plan.serial import plan_state as r_state

    if rman.DEFAULT_CODEC != "zstd":
        pytest.skip("zstandard is not installed: the reference's default "
                    "codec is zlib here, which the cross-loads cover")
    rp, tp, x = _pair(name)
    rplan.save_plan(rp, str(tmp_path))
    shards = sorted(os.listdir(tmp_path / "step_000000000"))
    assert "shard_00000.bin.zst" in shards
    got, step = tplan.load_plan(str(tmp_path), device="cpu")
    assert step == 0 and got.format_name == rp.format_name
    _same_state(r_state(rp), tplan.plan_state(got))
    assert torch.equal(got.execute(x), tp.execute(x))
    assert np.array_equal(got.execute(x).numpy(),
                          np.asarray(rp.execute(x)))


def test_zstd_without_zstandard_is_refused_naming_the_codec(tmp_path,
                                                            monkeypatch):
    """Where `zstandard` does not import, a zstd checkpoint is refused
    with the reference's error, which names the codec."""
    from repro_torch.checkpoint import manager as tman

    tp = _pair("csr")[1]
    tplan.save_plan(tp, str(tmp_path))
    step_dir = tmp_path / "step_000000000"
    mgr = CheckpointManager(str(tmp_path))
    man = mgr.load_manifest(0)
    man["codec"] = "zstd"
    (step_dir / "manifest.msgpack").write_bytes(packb(man))
    os.replace(step_dir / "shard_00000.bin.zlib",
               step_dir / "shard_00000.bin.zst")
    monkeypatch.setattr(tman, "_DECOMPRESS", {"zlib": tman.zlib.decompress})
    with pytest.raises(ModuleNotFoundError, match="codec 'zstd'.*have: "
                       r"\['zlib'\]"):
        tplan.load_plan(str(tmp_path), device="cpu")


def test_a_non_default_window_is_recorded_and_rebuilt(tmp_path):
    ref, x = int_operands("rmat", 256, 5, "plus_times")
    tp = tplan.compile(port_csr(ref), reorder="none", predictor="none",
                       seg_len=64, device="cpu")
    state = tplan.plan_state(tp)
    knobs = _meta(state["meta"])["prep_knobs"]
    assert knobs == {"seg_len": 512, "bm": 128, "window": 64}
    back = tplan.plan_from_state(state, device="cpu")
    assert back.prep.heavy.window == 64
    assert torch.equal(back.execute(x), tp.execute(x))


def test_harvest_of_fd_log2n_8_seed_0_is_the_corpus():
    rows = tcm.harvest(kinds=("fd",), log2ns=(8,), seeds=(0,),
                       device="cpu")
    want = [r for r in tcm.load_corpus(tcm.DEFAULT_CORPUS)
            if (r.kind, r.log2n, r.seed) == ("fd", 8, 0)]
    assert len(rows) == len(want) == 16
    assert json.dumps([dataclasses.asdict(r) for r in rows],
                      sort_keys=True) == \
        json.dumps([dataclasses.asdict(r) for r in tcm.sort_rows(want)],
                   sort_keys=True)


def test_label_cells_equal_the_references():
    want = [c.key() for c in rcm.label_cells()]
    got = [c.key() for c in tcm.label_cells()]
    assert got == want and len(got) == 240
    assert [dataclasses.astuple(c) for c in tcm.label_cells()] == \
        [dataclasses.astuple(c) for c in rcm.label_cells()]
    assert isinstance(tcm.label_cells()[0], trun.SweepCell)
    assert isinstance(rcm.label_cells()[0], rrun.SweepCell)


def test_costmodel_cli_checks_the_shipped_model(capsys):
    assert tcm.main(["--check"]) == 0
    out = capsys.readouterr().out
    assert "OK" in out and "agreement on checked-in corpus: 0.947" in out
