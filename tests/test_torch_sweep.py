"""Port vs reference: the paper's sweeps (`repro_torch.telemetry.sweep`,
`runner`, `graph.telemetry`) on the CPU.

Every mech, scaling and label point, and every BFS / SSSP graph point,
encodes to the reference's bytes.  A PageRank graph point equals the
reference's in all but its iteration count: PageRank stops on a float32
L1 residual below 1e-8, where the sums' rounding decides the step that
gets there, and the reference's sums are XLA's on the host CPU (a
fused multiply-add in DIA's `out += band * window`, a vectorised
`.sum(axis=1)` in ELL, a one-hot matrix-vector product in padded CSR,
XLA's dot and reduction in the stepper); so those points are held to
the reference's structure -- format, nnz, convergence and the
per-iteration counters of the iterations both ran -- their rank
vectors to the reference's within the L1 distance float32 rounding
allows, after the iterations both ran and at each run's end, and their
counts are printed (ROADMAP C3).  Payloads round-trip exactly; worker, resumed
and cross-package checkpointed runs give the serial bytes; both CLIs
print the reference's lines.
"""
import dataclasses
import os

import numpy as np
import pytest

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.core.partition import rowblock_balanced as r_balanced
from repro.graph import telemetry as rgt
from repro.plan import costmodel as rcm
from repro.reorder import STRATEGIES as R_STRATEGIES
from repro.telemetry import runner as rrun
from repro.telemetry import sweep as rsw
from repro.telemetry.hierarchy import HierarchySpec as RSpec
from repro_torch.core.generators import fd_matrix, rmat_matrix
from repro_torch.graph import telemetry as tgt
from repro_torch.plan import costmodel as tcm
from repro_torch.reorder import STRATEGIES as T_STRATEGIES
from repro_torch.telemetry import runner as trun
from repro_torch.telemetry import sweep as tsw
from repro_torch.telemetry.hierarchy import HierarchySpec as TSpec

GRAPH_SPEC = {"l2_bytes": 16384, "l3_bytes": 65536}
ANALYTICS = ("pagerank", "bfs", "sssp")


def _blobs(enc, points):
    return [enc(p) for p in points]


@pytest.mark.parametrize("log2n", [8, 10])
def test_mech_points_are_the_references_bytes(log2n):
    kw = dict(log2ns=(log2n,), threads_list=(1, 2), sweeps=2)
    ref = rsw.run_sweep(reorderings={"none": None,
                                     "rcm": R_STRATEGIES["rcm"]}, **kw)
    port = tsw.run_sweep(reorderings={"none": None,
                                      "rcm": T_STRATEGIES["rcm"]},
                         device="cpu", **kw)
    assert len(port) == 2 * 2 * 2 * 5
    assert _blobs(trun.encode_point, port) == _blobs(rrun.encode_point, ref)


@pytest.mark.parametrize("partition", ["equal", "balanced", "merge"])
def test_scaling_points_are_the_references_bytes(partition):
    kw = dict(log2ns=(8,), threads_list=(1, 2, 4), partition=partition)
    ref = rsw.scaling_sweep(**kw)
    port = tsw.scaling_sweep(device="cpu", **kw)
    assert _blobs(trun.encode_point, port) == _blobs(rrun.encode_point, ref)


def test_label_points_are_the_references_bytes():
    for kind in tcm.LABEL_KINDS:
        a = rcm.run_label_cell(kind, 8, "rcm", 2, "scaled", seed=1)
        b = tcm.run_label_cell(kind, 8, "rcm", 2, "scaled", seed=1,
                               device="cpu")
        assert trun.encode_point(b) == rrun.encode_point(a)


GRAPH_CELLS = [(kind, analytic, fmt) for fmt in (None, "csr")
               for kind in ("fd", "rmat") for analytic in ANALYTICS]


@pytest.mark.parametrize("kind,analytic,fmt", GRAPH_CELLS)
def test_graph_points_match_the_reference(kind, analytic, fmt):
    a = rsw.run_graph_cell(kind, 8, analytic, spec=RSpec(**GRAPH_SPEC),
                           max_iters=128, format=fmt)
    b = tsw.run_graph_cell(kind, 8, analytic, spec=TSpec(**GRAPH_SPEC),
                           max_iters=128, format=fmt, device="cpu")
    if analytic != "pagerank":
        assert trun.encode_point(b) == rrun.encode_point(a)
        return
    print(f"pagerank {kind} {b.format_name}: n_iters port={b.n_iters} "
          f"reference={a.n_iters}")
    keep = min(a.n_iters, b.n_iters)
    same = ("kind", "log2n", "nnz", "analytic", "semiring", "converged",
            "format_name")
    assert [getattr(b, f) for f in same] == [getattr(a, f) for f in same]
    assert a.converged
    assert [s.as_dict() for s in b.iters[:keep]] == \
        [s.as_dict() for s in a.iters[:keep]]
    # the iterates: after the iterations both ran, and each run's last
    ref_at, port_at = _pagerank_both(kind, fmt, keep)
    ref_end, port_end = _pagerank_both(kind, fmt, 128)
    assert (ref_end.n_iters, port_end.n_iters) == (a.n_iters, b.n_iters)
    gap = [float(np.abs(p.values.astype(np.float64) - r.values).sum())
           for r, p in ((ref_at, port_at), (ref_end, port_end))]
    bound = _pagerank_l1_bound(port_end.plan.csr)
    print(f"pagerank {kind}: L1 port vs reference after {keep} iterations "
          f"{gap[0]:.3g}, at each run's end {gap[1]:.3g}; bound "
          f"{bound:.3g} (+ {_PR_STOP:.3g} at the ends)")
    assert gap[0] <= bound and gap[1] <= bound + _PR_STOP


#: PageRank's damping and L1 stopping tolerance (both drivers' defaults)
_PR_D, _PR_TOL = 0.85, 1e-8
#: two runs each stopped with a step below `_PR_TOL` lie within
#: d / (1 - d) * tol of their map's fixpoint, so within twice that
_PR_STOP = 2 * _PR_D / (1 - _PR_D) * _PR_TOL


def _pagerank_both(kind, fmt, max_iters):
    """Each package's PageRank driver on the graph cell's inputs (its
    matrix, the seeded restart vector), `max_iters` at most."""
    from repro.graph import DRIVERS as R_DRIVERS

    base = rsw._matrix(kind, 256, seed=0)
    r0 = np.random.default_rng(0).uniform(
        0.5, 1.5, size=base.n_rows).astype(np.float32)
    ref = R_DRIVERS["pagerank"](base, r0=r0, max_iters=max_iters,
                                format=fmt)
    port = tsw.run_graph_analytic(kind, 8, "pagerank", max_iters=max_iters,
                                  format=fmt, device="cpu")
    return ref, port


def _pagerank_l1_bound(op) -> float:
    """L1 distance that float32 rounding allows between two PageRank
    runs of the same iteration count from the same r0, whatever the
    order of their sums: each normalises r0 (a sum of n terms, error
    <= gamma_n), and each step's SpMV rows of at most m terms and its
    scale, teleport and dangling terms add <= (gamma_(m+1) + 4u) ||r||_1
    (the operator is column-stochastic), which the damped map contracts
    by d a step, so each run is within gamma_n + (gamma_(m+1) + 4u) /
    (1 - d) of exact arithmetic, and the two within twice that."""
    u = float(np.finfo(np.float32).eps) / 2

    def gamma(k):
        return k * u / (1 - k * u)

    m = int(np.diff(np.asarray(op.indptr)).max())
    return 2 * (gamma(op.n_rows) + (gamma(m + 1) + 4 * u) / (1 - _PR_D))


def test_decode_inverts_encode():
    points = (tsw.run_sweep(log2ns=(8,), mechanisms={"miss-cache": TSpec(
                  miss_entries=64)}, device="cpu")
              + tsw.scaling_sweep(log2ns=(8,), threads_list=(2,),
                                  device="cpu")
              + tsw.graph_sweep(log2ns=(8,), kinds=("rmat",),
                                analytics=("bfs",), device="cpu")
              + [tcm.run_label_cell("fd", 8, "none", 1, device="cpu")])
    for p in points:
        blob = trun.encode_point(p)
        q = trun.decode_point(blob)
        assert type(q) is type(p) and trun.encode_point(q) == blob
        if not isinstance(p, tsw.SweepPoint):    # counters compare by value
            assert q == p


@pytest.mark.parametrize("analytic", ["bfs", "sssp", "pagerank"])
def test_iteration_counters_match(analytic):
    from repro import plan as rplan
    from repro.core.generators import fd_matrix as r_fd
    from repro.graph import drivers as rdrv
    from repro_torch import plan as tplan
    from repro_torch.graph import drivers as tdrv

    rm, rsr, _ = rdrv.analytic_operand(analytic, r_fd(256))
    tm, tsr, _ = tdrv.analytic_operand(analytic, fd_matrix(256,
                                                           device="cpu"))
    rp = rplan.compile(rm, **rdrv.plan_options(rsr))
    tp = tplan.compile(tm, device="cpu", **{
        k: v for k, v in tdrv.plan_options(tsr).items() if k != "interpret"})
    spec = (RSpec(**GRAPH_SPEC), TSpec(**GRAPH_SPEC))
    a = rgt.iteration_counters(rp, 3, spec=spec[0])
    b = tgt.iteration_counters(tp, 3, spec=spec[1])
    assert [c.as_dict() for c in b] == [c.as_dict() for c in a]
    assert tgt.iteration_bounds(tp, 3, spec=spec[1]) == \
        rgt.iteration_bounds(rp, 3, spec=spec[0])
    assert [s.as_dict() for s in tgt.iteration_summaries(tp, 2)] == \
        [s.as_dict() for s in rgt.iteration_summaries(rp, 2)]


def _scaling_grid():
    cells = trun.scaling_cells((8,), ("fd", "rmat"), threads_list=(1, 2, 4),
                               partition="balanced")
    cfg = trun.SweepConfig(device="cpu")
    return cells, cfg


def test_workers_give_the_serial_bytes():
    cells, cfg = _scaling_grid()
    info = {}
    serial = trun.execute_cells(cells, cfg)
    sharded = trun.execute_cells(cells, cfg, workers=2, cell_info=info)
    assert _blobs(trun.encode_point, sharded) == \
        _blobs(trun.encode_point, serial)
    with trun.shared_workers(2) as pool:          # one pool, two grids
        again = [trun.execute_cells(cells, cfg, workers=2)
                 for _ in range(2)]
        assert trun._SHARED["pool"] == (2, pool)
    assert "pool" not in trun._SHARED
    assert all(_blobs(trun.encode_point, a) == _blobs(trun.encode_point,
                                                      serial) for a in again)
    assert sorted(info) == sorted(c.key() for c in cells)
    assert all(v["launches"]["spmv_ell"] == 0 and v["seconds"] > 0
               for v in info.values())


def test_graph_cells_report_driver_and_replay_seconds():
    """A graph cell's info splits its seconds into the driver's and the
    replay's; the point is `run_graph_cell`'s."""
    cells = trun.graph_cells((8,), ("fd",), ("bfs",))
    info = {}
    (pt,) = trun.execute_cells(cells, trun.SweepConfig(device="cpu"),
                               cell_info=info)
    (stages,) = info.values()
    assert 0 < stages["driver_s"] + stages["replay_s"] <= stages["seconds"]
    assert trun.encode_point(pt) == trun.encode_point(
        tsw.run_graph_cell("fd", 8, "bfs", device="cpu"))


def test_interrupted_and_resumed_equals_uninterrupted(tmp_path):
    cells, cfg = _scaling_grid()
    whole = trun.execute_cells(cells, cfg)
    d = str(tmp_path / "ck")
    part = trun.execute_cells(cells, cfg, ckpt_dir=d, max_cells=2,
                              checkpoint_every=1)
    assert len(part) == 2
    info = {}
    rest = trun.execute_cells(cells, cfg, ckpt_dir=d, workers=2,
                              cell_info=info)
    assert len(info) == len(cells) - 2
    assert _blobs(trun.encode_point, rest) == _blobs(trun.encode_point,
                                                     whole)
    steps = sorted(os.listdir(d))
    assert len(steps) <= 2                          # keep=2


def test_runner_checkpoints_cross_both_ways(tmp_path, monkeypatch):
    """A reference runner checkpoint (zlib, the codec the port reads)
    resumes in the port with nothing left to run, and the port's in the
    reference."""
    monkeypatch.setattr(rrun, "_manager",
                        lambda d: RefManager(d, keep=2, codec="zlib"))
    rcells = rrun.scaling_cells((8,), ("fd", "rmat"), threads_list=(1, 2),
                                partition="balanced")
    tcells = trun.scaling_cells((8,), ("fd", "rmat"), threads_list=(1, 2),
                                partition="balanced")
    cfg = trun.SweepConfig(device="cpu")
    d = str(tmp_path / "ref")
    ref = rrun.execute_cells(rcells, rrun.SweepConfig(), ckpt_dir=d)
    info = {}
    port = trun.execute_cells(tcells, cfg, ckpt_dir=d, cell_info=info)
    assert info == {}
    assert _blobs(trun.encode_point, port) == _blobs(rrun.encode_point, ref)
    d = str(tmp_path / "port")
    trun.execute_cells(tcells, cfg, ckpt_dir=d)
    calls = []
    monkeypatch.setattr(rrun, "run_cell", lambda *a: calls.append(a))
    back = rrun.execute_cells(rcells, rrun.SweepConfig(), ckpt_dir=d)
    assert calls == []
    assert _blobs(rrun.encode_point, back) == _blobs(rrun.encode_point, ref)


def _cli_lines(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("sweep,extra", [
    ("scaling", ["--threads", "1,2", "--scaled"]),
    ("mech", ["--threads", "1", "--mechanisms", "baseline,combined"]),
    ("graph", ["--analytics", "bfs,sssp"])])
def test_runner_cli_prints_the_references_lines(sweep, extra, tmp_path,
                                                capsys, monkeypatch):
    monkeypatch.setattr(rrun, "_manager",
                        lambda d: RefManager(d, keep=2, codec="zlib"))
    base = ["--sweep", sweep, "--log2ns", "8"] + extra
    out = {}
    for name, main, dev in (("ref", rrun.main, []),
                            ("port", trun.main, ["--device", "cpu"])):
        d = str(tmp_path / name)
        first = _cli_lines(main, base + dev + ["--ckpt", d, "--max-cells",
                                               "1"], capsys)
        rest = _cli_lines(main, base + dev + ["--ckpt", d, "--csv",
                                              "--verify"], capsys)
        out[name] = [line.replace(d, "CKPT") for line in first + rest]
    assert out["port"] == out["ref"]
    assert out["port"][0] == (f"[runner] {sweep} sweep: 1/4 cells complete "
                              "(workers=1, ckpt=CKPT)")
    assert out["port"][-1].startswith("[runner] verify OK")


def test_costmodel_cli_harvests_fits_and_evaluates_like_the_reference(
        tmp_path, capsys):
    grid = ["--kinds", "fd,rmat", "--log2ns", "8", "--threads", "1,2",
            "--seeds", "0"]
    out = {}
    for name, main, dev in (("ref", rcm.main, []),
                            ("port", tcm.main, ["--device", "cpu"])):
        corpus, model = str(tmp_path / f"{name}.json"), str(tmp_path / name)
        lines = _cli_lines(main, ["--harvest", "--corpus", corpus] + grid
                           + dev, capsys)
        lines += _cli_lines(main, ["--fit", "--eval", "--corpus", corpus,
                                   "--out", model, "--model", model], capsys)
        out[name] = [line.replace(tmp_path.as_posix(), "DIR")
                     .replace(f"/{name}", "/X") for line in lines]
        with open(corpus) as f:
            out[name + " corpus"] = f.read()
    assert out["port"] == out["ref"] and out["port corpus"] == \
        out["ref corpus"]
    assert any("harvested 16 rows" in line for line in out["port"])


def test_balanced_partition_of_a_cell_is_the_references():
    """The scaling phase's 'balanced' partition, the same row starts."""
    from repro.core.generators import rmat_matrix as r_rmat
    from repro_torch.core.partition import rowblock_balanced

    for t in (1, 2, 4, 8):
        assert np.array_equal(
            rowblock_balanced(rmat_matrix(4096, device="cpu"), t).starts,
            r_balanced(r_rmat(4096), t).starts)


def test_sweep_cells_and_keys_are_the_references():
    pairs = [
        (trun.mech_cells((12, 14), ("fd", "rmat"), tsw.MECHANISMS,
                         threads_list=(1, 2)),
         rrun.mech_cells((12, 14), ("fd", "rmat"), rsw.MECHANISMS,
                         threads_list=(1, 2))),
        (trun.scaling_cells((12,), ("fd", "rmat"), (1, 2, 4, 8), "balanced"),
         rrun.scaling_cells((12,), ("fd", "rmat"), (1, 2, 4, 8), "balanced")),
        (trun.graph_cells((12,), ("fd", "rmat"), ANALYTICS, format="csr"),
         rrun.graph_cells((12,), ("fd", "rmat"), ANALYTICS, format="csr"))]
    for port, ref in pairs:
        assert [c.key() for c in port] == [c.key() for c in ref]
        assert [dataclasses.astuple(c) for c in port] == \
            [dataclasses.astuple(c) for c in ref]
    assert tsw.MECHANISMS == {k: TSpec(**dataclasses.asdict(v))
                              for k, v in rsw.MECHANISMS.items()}
