"""Port vs reference: streaming graphs -- edge deltas, fingerprints,
the plan cache's lifecycle counters, overlaid plans and warm starts.

The same numpy inputs go through `repro` (the JAX reference, Pallas in
interpret mode on the CPU) and `repro_torch` on device="cpu", at the
reference tests' size (N = 64) and at 2^10.  Delta arrays, digests, cache
keys and counters must be identical; overlaid plans equal the reference's
answer and a fresh compile of their materialised matrix bit for bit on
integer-valued operands under plus_times and exactly under the other
semirings (±inf included).  Overlay cases stay off the FD sizes whose
generator emits duplicate coordinates (ROADMAP C1); the refusal itself
is pinned at n = 22 and 37.
"""
import importlib

import numpy as np
import pytest
import torch
from _torch_parity import (SEMIRING_NAMES, coo_of, fresh_coords,
                           int_operands, port_csr, same_csr)

import jax.numpy as jnp
from repro import plan as rplan
from repro.core import delta as rdelta
from repro.core import generators as rg
from repro.graph import drivers as rdrv
from repro_torch import plan as tplan
from repro_torch.core import delta as tdelta
from repro_torch.core import generators as tg
from repro_torch.graph import drivers as tdrv

# the modules, not the `overlay` functions the packages export
roverlay = importlib.import_module("repro.plan.overlay")
toverlay = importlib.import_module("repro_torch.plan.overlay")
SIZES = (64, 1 << 10)
OPTS = dict(reorder="none", predictor="none")


def _pair(n, seed=3):
    ref = rg.rmat_matrix(n, seed=seed)
    return ref, port_csr(ref)


def _same_delta(a, b) -> bool:
    """Byte-identical arrays (dtypes included) and equal shapes."""
    return a.shape == b.shape and all(
        getattr(a, f).dtype == getattr(b, f).dtype
        and getattr(a, f).tobytes() == getattr(b, f).tobytes()
        for f in ("rows", "cols", "vals", "deletes"))


def _updates(ref, case, seed=0):
    """(inserts, deletes) of one kind of batch against `ref`."""
    rng = np.random.default_rng(seed)
    rows, cols, _ = coo_of(ref)
    picks = rng.choice(rows.size, size=4, replace=False)
    dels = [(int(rows[p]), int(cols[p])) for p in picks]
    ins = [(r, c, float(rng.integers(1, 9)))
           for r, c in fresh_coords(ref, 5, rng)]
    return {"inserts": (ins, []), "deletes": ([], dels),
            "mixed": (ins, dels),
            "value_change": ([(r, c, 9.0) for r, c in dels[:2]], dels[:2]),
            "empty": ([], [])}[case]


def _both(fn_ref, fn_port):
    """Run both; return (result or None, error message or None) each."""
    out = []
    for fn in (fn_ref, fn_port):
        try:
            out.append((fn(), None))
        except ValueError as e:
            out.append((None, str(e)))
    return out


# ---------------------------------------------------------------------------
# EdgeDelta semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", ["inserts", "deletes", "mixed",
                                  "value_change", "empty"])
def test_edge_delta_matches_reference(n, case):
    """`from_updates`: identical arrays, views and summary; then
    `apply_delta` gives the reference's CSR byte for byte, with deleted
    coordinates gone structurally."""
    ref, port = _pair(n)
    ins, dels = _updates(ref, case)
    a = rdelta.EdgeDelta.from_updates(ref, inserts=ins, deletes=dels)
    b = tdelta.EdgeDelta.from_updates(port, inserts=ins, deletes=dels)
    assert _same_delta(a, b)
    assert (b.nnz, b.n_inserts, b.n_deletes, b.has_deletes, b.summary()) \
        == (a.nnz, a.n_inserts, a.n_deletes, a.has_deletes, a.summary())
    for x, y in zip(a.signed_coo(), b.signed_coo()):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(a.column_order(), b.column_order())
    (ia, ea), (ib, eb) = _both(a.insert_coo, b.insert_coo)
    assert ea == eb
    if ia is not None:
        assert all(np.array_equal(x, y) for x, y in zip(ia, ib))
    got = port.apply_delta(b)
    assert same_csr(ref.apply_delta(a), got)
    assert same_csr(ref.apply_delta(a), tdelta.apply_delta(port, b))
    assert got.device == port.device
    present = set(zip(*[c.tolist() for c in coo_of(got)[:2]]))
    assert not any((r, c) in present for r, c in dels
                   if (r, c) not in {(i[0], i[1]) for i in ins})


@pytest.mark.parametrize("n", SIZES)
def test_csr_diff_round_trip_and_merge(n):
    """`csr_diff` gives the reference's delta and reproduces the new
    matrix; merged deltas equal sequential application and the
    reference's merge, array for array."""
    ref_a, port_a = _pair(n, seed=5)
    rng = np.random.default_rng(1)
    ins1 = [(r, c, 2.0) for r, c in fresh_coords(ref_a, 4, rng)]
    d1 = (rdelta.EdgeDelta.from_updates(ref_a, inserts=ins1),
          tdelta.EdgeDelta.from_updates(port_a, inserts=ins1))
    ref_b, port_b = ref_a.apply_delta(d1[0]), port_a.apply_delta(d1[1])
    rows, cols, _ = coo_of(ref_b)
    ins2 = [(r, c, 5.0) for r, c in fresh_coords(ref_b, 3, rng)]
    dels2 = [(int(rows[0]), int(cols[0]))]
    d2 = (rdelta.EdgeDelta.from_updates(ref_b, inserts=ins2, deletes=dels2),
          tdelta.EdgeDelta.from_updates(port_b, inserts=ins2,
                                        deletes=dels2))
    assert _same_delta(*d1) and _same_delta(*d2)
    ref_c, port_c = ref_b.apply_delta(d2[0]), port_b.apply_delta(d2[1])
    assert same_csr(ref_c, port_c)
    diff = tdelta.csr_diff(port_a, port_c)
    assert _same_delta(rdelta.csr_diff(ref_a, ref_c), diff)
    assert same_csr(ref_c, port_a.apply_delta(diff))
    merged = d1[1].merge(d2[1])
    assert _same_delta(d1[0].merge(d2[0]), merged)
    assert same_csr(ref_c, port_a.apply_delta(merged))


def _random_delta(cls, n, k, seed):
    """A canonical delta of `k` random coordinates of an n x n matrix,
    each a delete, an insert or both (not checked against any base):
    what `merge` folds."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(n * n, size=k, replace=False)
    rows, cols, vals, dels = [], [], [], []
    for key, kind in zip(keys, rng.integers(0, 3, k)):
        for is_del in (True, False):
            if kind == 2 or kind == int(not is_del):
                rows.append(key // n)
                cols.append(key % n)
                vals.append(float(rng.integers(1, 9)))
                dels.append(is_del)
    return cls._build(rows, cols, vals, dels, n, n)


@pytest.mark.parametrize("chunk", range(4))
def test_merge_matches_reference_entry_for_entry(chunk):
    """The vectorised merge against the reference's entry-by-entry fold
    on 400 random pairs of small deltas: the same arrays, or the same
    error message for the same first offending entry."""
    rng = np.random.default_rng(chunk)
    outcomes = set()
    for _ in range(400):
        n = int(rng.integers(2, 8))
        k1, k2 = (int(rng.integers(0, min(n * n, 10))) for _ in range(2))
        seed = int(rng.integers(1 << 30))
        a = [_random_delta(c, n, k1, seed) for c in
             (rdelta.EdgeDelta, tdelta.EdgeDelta)]
        b = [_random_delta(c, n, k2, seed + 1) for c in
             (rdelta.EdgeDelta, tdelta.EdgeDelta)]
        (ma, ea), (mb, eb) = _both(lambda: a[0].merge(b[0]),
                                   lambda: a[1].merge(b[1]))
        assert ea == eb
        if ma is not None:
            assert _same_delta(ma, mb)
        outcomes.add(ea.split(" without")[0].split(")")[-1].strip()
                     if ea else "merged")
    assert outcomes == {"merged", "deleted twice", "inserted twice"}


def test_delta_errors_match_reference():
    """Every refusal of the delta API, with the reference's message."""
    ref, port = _pair(64)
    rows, cols, _ = coo_of(ref)
    r0, c0 = int(rows[0]), int(cols[0])
    (ra, ca), = fresh_coords(ref, 1, np.random.default_rng(2))
    other = rg.rmat_matrix(32, seed=1)
    t_other = port_csr(other)
    cases = [
        (lambda m, D: D.EdgeDelta.from_updates(m, inserts=[(r0, c0, 1.0)])),
        (lambda m, D: D.EdgeDelta.from_updates(m, deletes=[(ra, ca)])),
        (lambda m, D: D.EdgeDelta._build([0, 0], [1, 1], [1, 1],
                                         [False, False], 4, 4)),
        (lambda m, D: D.EdgeDelta._build([5], [1], [1], [False], 4, 4)),
        (lambda m, D: D.EdgeDelta._build([0], [1, 2], [1], [False], 4, 4)),
        (lambda m, D: D.EdgeDelta.from_updates(
            m, deletes=[(r0, c0)]).insert_coo()),
        (lambda m, D: D.EdgeDelta.empty(4, 4).merge(D.EdgeDelta.empty(4, 5))),
        (lambda m, D: D.csr_diff(m, other if D is rdelta else t_other)),
        (lambda m, D: D.apply_delta(m, D.EdgeDelta.empty(3, 3))),
        (lambda m, D: D.apply_delta(m, D.EdgeDelta._build(
            [ra], [ca], [1.0], [True], m.n_rows, m.n_cols))),
        (lambda m, D: D.apply_delta(m, D.EdgeDelta._build(
            [r0], [c0], [1.0], [False], m.n_rows, m.n_cols))),
    ]
    for i, case in enumerate(cases):
        with pytest.raises(ValueError) as want:
            case(ref, rdelta)
        with pytest.raises(ValueError) as got:
            case(port, tdelta)
        assert str(got.value) == str(want.value), i


@pytest.mark.parametrize("n", [22, 37])
def test_duplicate_fd_coordinates_are_refused_like_the_reference(n):
    """C1: the reference's `fd_matrix(22)` (and 37) emits duplicate
    coordinates; the port's generator reproduces them, and the port's
    delta API refuses the matrix as the reference does -- even for an
    empty batch."""
    ref = rg.fd_matrix(n, seed=0)
    port = tg.fd_matrix(n, seed=0, device="cpu")
    assert same_csr(ref, port)
    for fn in (lambda m, D: D.EdgeDelta.from_updates(m),
               lambda m, D: D.csr_diff(m, m),
               lambda m, D: D.apply_delta(m, D.EdgeDelta.empty(n, n)),
               lambda m, D: D.csr_lookup(m, [0], [0])):
        with pytest.raises(ValueError) as want:
            fn(ref, rdelta)
        with pytest.raises(ValueError) as got:
            fn(port, tdelta)
        assert str(got.value) == str(want.value)
        assert "duplicate-free" in str(got.value)


# ---------------------------------------------------------------------------
# fingerprints, cache keys, counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_delta_and_chained_fingerprints_match_reference(n):
    ref, port = _pair(n, seed=9)
    rng = np.random.default_rng(3)
    ins1 = [(r, c, 1.0) for r, c in fresh_coords(ref, 2, rng)]
    ins2 = [(r, c, 1.0) for r, c in fresh_coords(
        ref, 2, rng, avoid=[(r, c) for r, c, _ in ins1])]
    ds = [(rdelta.EdgeDelta.from_updates(ref, inserts=i),
           tdelta.EdgeDelta.from_updates(port, inserts=i))
          for i in (ins1, ins2)]
    base = rplan.matrix_fingerprint(ref)
    assert tplan.matrix_fingerprint(port) == base
    fps = []
    for a, b in ds:
        assert tplan.delta_fingerprint(b) == rplan.delta_fingerprint(a)
        fps.append(tplan.chain_fingerprint(base, tplan.delta_fingerprint(b)))
        assert fps[-1] == rplan.chain_fingerprint(
            base, rplan.delta_fingerprint(a))
    f11 = tplan.chain_fingerprint(fps[0], tplan.delta_fingerprint(ds[1][1]))
    assert len({base, *fps, f11}) == 4              # generations differ
    # memoised per delta object: an equal delta hashes to the same digest
    again = tdelta.EdgeDelta.from_updates(port, inserts=ins1)
    assert tplan.delta_fingerprint(again) == tplan.delta_fingerprint(
        ds[0][1])
    # keys: the drivers' options, then chained under the same salt
    for sr in SEMIRING_NAMES[:3]:
        opts = rdrv.plan_options(sr)
        assert tdrv.plan_options(sr) == opts
        key = tplan.PlanCache.key_for(port, **opts)
        assert key == rplan.PlanCache.key_for(ref, **opts)
        assert tplan.PlanCache.chained_key(key, fps[0]) == \
            rplan.PlanCache.chained_key(key, fps[0])


def _counter_trace(P, D, adj, compile_kw):
    """The reference test's install / swap / recompile sequence on one
    package; returns the probes and counter snapshots along the way."""
    cache = P.PlanCache(max_plans=8)
    p = cache.get_or_compile(adj, **OPTS, **compile_kw)
    key = cache.key_for(adj, **OPTS, **compile_kw)
    rng = np.random.default_rng(4)
    d = D.EdgeDelta.from_updates(
        adj, inserts=[(r, c, 1.0) for r, c in fresh_coords(adj, 2, rng)])
    ov = P.overlay(p, d)
    new_key = cache.chained_key(key, ov.fingerprint)
    out = [new_key != key, new_key.endswith(key.split("|", 1)[1])]
    cache.install_overlay(new_key, ov, supersedes=key)
    out += [cache.peek(new_key) is ov, cache.peek(key) is None,
            cache.contains(new_key)]
    snaps = [cache.stats()]
    mat = adj.apply_delta(d)
    swap_key = cache.key_for(mat, **OPTS, **compile_kw)
    swapped = cache.swap(swap_key, lambda: P.compile(
        mat, **OPTS, **compile_kw), supersedes=new_key)
    out += [cache.peek(new_key) is None, cache.peek(swap_key) is swapped]
    cache.note_delta_recompile()
    snaps.append(cache.stats())
    out.append(cache.invalidate(mat))                 # by container
    out.append(cache.invalidate(swap_key.split("|")[0]))
    cache.clear()
    snaps.append(cache.stats())
    keep = ("plans", "hits", "misses", "evictions", "compiles",
            "predictor_compiles", "oracle_compiles", "overlays",
            "swaps", "delta_recompiles", "hit_rate")
    return out, [{k: s[k] for k in keep} for s in snaps]


def test_plan_cache_lifecycle_counters_match_reference():
    ref, port = _pair(64, seed=11)
    a = _counter_trace(rplan, rdelta, ref, {})
    b = _counter_trace(tplan, tdelta, port, {"device": "cpu"})
    assert a == b
    assert b[0][:7] == [True] * 7
    assert b[1][1]["overlays"] == b[1][1]["swaps"] == \
        b[1][1]["delta_recompiles"] == 1
    assert b[1][2]["overlays"] == b[1][2]["swaps"] == 0


def test_invalidate_after_in_place_mutation():
    """Mutating a container in place is outside content addressing; the
    memoised digest would keep serving the stale plan, and `invalidate`
    with the container drops the plans under both digests."""
    _, port = _pair(64)
    cache = tplan.PlanCache()
    cache.get_or_compile(port, **OPTS, device="cpu")
    stale = tplan.matrix_fingerprint(port)
    port.data[0] += 1.0
    assert tplan.matrix_fingerprint(port) == stale        # memoised
    assert cache.invalidate(port) == 1 and len(cache) == 0
    assert tplan.forget_fingerprint(port) is not None     # re-memoised
    assert tplan.matrix_fingerprint(port) != stale
    assert tplan.forget_fingerprint(object()) is None


# ---------------------------------------------------------------------------
# overlaid plans
# ---------------------------------------------------------------------------

def _int_delta(D, csr, seed, sr_name, n_ins=6, n_del=4):
    """Integer-valued inserts (in the semiring's domain) and, under
    plus_times, deletes: the reference property suite's scheme."""
    rng = np.random.default_rng(seed)
    lo, hi = {"or_and": (1, 1), "max_times": (1, 8)}.get(sr_name, (1, 8))
    ins = [(r, c, float(rng.integers(lo, hi + 1)))
           for r, c in fresh_coords(csr, n_ins, rng)]
    dels = []
    rows, cols, _ = coo_of(csr)
    if sr_name == "plus_times" and rows.size:
        picks = rng.choice(rows.size, size=min(n_del, rows.size),
                           replace=False)
        dels = [(int(rows[p]), int(cols[p])) for p in picks]
    return D.EdgeDelta.from_updates(csr, inserts=ins, deletes=dels)


def _x(sr_name, x, seed):
    """The parity module's integer x; under min_plus a few entries are
    +inf, so ±inf has to come out right."""
    x = np.array(x, dtype=np.float32)
    if sr_name == "min_plus":
        x[np.random.default_rng(seed).choice(x.size, 3, replace=False)] = \
            np.inf
    return x


OVERLAY_CASES = [(fam, n, sr, fmt, reorder)
                 for fam in ("fd", "rmat") for n in SIZES
                 for sr in SEMIRING_NAMES for fmt in ("csr", "hyb")
                 for reorder in (("none", "rcm") if n == 64 else ("none",))]


@pytest.mark.parametrize("family,n,sr_name,fmt,reorder", OVERLAY_CASES)
def test_overlaid_plan_matches_reference_and_materialization(
        family, n, sr_name, fmt, reorder):
    """`OverlaidPlan.execute` equals the reference's overlay and a fresh
    compile of `materialize()`, exactly; `execute_many` rows equal
    `execute`, and two calls are bit-identical."""
    ref_m, x = int_operands(family, n, 7, sr_name)
    x = _x(sr_name, x, 7)
    port_m = port_csr(ref_m)
    kw = dict(format=fmt, reorder=reorder, predictor="none",
              semiring=sr_name)
    rd = _int_delta(rdelta, ref_m, 8, sr_name)
    td = _int_delta(tdelta, port_m, 8, sr_name)
    assert _same_delta(rd, td)
    r_ov = roverlay.overlay(rplan.compile(ref_m, **kw), rd,
                            staleness_budget=1.0)
    t_ov = toverlay.overlay(tplan.compile(port_m, device="cpu", **kw), td,
                            staleness_budget=1.0)
    assert t_ov.fingerprint == r_ov.fingerprint
    want = np.asarray(r_ov.execute(jnp.asarray(x), interpret=True))
    got = t_ov.execute(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)
    fresh = tplan.compile(t_ov.materialize(), device="cpu", **kw)
    assert same_csr(r_ov.materialize(), t_ov.materialize())
    assert torch.equal(fresh.execute(torch.from_numpy(x)), got)
    X = torch.from_numpy(np.stack([x, np.roll(x, 1), x[::-1].copy()]))
    Y = t_ov.execute_many(X)
    assert torch.equal(t_ov.execute_many(X), Y)
    assert all(torch.equal(t_ov.execute(X[i]), Y[i]) for i in range(3))


def test_overlay_on_a_plain_oracle_plan():
    """`use_pallas=False` plans overlay the same way."""
    ref_m, x = int_operands("rmat", 64, 3, "plus_times")
    port_m = port_csr(ref_m)
    d = _int_delta(tdelta, port_m, 4, "plus_times")
    ov = toverlay.overlay(tplan.compile(port_m, device="cpu",
                                        use_pallas=False), d)
    fresh = tplan.compile(ov.materialize(), device="cpu")
    xt = torch.from_numpy(x)
    assert torch.equal(ov.execute(xt), fresh.execute(xt))
    X = torch.stack([xt, -xt])
    assert torch.equal(ov.execute_many(X)[1], ov.execute(-xt))


def test_overlay_lifecycle_flags_and_chaining_match_reference():
    ref, port = _pair(64, seed=13)
    rp = rplan.compile(ref, **OPTS)
    tp = tplan.compile(port, device="cpu", **OPTS)
    rng = np.random.default_rng(5)
    small = [(r, c, 1.0) for r, c in fresh_coords(ref, 1, rng)]
    big = [(r, c, 1.0) for r, c in fresh_coords(
        ref, int(0.1 * ref.nnz), rng, avoid=[s[:2] for s in small])]
    rows, cols, _ = coo_of(ref)
    dels = [(int(rows[0]), int(cols[0]))]
    views = []
    for P, D, m, p in ((roverlay, rdelta, ref, rp),
                       (toverlay, tdelta, port, tp)):
        ds, db = (D.EdgeDelta.from_updates(m, inserts=i)
                  for i in (small, big))
        dd = D.EdgeDelta.from_updates(m, deletes=dels)
        ov = P.overlay(p, ds, staleness_budget=0.05)
        chained = P.overlay(ov, D.EdgeDelta.from_updates(
            m.apply_delta(ds), deletes=dels))
        views.append((
            ov.eligible, ov.stale, ov.staleness, ov.summary(),
            P.overlay(p, db, staleness_budget=0.05).stale,
            P.overlay_eligible(dd, "plus_times"),
            P.overlay_eligible(dd, "min_plus"),
            chained.fingerprint, chained.delta.nnz, chained.summary(),
            P.DEFAULT_STALENESS_BUDGET))
    assert views[0] == views[1]
    assert views[1][:2] == (True, False) and views[1][4]
    assert views[1][2] == pytest.approx(1 / ref.nnz)


def test_overlay_refusals():
    ref_m, x = int_operands("rmat", 64, 3, "min_plus")
    port_m = port_csr(ref_m)
    rows, cols, _ = coo_of(port_m)
    p = tplan.compile(port_m, device="cpu", semiring="min_plus", **OPTS)
    dels = tdelta.EdgeDelta.from_updates(port_m,
                                         deletes=[(rows[0], cols[0])])
    ov = toverlay.overlay(p, dels)
    assert not ov.eligible and ov.stale
    with pytest.raises(ValueError, match="overlay-ineligible"):
        ov.execute(torch.from_numpy(x))
    with pytest.raises(ValueError, match="does not match"):
        toverlay.overlay(p, tdelta.EdgeDelta.empty(3, 3))
    bare = tplan.compile(port_m, device="cpu", keep_csr=False, **OPTS)
    with pytest.raises(ValueError, match="keep_csr=False"):
        toverlay.overlay(bare, tdelta.EdgeDelta.empty(64, 64))
    empty = toverlay.overlay(p, tdelta.EdgeDelta.empty(64, 64))
    xt = torch.from_numpy(x)
    assert torch.equal(empty.execute(xt), p.execute(xt))
    assert empty.fingerprint != p.fingerprint


def test_overlay_under_a_reordered_plan_keeps_the_original_order():
    """A plan compiled with RCM overlays deltas in original coordinates:
    its base matrix is the kept CSR un-permuted."""
    ref_m, x = int_operands("rmat", 64, 5, "plus_times")
    port_m = port_csr(ref_m)
    p = tplan.compile(port_m, device="cpu", reorder="rcm",
                      predictor="none")
    ov = toverlay.overlay(p, _int_delta(tdelta, port_m, 6, "plus_times"))
    assert same_csr(ref_m, ov.base_matrix)
    assert ov.reordering is p.reordering and ov.device == p.device
    xt = torch.from_numpy(x)
    assert torch.equal(ov.execute(xt), tplan.compile(
        ov.materialize(), device="cpu", **OPTS).execute(xt))


@pytest.mark.parametrize("fmt,reorder", [("csr", "none"), ("hyb", "none"),
                                          ("csr", "rcm")])
def test_overlay_address_trace_extends_base(fmt, reorder):
    """Counterpart of tests/test_streaming.py's case of the same name:
    the overlaid trace is the base plan's, then the column-sorted delta
    pass (ascending x gathers); an empty delta leaves the base trace.
    Both traces equal the reference's, under a reordered plan too."""
    from repro.core.cache_model import SANDY_BRIDGE as R_SB
    from repro_torch.core.cache_model import SANDY_BRIDGE as T_SB

    ref, port = _pair(128, seed=3)
    kw = dict(format=fmt, reorder=reorder, predictor="none")
    traces = []
    for P, D, m, dev, sb in ((rplan, rdelta, ref, {}, R_SB),
                             (tplan, tdelta, port, {"device": "cpu"}, T_SB)):
        p = P.compile(m, **kw, **dev)
        rng = np.random.default_rng(9)
        d = D.EdgeDelta.from_updates(m, inserts=[
            (r, c, 1.0) for r, c in fresh_coords(m, 6, rng)])
        ov = roverlay.overlay(p, d) if P is rplan else toverlay.overlay(p, d)
        empty = (roverlay if P is rplan else toverlay).overlay(
            p, D.EdgeDelta.empty(m.n_rows, m.n_cols))
        traces.append((p.address_trace(sb), ov.address_trace(sb),
                       empty.address_trace(sb), d.nnz))
    (rb, rov, _, _), (tb, tov, tempty, k) = traces
    assert np.array_equal(tb, rb) and np.array_equal(tov, rov)
    assert np.array_equal(tov[:len(tb)], tb) and len(tov) > len(tb)
    xg = tov[len(tb):len(tb) + 4 * k][3::4]
    assert np.all(np.diff(xg) >= 0)
    assert np.array_equal(tempty, tb)


def test_plan_cache_report_renders_pre_streaming_stats():
    """Counterpart of tests/test_streaming.py's case of the same name,
    through both packages' `plan_cache_report`: the texts are equal."""
    from repro.telemetry.report import plan_cache_report as ref_report
    from repro_torch.telemetry.report import plan_cache_report

    legacy = {"plans": 2, "hits": 5, "misses": 3, "evictions": 0,
              "compiles": 3, "compile_s": 0.1}       # no streaming counters
    out = plan_cache_report(legacy)
    assert "overlays" in out and "KeyError" not in out
    assert out == ref_report(legacy)
    # windowed diff against a pre-streaming snapshot also renders
    now = dict(legacy, overlays=2, swaps=1, delta_recompiles=1, hits=9)
    out2 = plan_cache_report(now, before=legacy)
    assert out2.splitlines()[-1].split(",")[-3:] == ["2", "1", "1"]
    assert out2 == ref_report(now, before=legacy)


# ---------------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------------

def test_warm_start_policy_matches_reference():
    ref, port = _pair(64)
    rows, cols, _ = coo_of(ref)
    rng = np.random.default_rng(6)
    ins = [(r, c, 1.0) for r, c in fresh_coords(ref, 2, rng)]
    dels = [(int(rows[0]), int(cols[0]))]
    v = np.arange(64, dtype=np.float64)
    assert tdrv.WARM_START_PARAM == rdrv.WARM_START_PARAM
    for analytic in rdrv.ANALYTICS:
        for kw in ({"inserts": ins}, {"deletes": dels}, None):
            a = rdrv.warm_start_params(analytic, v, None if kw is None else
                                       rdelta.EdgeDelta.from_updates(ref,
                                                                     **kw))
            b = tdrv.warm_start_params(analytic, v, None if kw is None else
                                       tdelta.EdgeDelta.from_updates(port,
                                                                     **kw))
            assert (a is None) == (b is None)
            if a is not None:
                (ka, va), = a.items()
                (kb, vb), = b.items()
                assert ka == kb and vb.dtype == va.dtype and \
                    np.array_equal(va, vb)


def _mutated(n, seed, k):
    ref, port = _pair(n, seed=seed)
    ins = [(r, c, 1.0) for r, c in fresh_coords(
        ref, k, np.random.default_rng(seed))]
    return (ref, ref.apply_delta(rdelta.EdgeDelta.from_updates(
        ref, inserts=ins))), (port, port.apply_delta(
            tdelta.EdgeDelta.from_updates(port, inserts=ins)))


@pytest.mark.parametrize("n", [128, 1 << 10])
def test_warm_started_monotone_analytics_match_reference(n):
    """Insert-only deltas: warm-started SSSP and CC equal the cold answer
    on the mutated graph, in no more iterations, as the reference's."""
    (r_pre, r_mut), (t_pre, t_mut) = _mutated(n, 21, 4)
    src = int(np.argmax(t_pre.row_lengths()))
    d0 = tdrv.sssp(t_pre, src, device="cpu").values.reshape(1, -1)
    l0 = tdrv.connected_components(t_pre, device="cpu").values
    for name, warm_kw, call in (
            ("sssp", {"d0": d0}, lambda g, **kw: tdrv.sssp(
                g, src, device="cpu", **kw)),
            ("cc", {"l0": l0}, lambda g, **kw: tdrv.connected_components(
                g, device="cpu", **kw))):
        cold, warm = call(t_mut), call(t_mut, **warm_kw)
        assert np.array_equal(warm.values, cold.values), name
        assert warm.n_iters <= cold.n_iters
        ref_warm = (rdrv.sssp(r_mut, src, **warm_kw) if name == "sssp"
                    else rdrv.connected_components(r_mut, **warm_kw))
        assert np.array_equal(warm.values, ref_warm.values)
        assert warm.n_iters == ref_warm.n_iters


@pytest.mark.parametrize("n", [128, 1 << 10])
def test_warm_started_pagerank_reaches_the_same_fixpoint(n):
    (r_pre, r_mut), (t_pre, t_mut) = _mutated(n, 23, 1)
    pre = tdrv.pagerank(t_pre, tol=1e-6, device="cpu")
    cold = tdrv.pagerank(t_mut, tol=1e-6, device="cpu")
    warm = tdrv.pagerank(t_mut, tol=1e-6, r0=pre.values, device="cpu")
    np.testing.assert_allclose(warm.values, cold.values, rtol=1e-3,
                               atol=1e-4)
    assert warm.n_iters <= cold.n_iters
    ref_warm = rdrv.pagerank(r_mut, tol=1e-6, r0=pre.values)
    assert warm.n_iters == ref_warm.n_iters
    np.testing.assert_allclose(warm.values, ref_warm.values, rtol=0,
                               atol=1e-6)


def test_warm_state_lands_on_the_plan_device():
    _, port = _pair(64)
    p = tdrv.sssp(port, 0, device="cpu").plan
    st = tdrv.make_stepper("sssp", p, {}, sources=[0],
                           params={"d0": np.zeros((1, 64))})
    assert st.frontier().device == p.device and \
        st.frontier().dtype == torch.float32
    with pytest.raises(ValueError):
        tdrv.make_stepper("sssp", p, {}, sources=[0, 1],
                          params={"d0": np.zeros(64)})
