"""Port vs reference: the learned cost model, its file format and the
MessagePack codec it is written with.

The port reads its own copy of the shipped artifact and corpus
(`src/repro_torch/plan/_data/`) without JAX or `msgpack`.  Everything is
held to the reference exactly: feature vectors and predictions compare
with `==` on float64 (the compiler's decisions sit within a percent of
its 2 % margin, and R-MAT 2^22 is a tie), model bytes and checkpoint
files byte for byte.
"""
import dataclasses
import os

import numpy as np
import pytest
from _torch_parity import port_csr

from repro.core import generators as rg
from repro.core import structure as rstruct
from repro.plan import costmodel as rcm
from repro.plan import serial as rserial
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import msgpack_codec as codec
from repro_torch.core import structure as tstruct
from repro_torch.core.cache_model import SANDY_BRIDGE
from repro_torch.plan import costmodel as tcm
from repro_torch.plan import serial as tserial

DATA = os.path.join(os.path.dirname(tcm.__file__), "_data")
CORPUS = os.path.join(DATA, "costmodel_corpus.json")
REF_CORPUS = os.path.join(os.path.dirname(rcm.__file__), "_data",
                          "costmodel_corpus.json")


@pytest.fixture(scope="module")
def corpus():
    return tcm.load_corpus(CORPUS)


@pytest.fixture(scope="module")
def shipped():
    model, step = tserial.load_model(tcm.DEFAULT_MODEL_DIR)
    assert step == 0
    return model


def _matrices():
    scr = rcm.label_matrix("scrambled", 1 << 10, 0)
    return {"fd": rg.fd_matrix(1 << 12), "rmat": rg.rmat_matrix(1 << 12),
            "uniform": rg.uniform_random_matrix(1 << 11),
            "banded": rg.banded_matrix(1 << 12, 8), "scrambled": scr,
            "fd22": rg.fd_matrix(22), "single-row": rg.rmat_matrix(16)}


MATRICES = _matrices()


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("threads,geo", [(1, None), (4, None),
                                         (8, (16 * 1024, 64 * 1024))])
def test_features_are_bit_equal(name, threads, geo):
    ref = MATRICES[name]
    rep, trep = rstruct.analyze(ref), tstruct.analyze(port_csr(ref))
    kw = {} if geo is None else dict(l2_bytes=geo[0], llc_bytes=geo[1])
    want = rcm.features_for(rep, threads, **kw)
    got = tcm.features_for(trep, threads, machine=SANDY_BRIDGE, **kw)
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()
    assert len(got) == len(tcm.FEATURE_NAMES)
    assert tcm.FEATURE_NAMES == rcm.FEATURE_NAMES


def test_shipped_copy_loads_to_the_reference_model(shipped):
    ref = rcm.default_model()
    assert ref is not None
    assert tcm.model_bytes(shipped) == rcm.model_bytes(ref)
    assert tcm.model_digest(shipped) == rcm.model_digest(ref)
    assert tcm.model_bytes(tcm.default_model()) == rcm.model_bytes(ref)
    assert len(shipped.trees) == 150


def test_refit_on_the_ports_corpus_reproduces_the_artifact(corpus, shipped):
    """Counterpart of `test_refit_matches_shipped_artifact`."""
    assert shipped.meta["corpus_digest"] == tcm.corpus_digest(corpus)
    refit = tcm.fit(corpus, config=shipped.config)
    assert tcm.model_bytes(refit) == tcm.model_bytes(shipped)
    assert tcm.model_bytes(refit) == rcm.model_bytes(
        rcm.fit(rcm.load_corpus(REF_CORPUS)))


def test_corpus_io_matches_reference(corpus, tmp_path):
    ref = rcm.load_corpus(REF_CORPUS)
    assert [dataclasses.astuple(r) for r in corpus] == \
        [dataclasses.astuple(r) for r in ref]
    assert tcm.corpus_digest(corpus) == rcm.corpus_digest(ref)
    out = tmp_path / "corpus.json"
    tcm.save_corpus(corpus, str(out))
    assert out.read_bytes() == open(CORPUS, "rb").read()
    assert [r.kind for r in tcm.sort_rows(corpus[::-1])] == \
        [r.kind for r in rcm.sort_rows(ref[::-1])]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predictions_are_bit_equal(shipped, corpus, seed):
    """Corpus rows and random rows around them: log2 GFLOPS `==`."""
    ref = rcm.default_model()
    rng = np.random.default_rng(seed)
    X = np.asarray([r.features for r in corpus], dtype=np.float64)
    X = np.concatenate([X, X[rng.integers(0, len(X), 64)]
                        * rng.uniform(0.5, 1.5, (64, X.shape[1]))])
    assert shipped.predict(X).tobytes() == ref.predict(X).tobytes()
    rep = rstruct.analyze(MATRICES["rmat"])
    trep = tstruct.analyze(port_csr(MATRICES["rmat"]))
    assert shipped.predict_gflops(trep, 4) == ref.predict_gflops(rep, 4)
    with pytest.raises(ValueError, match="feature mismatch"):
        shipped.predict(X[:, :5])


def test_evaluation_and_winner_rule_match_reference(shipped, corpus):
    ref = rcm.default_model()
    rows = rcm.load_corpus(REF_CORPUS)
    assert tcm.evaluate(shipped, corpus) == rcm.evaluate(ref, rows)
    for scores in ({"none": 2.0, "rcm": 2.039}, {"none": 2.0, "rcm": 2.041},
                   {"rcm": 1.0}, {"a": 1.0, "b": 1.0}, {"none": 1.0,
                                                       "rcm": 1.0}):
        assert tcm.pick_winner(scores) == rcm.pick_winner(scores)


@pytest.mark.parametrize("kind", tcm.LABEL_KINDS)
def test_label_matrices_and_cells_match_reference(kind):
    from repro_torch.device import to_numpy

    ref = rcm.label_matrix(kind, 256, 1)
    got = tcm.label_matrix(kind, 256, 1, device="cpu")
    for a, b in ((ref.data, got.data), (ref.indices, got.indices),
                 (ref.indptr, got.indptr)):
        assert np.asarray(a).tobytes() == to_numpy(b).tobytes()
    for reorder, threads, spec in (("none", 1, "default"),
                                   ("rcm", 2, "scaled")):
        a = rcm.run_label_cell(kind, 8, reorder, threads, spec, seed=1)
        b = tcm.run_label_cell(kind, 8, reorder, threads, spec, seed=1,
                               device="cpu")
        assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_checkpoint_round_trip_is_byte_exact(shipped, tmp_path):
    """The port writes the shipped files byte for byte; each package
    reads the other's checkpoint to the same model bytes."""
    step_dir = tserial.save_model(shipped, str(tmp_path / "port"))
    ship = os.path.join(tcm.DEFAULT_MODEL_DIR, "step_000000000")
    for f in ("manifest.msgpack", "shard_00000.bin.zlib", "COMMITTED"):
        assert open(os.path.join(step_dir, f), "rb").read() == \
            open(os.path.join(ship, f), "rb").read()
    back, _ = tserial.load_model(str(tmp_path / "port"))
    assert tcm.model_bytes(back) == tcm.model_bytes(shipped)
    ref_back, _ = rserial.load_model(str(tmp_path / "port"))
    assert rcm.model_bytes(ref_back) == tcm.model_bytes(shipped)
    rserial.save_model(rcm.default_model(), str(tmp_path / "ref"))
    port_back, _ = tserial.load_model(str(tmp_path / "ref"))
    assert tcm.model_bytes(port_back) == tcm.model_bytes(shipped)
    # thresholds and leaf values stay float64 bit for bit
    assert all(t.thresh.dtype == np.float64 and t.value.dtype == np.float64
               for t in back.trees)


def test_checkpoint_manager_steps_and_nested_trees(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": {"b": rng.normal(size=(3, 4)).astype(np.float32),
                  "c": np.arange(5, dtype=np.int64)},
            "d": np.frombuffer(b"xyz", dtype=np.uint8).copy()}
    mgr = CheckpointManager(str(tmp_path))
    for step in (1, 5, 9):
        mgr.save(step, tree)
    assert mgr.committed_steps() == [1, 5, 9] and mgr.latest_step() == 9
    got, step = mgr.restore_any()
    assert step == 9
    assert got["a"]["b"].tobytes() == tree["a"]["b"].tobytes()
    assert got["a"]["b"].shape == (3, 4) and got["a"]["c"].dtype == np.int64
    man = mgr.load_manifest(9)
    assert man["treedef"] == \
        "PyTreeDef({'a': {'b': *, 'c': *}, 'd': *})"
    assert [e["key"] for e in man["entries"]] == \
        ["['a']['b']", "['a']['c']", "['d']"]
    os.remove(os.path.join(str(tmp_path), "step_000000009", "COMMITTED"))
    assert mgr.latest_step() == 5
    # a step written with a codec this reader lacks is refused, not
    # misread, with the reference's error naming the codec
    mpath = os.path.join(str(tmp_path), "step_000000005", "manifest.msgpack")
    man = mgr.load_manifest(5)
    man["codec"] = "lz4"
    with open(mpath, "wb") as f:
        f.write(codec.packb(man))
    with pytest.raises(ModuleNotFoundError, match="codec 'lz4'"):
        mgr.restore_any(5)
    # reading a missing checkpoint creates nothing
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_any()
    assert not os.path.exists(tmp_path / "empty")


def _codec_cases():
    ints = [0, 1, 31, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
            2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    strs = ["", "a" * 31, "a" * 32, "b" * 255, "c" * 256, "d" * 65535,
            "e" * 65536, "é€"]
    blobs = [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536]
    return ints + strs + blobs + [
        None, True, False, 0.1, -0.0, 1e300, float("inf"), 2.5,
        list(range(15)), list(range(16)), list(range(70000)),
        {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
        {"k": [1, {"n": None, "f": 1.5}], "z": b"bin"}]


@pytest.mark.parametrize("obj", _codec_cases(),
                         ids=lambda o: type(o).__name__)
def test_codec_matches_msgpack(obj):
    msgpack = pytest.importorskip("msgpack")
    want = msgpack.packb(obj)
    assert codec.packb(obj) == want
    assert codec.unpackb(want) == msgpack.unpackb(want,
                                                  strict_map_key=False)


def test_codec_reads_the_manifests_and_meta_leaves(tmp_path):
    msgpack = pytest.importorskip("msgpack")
    ship = os.path.join(tcm.DEFAULT_MODEL_DIR, "step_000000000")
    raw = open(os.path.join(ship, "manifest.msgpack"), "rb").read()
    assert codec.unpackb(raw) == msgpack.unpackb(raw)
    assert codec.packb(codec.unpackb(raw)) == raw
    state = tserial.model_state(tcm.default_model())
    meta = state["meta"].tobytes()
    assert codec.unpackb(meta) == msgpack.unpackb(meta,
                                                  strict_map_key=False)
    assert codec.packb(msgpack.unpackb(meta, strict_map_key=False)) == meta
    assert msgpack.unpackb(codec.packb({"tuple": (1, 2)})) == \
        {"tuple": [1, 2]}
    for bad in (b"\xc1", b"\xd4\x00\x00", b"\x92\x01"):
        with pytest.raises(ValueError):
            codec.unpackb(bad)
    with pytest.raises(ValueError, match="extra bytes"):
        codec.unpackb(b"\x01\x02")
    with pytest.raises(TypeError):
        codec.packb(np.int64(3))
    with pytest.raises(OverflowError):
        codec.packb(2 ** 64)


def test_default_model_can_be_swapped_and_restored(shipped):
    tcm.default_model()             # load the shipped model before the swap
    prev = tcm.set_default_model(None)
    try:
        assert tcm.default_model() is None
    finally:
        tcm.set_default_model(prev)
    assert tcm.model_bytes(tcm.default_model()) == tcm.model_bytes(shipped)
