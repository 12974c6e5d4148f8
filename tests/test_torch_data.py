"""The port's data pipeline (`repro_torch.data.pipeline`): the
reference's tests (`tests/test_data.py`) mirrored on the port, and its
packed-file batches byte-equal to the reference's.  `SyntheticLM`'s
tokens are the port's own (a seeded torch generator, not JAX's
threefry); its contract is the reference's: a pure function of (seed,
step), disjoint host streams, labels the shifted tokens, tokens in the
vocab, state and restore."""
import os
import tempfile

import numpy as np
import pytest
import torch
from _opt_deps import given, settings, st

from repro.data import pipeline as rpipe
from repro_torch.data.pipeline import (DataConfig, PackedFileDataset,
                                       SyntheticLM, make_pipeline,
                                       stream_seed, write_token_file)


def _cfg(**kw):
    base = dict(vocab=1000, seq_len=16, global_batch=8, seed=7)
    base.update(kw)
    return DataConfig(**base)


def _synthetic(**kw):
    return SyntheticLM(_cfg(**kw), device="cpu")


def test_batch_is_pure_function_of_step():
    a, b = _synthetic(), _synthetic()
    for step in (0, 5, 1000):
        assert torch.equal(a.batch_at(step)["tokens"],
                           b.batch_at(step)["tokens"])


def test_restart_replays_exactly():
    pipe = _synthetic()
    for _ in range(5):
        next(pipe)
    state = pipe.state()
    more = [next(pipe)["tokens"] for _ in range(3)]
    pipe2 = _synthetic()
    pipe2.restore(state)
    replay = [next(pipe2)["tokens"] for _ in range(3)]
    assert all(torch.equal(a, b) for a, b in zip(more, replay))


def test_hosts_draw_disjoint_streams():
    t0 = _synthetic(host_id=0, n_hosts=2).batch_at(0)["tokens"]
    t1 = _synthetic(host_id=1, n_hosts=2).batch_at(0)["tokens"]
    assert t0.shape == (4, 16)      # global 8 split across 2 hosts
    assert not torch.equal(t0, t1)
    seeds = {stream_seed(7, step, host) for step in range(64)
             for host in range(8)}
    assert len(seeds) == 64 * 8


def test_labels_are_shifted_tokens():
    b = _synthetic().batch_at(0)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLM(_cfg())


def test_packed_file_dataset_roundtrip():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 500, size=4096).astype(np.uint16)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tokens.bin")
        write_token_file(path, toks)
        pipe = make_pipeline(_cfg(global_batch=4), path, device="cpu")
        assert isinstance(pipe, PackedFileDataset)
        b = pipe.batch_at(0)
        assert np.array_equal(b["tokens"][0].numpy(),
                              toks[:16].astype(np.int32))
        pipe2 = make_pipeline(_cfg(global_batch=4), path, device="cpu")
        assert torch.equal(pipe2.batch_at(3)["tokens"],
                           pipe.batch_at(3)["tokens"])


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_packed_file_batches_are_the_references_bytes(n_hosts):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 60_000, size=5_000).astype(np.uint16)
    with tempfile.TemporaryDirectory() as d:
        ref_path, port_path = (os.path.join(d, n) for n in ("r.bin", "p.bin"))
        rpipe.write_token_file(ref_path, toks)
        write_token_file(port_path, toks)
        with open(ref_path, "rb") as a, open(port_path, "rb") as b:
            assert a.read() == b.read()
        for host in range(n_hosts):
            kw = dict(vocab=60_000, seq_len=32, global_batch=6, seed=3,
                      host_id=host, n_hosts=n_hosts)
            ref = rpipe.make_pipeline(rpipe.DataConfig(**kw), ref_path)
            port = make_pipeline(DataConfig(**kw), port_path, device="cpu")
            ref.restore({"step": 2})
            port.restore({"step": 2})
            for _ in range(40):         # past the file's end: wraps
                want, got = next(ref), next(port)
                for name in ("tokens", "labels"):
                    w = np.asarray(want[name])
                    assert got[name].dtype == torch.int32
                    assert got[name].numpy().tobytes() == w.tobytes()
            assert port.state() == ref.state()


def test_too_short_a_file_is_refused_like_the_reference():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.bin")
        write_token_file(path, np.arange(10))
        with pytest.raises(ValueError, match="too few tokens"):
            PackedFileDataset(_cfg(), path, device="cpu")


@settings(max_examples=10, deadline=None)
@given(step=st.integers(0, 10_000), host=st.integers(0, 3))
def test_property_tokens_in_vocab(step, host):
    t = _synthetic(host_id=host, n_hosts=4).batch_at(step)["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < 1000
