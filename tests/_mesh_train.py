"""The port's side of the partitioned-step parity tests
(`tests/test_torch_mesh_train*.py`): the cases, the inputs both packages
read and the functions the port's ranks run.

The ranks are spawned processes (`repro_torch.launch.mesh.launch`), so
this module imports neither JAX nor the reference: the reference runs
the same cases in a subprocess with eight host devices
(`tests/_mesh_train_reference.py`), reading the npz of inputs that
`write_inputs` fills from `_lm_parity`'s shared parameters and batches.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.configs import CONFIGS
from repro_torch.distributed import api, partition, sharding
from repro_torch.distributed.api import P
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert, registry
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.train.loop import TrainConfig, make_train_step
from repro_torch.tree import leaves, unflatten

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = 8
BATCH, SEQ = 8, 64
N_STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
REMAT = "full"
PROMPT, DECODE = 16, 3              # the forward's prompt and decode steps


def config(arch, configs=CONFIGS):
    return dataclasses.replace(configs[arch].reduced(), dtype="float32")


def case_name(arch, shape):
    return f"{arch}|{shape[0]}x{shape[1]}"


def parse(case):
    arch, shape = case.split("|")
    return arch, tuple(int(n) for n in shape.split("x"))


def write_inputs(path, archs):
    """Each arch's parameters (the reference's seeded tree, perturbed:
    `_lm_parity.shared_train_params`) and N_STEPS batches
    (`_lm_parity.train_batch`) as numpy, in JAX's leaf order."""
    import jax
    from _lm_parity import configs, shared_train_params, train_batch

    out = {}
    for arch in archs:
        rc, _ = configs(arch, "float32")
        ref, _ = shared_train_params(rc)
        for i, leaf in enumerate(jax.tree.leaves(ref)):
            out[f"{arch}|p{i}"] = np.asarray(leaf)
        for s in range(N_STEPS):
            rb, _ = train_batch(rc.vocab, BATCH, SEQ, seed=20 + s)
            out[f"{arch}|tokens{s}"] = np.asarray(rb["tokens"])
            out[f"{arch}|labels{s}"] = np.asarray(rb["labels"])
        rng = np.random.default_rng(30)
        out[f"{arch}|prompt"] = rng.integers(
            0, rc.vocab, (BATCH, PROMPT + DECODE)).astype(np.int32)
    np.savez(path, **out)


def run_reference(inputs, out, cases):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), TESTS]))
    return subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "_mesh_train_reference.py"),
         str(inputs), str(out), *cases], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc, out):
    stdout, stderr = proc.communicate(timeout=900)
    assert "REFERENCE DONE" in stdout, stderr[-3000:]
    return np.load(out)


def worlds(tmp_dir, cases):
    """(the reference's results, every port rank's results) of `cases`:
    the reference's subprocess and the port's 8-rank gloo world run side
    by side on one npz of inputs."""
    from repro_torch.launch.mesh import launch

    inputs, out = tmp_dir / "inputs.npz", tmp_dir / "reference.npz"
    write_inputs(inputs, sorted({parse(c)[0] for c in cases}))
    proc = run_reference(inputs, out, cases)
    try:
        ranks = launch(train_rank, WORLD, device="cpu",
                       args=(str(inputs), tuple(cases)))
    finally:
        ref = finish(proc, out)
    return ref, ranks


def _params(data, arch, cfg):
    """The global parameter tree (the reference's stacked layout) from
    the npz."""
    with registry.fake_mode():
        like = convert.params_to_reference(
            registry.get_model(cfg).init(None, "cpu"), cfg)
    n = len(leaves(like))
    return unflatten(like, [torch.from_numpy(data[f"{arch}|p{i}"].copy())
                            for i in range(n)])


def _np(tree):
    return [t.detach().numpy().copy() for t in leaves(tree)]


def _forward(cfg, params, mesh, part, tokens):
    """Prefill then DECODE teacher-forced steps: the partitioned forward's
    logits assembled from every rank, and the one-rank forward's."""
    api_ = registry.get_model(cfg)
    spec = P(api.resolve_axis(mesh, "dp"), None, "model")
    rows = partition.batch_block({"t": tokens}, mesh)["t"]
    max_len = PROMPT + DECODE

    def run(p, toks, **kw):
        out = []
        logits, cache = api_.prefill(p, {"tokens": toks[:, :PROMPT]},
                                     max_len, use_kernels=False, **kw)
        out.append(logits)
        for t in range(PROMPT, max_len):
            logits, cache = api_.decode_step(p, cache, toks[:, t:t + 1],
                                             use_kernels=False, **kw)
            out.append(logits)
        return torch.cat(out, dim=1)

    with torch.no_grad():
        whole = run(convert.params_from_reference(params, cfg, "cpu"), tokens)
        blocks = partition.cut(params, part.param_specs, mesh)
        with api.bind_axes(mesh):
            mine = run(convert.params_from_reference(blocks, cfg, "cpu"),
                       rows, part=part)
        got = partition.assemble({"l": mine}, {"l": spec}, mesh)["l"]
    return got.numpy(), whole.numpy()


def train_rank(rank, inputs_path, cases):
    """Every case on this rank: the partitioned forward against the
    one-rank forward, then N_STEPS partitioned train steps from the
    npz's parameters and batches.  Rank 0 returns the assembled global
    results; every rank its metrics' and replicated leaves' bits."""
    data = np.load(inputs_path)
    out = {}
    for case in cases:
        arch, shape = parse(case)
        cfg = config(arch)
        mesh = make_mesh(shape, ("data", "model"))
        part = partition.RankLayout(cfg, mesh)
        params = _params(data, arch, cfg)
        tokens = torch.from_numpy(data[f"{arch}|prompt"].astype(np.int64))
        logits, one_rank = _forward(cfg, params, mesh, part, tokens)

        tc = TrainConfig(optimizer=OptimizerConfig(**OPT), remat=REMAT)
        opt = make_optimizer(tc.optimizer)[0](params)
        ospecs = sharding.opt_state_specs(opt, params, cfg, mesh)
        p = partition.cut(params, part.param_specs, mesh)
        o = partition.cut(opt, ospecs, mesh)
        step = make_train_step(registry.get_model(cfg), tc, mesh)
        metrics, mu1 = [], None
        for s in range(N_STEPS):
            batch = {k: torch.from_numpy(data[f"{arch}|{k}{s}"])
                     for k in ("tokens", "labels")}
            p, o, m = step(p, o, partition.batch_block(batch, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
            if s == 0:
                mu1 = _np(partition.assemble(o.mu, part.param_specs, mesh))
        gp = partition.assemble(p, part.param_specs, mesh)
        go = partition.assemble(o, ospecs, mesh)
        replicated = [x.numpy().copy() for x, spec in zip(
            leaves(p), sharding.spec_leaves(part.param_specs))
            if not any(spec)]
        res = {"metrics": metrics, "replicated": replicated}
        if rank == 0:
            res.update(mu1=mu1, params=_np(gp),
                       state=_np(tuple(go[1:])), step=int(go.step),
                       logits=logits, one_rank=one_rank,
                       kv_split=part.kv_split)
        out[case] = res
    return out


# ---------------------------------------------------------------------------
# The checks (in the test process: they import the reference's tolerances)
# ---------------------------------------------------------------------------

def _ref_leaves(ref, case, what):
    n = sum(1 for k in ref.files if k.startswith(f"{case}|{what}"))
    return [ref[f"{case}|{what}{i}"] for i in range(n)]


def check_metrics(worlds, case):
    """Every step: the loss and the gradient norm within rel 1e-5 of the
    reference's, the learning rate equal."""
    ref, ranks = worlds
    got = ranks[0][case]["metrics"]
    assert len(got) == N_STEPS
    for s, m in enumerate(got):
        assert m["lr"] == float(ref[f"{case}|lr{s}"])
        np.testing.assert_allclose(m["loss"], ref[f"{case}|loss{s}"],
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"],
                                   ref[f"{case}|grad_norm{s}"], rtol=1e-5)


def _grads(mu1):
    """Step 1's (clipped) gradients from AdamW's first moment."""
    b1 = OptimizerConfig().b1
    return [m / np.float32(1 - b1) for m in mu1]


def check_gradients(worlds, case):
    """Step 1's gradients (`mu / (1 - b1)`) within 1e-4 of each leaf's
    max |g|."""
    ref, ranks = worlds
    want = _grads(_ref_leaves(ref, case, "mu1_"))
    got = _grads(ranks[0][case]["mu1"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def check_state(worlds, case):
    """The updated parameters and optimizer state to
    `tests/test_torch_train.py`'s float32 bars, parameters outside its
    `sign_noise` mask (from the reference's gradients of both steps)."""
    from test_torch_train import TOL, sign_noise

    ref, ranks = worlds
    r = ranks[0][case]
    tol = TOL["float32"]
    b1 = np.float32(OptimizerConfig().b1)
    mu1 = _ref_leaves(ref, case, "mu1_")
    state = _ref_leaves(ref, case, "state")
    mu2 = state[:len(mu1)]
    g1 = _grads(mu1)
    g2 = [(m2 - b1 * m1) / (1 - b1) for m1, m2 in zip(mu1, mu2)]
    noise = sign_noise([g1, g2])
    assert r["step"] == int(ref[f"{case}|step"]) == N_STEPS
    want = _ref_leaves(ref, case, "param")
    assert len(r["params"]) == len(want) == len(noise)
    for got, w, skip in zip(r["params"], want, noise):
        keep = ~skip
        np.testing.assert_allclose(got[keep], w[keep], rtol=tol["rtol"],
                                   atol=tol["atol"])
    assert len(r["state"]) == len(state)
    for got, w in zip(r["state"], state):
        assert got.shape == w.shape
        assert np.abs(got - w).max() <= tol["state"] * max(
            np.abs(w).max(), 1e-30)


def check_replicated(worlds, case):
    """The loss, the norm and every replicated leaf the same bits on
    every rank."""
    _, ranks = worlds
    first = ranks[0][case]
    assert first["replicated"], "no replicated leaf"
    for other in ranks[1:]:
        assert other[case]["metrics"] == first["metrics"]
        for a, b in zip(other[case]["replicated"], first["replicated"]):
            assert np.array_equal(a, b)


def check_forward(worlds, case):
    """Prefill and teacher-forced decode logits of the partitioned
    forward, assembled from every rank, against the port's one-rank
    forward, in float32."""
    from _lm_parity import TOL

    r = worlds[1][0][case]
    assert r["logits"].shape == r["one_rank"].shape == (
        BATCH, 1 + DECODE, config(parse(case)[0]).vocab)
    np.testing.assert_allclose(r["logits"], r["one_rank"],
                               **TOL["float32"])


# ---------------------------------------------------------------------------
# The differentiable collectives on two ranks
# ---------------------------------------------------------------------------

def collectives_rank(rank):
    """Each of `distributed.autograd`'s collectives on a two-rank axis,
    forward and backward, with a rank-dependent cotangent: -> the
    outputs, the input gradients and what `observe_collectives` saw."""
    from repro_torch.distributed import autograd as AG

    mesh = make_mesh((2,), ("x",))
    w = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (rank + 1)
    out, seen = {}, []
    with api.bind_axes(mesh), api.observe_collectives(
            lambda kind, b: seen.append((kind, b))):
        for name, fn, shape in (
                ("gather0", lambda x: AG.all_gather(x, "x", 0), (2, 6)),
                ("gather1", lambda x: AG.all_gather(x, "x", 1), (4, 3)),
                ("psum", lambda x: AG.psum(x, "x"), (4, 6)),
                ("enter", lambda x: AG.enter(x, "x"), (4, 6)),
                ("pmax", lambda x: AG.pmax(x, "x") + x, (4, 6))):
            x = (torch.arange(float(np.prod(shape))).reshape(shape)
                 * (1 + 10 * rank)).requires_grad_()
            y = fn(x)
            (y * w).sum().backward()
            out[name] = (y.detach().numpy(), x.grad.numpy())
    return out, seen


# ---------------------------------------------------------------------------
# The launcher on a world
# ---------------------------------------------------------------------------

def launcher_rank(rank, argv):
    """`repro_torch.launch.train.main(argv)` on this rank: its losses."""
    from repro_torch.launch import train
    return train.main(list(argv))


# ---------------------------------------------------------------------------
# The card: two ranks share it over gloo
# ---------------------------------------------------------------------------

CARD_MESHES = {"1x2": (1, 2), "2x1": (2, 1)}


def card_train_rank(rank):
    """On each mesh of CARD_MESHES: this rank's gradients from the
    partitioned loss (`train.loop.loss_and_grads(part=)`) on its blocks
    and rows against its blocks of the one-rank gradients, on the card,
    for StableLM's reduced config in float32 with a batch of 4 x 32.
    -> {mesh: (loss, one-rank loss, max |diff| / leaf max)}."""
    from repro_torch.train.loop import loss_and_grads

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = config("stablelm-1.6b")
    api_ = registry.get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = convert.params_to_reference(api_.init(gen, dev), cfg)
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 33))).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss1, grads1 = loss_and_grads(api_, "none")(params, batch)
    out = {}
    for name, shape in CARD_MESHES.items():
        mesh = make_mesh(shape, ("data", "model"))
        part = partition.RankLayout(cfg, mesh)
        blocks = partition.cut(params, part.param_specs, mesh)
        loss, grads = loss_and_grads(api_, "none", part)(
            blocks, partition.batch_block(batch, mesh))
        err = 0.0
        for g, g1, spec in zip(leaves(grads), leaves(grads1),
                               sharding.spec_leaves(part.param_specs)):
            want = sharding.block_of(g1, spec, mesh)
            err = max(err, float((g - want).abs().max())
                      / max(float(g1.abs().max()), 1e-30))
        out[name] = (float(loss), float(loss1), err)
    return out
