"""The port's gossip (pair averaging) against the JAX package's.

One worker runs every case once on 4 gloo ranks (tests/_torch_ranks.py);
the JAX package runs the same inputs under shard_map on 4 CPU devices.

* the pair exchanges (`compression.compressed_pair_average`,
  `sparse_pair_exchange`) at shifts 1 and 2, every wire format without
  randomness, bit for bit;
* `pair_averaging` with the roundrobin selector, 3 steps, uncompressed
  and with bf16, int8 and topk pulls, on two leaves (packed into one
  buffer a stream): each step's mixed parameters bit for bit.  The JAX
  update is `u + (mixed - params)`, which rounds apart from the mixed
  model itself, so the JAX side runs an inner transform that keeps the
  parameters it is given (the mixed ones) in its state, and the port an
  SGD at rate 0, whose step leaves them as they are;
* by their properties, where the two packages draw other random bits: the
  random selector draws one shift on every rank, uniformly over the
  shift set, and a state_dict round trip continues the same draws; with
  rate 0 the mean is conserved and the spread shrinks, as
  tests/unit/test_optimizers.py holds the JAX package's; a randk pull
  changes exactly the received coordinates, each to (x + v) / 2;
* the pairings: `plan.graph.permutation_errors` equal to the JAX one's,
  and a pairing that is not a whole ring shift refused before anything
  is sent.

The trainer case (pair_averaging under DataParallelTrainer per replica
against the JAX trainer) is `tests/test_torch_optimizers.py::
test_trainer_steps_match_jax[gossip]`.
"""
from __future__ import annotations

import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch import compression
from kungfu_tpu_torch.compression.collectives import pair_shift
from kungfu_tpu_torch.optimizers import pair_averaging
from kungfu_tpu_torch.optimizers.gossip import _shift_set, pull_mix_
from kungfu_tpu_torch.plan.graph import permutation_errors, validate_permutation

N = 4
STEPS = 3
SHAPES = {"a": (6, 70), "b": (37,)}  # the JAX tree's order (sorted keys)
PAIR_SCHEMES = ("none", "bf16", "int8", "fp8", "topk")
GOSSIP_SCHEMES = ("none", "bf16", "int8", "topk")
RANDOM_DRAWS = 600


@pytest.fixture(scope="module")
def ref():
    with jax_reference() as kf:
        import optax

        from kungfu_tpu import compression as jc
        from kungfu_tpu.compat import shard_map
        from kungfu_tpu.optimizers.gossip import pair_averaging as jax_pair_averaging
        from kungfu_tpu.plan import graph

        yield optax, jc, shard_map, jax_pair_averaging, graph


def _spmd(ref, fn, *args):
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:N]), ("dp",))
    out = jax.jit(ref[2](fn, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                         check_vma=False))(*args)
    return jax.tree.map(np.asarray, out)


def _inputs():
    rng = np.random.default_rng(17)
    return {k: (rng.standard_normal((N, *s)) * rng.uniform(0.1, 4.0, (N, *s))).astype(np.float32)
            for k, s in SHAPES.items()}


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import compression, distributed
    from kungfu_tpu_torch.optimizers import gossip, pair_averaging

    n = distributed.init_distributed(device="cpu")
    r = dist.get_rank()
    data = np.load(sys.argv[1])
    keys = sorted(k for k in data.files if len(k) == 1)
    out = {}

    def sgd0(ps):
        return torch.optim.SGD(ps, lr=0.0)

    # the pair exchanges on one tensor
    x = torch.from_numpy(data["a"][r])
    for scheme in ("none", "bf16", "int8", "fp8", "topk"):
        for s in (1, 2):
            perm = [((i + s) % n, i) for i in range(n)]  # i receives from i + s
            fn = (compression.sparse_pair_exchange if scheme == "topk"
                  else compression.compressed_pair_average)
            out[f"pair/{scheme}/{s}"] = fn(x, None, perm, scheme).numpy()
    try:  # rank 1 receives twice: refused before anything is sent
        compression.compressed_pair_average(x, None, [(0, 1), (2, 1), (3, 2), (1, 3)], "int8")
    except ValueError as e:
        out["refused"] = np.array(str(e))

    def params():
        return [torch.nn.Parameter(torch.from_numpy(data[k][r]).clone()) for k in keys]

    # roundrobin, 3 steps at rate 0: each step's mixed parameters
    for scheme in ("none", "bf16", "int8", "topk"):
        ps = params()
        opt = pair_averaging(sgd0, selector="roundrobin", compression=scheme)(ps)
        for t in range(3):
            for p in ps:
                p.grad = torch.zeros_like(p)
            opt.step()
            for k, p in zip(keys, ps):
                out[f"rr/{scheme}/{t}/{k}"] = p.detach().numpy().copy()

    # the random selector: one shift on every rank; a state_dict round trip
    ps = params()
    opt = pair_averaging(sgd0, seed=3)(ps)
    out["draws"] = np.array([opt.select() for _ in range(int(sys.argv[2]))])
    for t in range(6):
        if t == 3:
            saved = opt.state_dict()
        for p in ps:
            p.grad = torch.zeros_like(p)
        opt.step()
    out["after"] = np.array([opt.select() for _ in range(5)])
    again = pair_averaging(sgd0, seed=99)(params())
    again.load_state_dict(saved)
    for _ in range(3):
        again.step()
    out["restored_after"] = np.array([again.select() for _ in range(5)])
    out["restored_step"] = np.array(again.state.step)

    # mass conservation at rate 0, random selector, 40 steps (the JAX unit case)
    w = [torch.nn.Parameter(torch.from_numpy(data["mass"][r]).clone())]
    opt = pair_averaging(sgd0, seed=4)(w)
    for _ in range(40):
        w[0].grad = torch.zeros_like(w[0])
        opt.step()
    out["mass"] = w[0].detach().numpy()

    # randk: the received coordinates, nothing else
    pulled, shift_wire = [], gossip.shift_wire

    def recording(wire, group, shift):  # the pull's shift (rank i pulls i + s)
        pulled.append(-shift)
        return shift_wire(wire, group, shift)

    gossip.shift_wire = recording
    ps = params()
    opt = pair_averaging(sgd0, seed=5, compression="randk")(ps)
    for p in ps:
        p.grad = torch.zeros_like(p)
    opt.step()
    gossip.shift_wire = shift_wire
    out["randk_shift"] = np.array(pulled)
    for k, p in zip(keys, ps):
        out[f"randk/{k}"] = p.detach().numpy()
    np.savez(sys.argv[3] + f".{r}.npz", **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """({case: (N, ...) array of every rank's result}, inputs)."""
    tmp = tmp_path_factory.mktemp("gossip")
    inputs = _inputs()
    inputs["mass"] = np.random.RandomState(4).randn(N, 3).astype(np.float32)
    np.savez(tmp / "in.npz", **inputs)
    wait_ranks(start_ranks(WORKER, N, [tmp / "in.npz", RANDOM_DRAWS, tmp / "out"]))
    outs = [np.load(tmp / f"out.{r}.npz") for r in range(N)]
    return {k: np.stack([o[k] for o in outs]) for k in outs[0].files}, inputs


@pytest.mark.parametrize("scheme", PAIR_SCHEMES)
@pytest.mark.parametrize("shift", [1, 2])
def test_pair_exchange_matches_jax(ref, gloo, scheme, shift):
    got, inputs = gloo
    jc = ref[1]
    perm = [((i + shift) % N, i) for i in range(N)]
    fn = jc.sparse_pair_exchange if scheme == "topk" else jc.compressed_pair_average
    want = _spmd(ref, lambda a: fn(a[0], "dp", perm, scheme)[None], inputs["a"])
    np.testing.assert_array_equal(got[f"pair/{scheme}/{shift}"], want)


def _capture(optax):
    """An inner transform whose state is the parameters it was given."""
    return optax.GradientTransformation(
        lambda p: p, lambda u, s, p: (jax.tree.map(jnp.zeros_like, u), p))


@pytest.mark.parametrize("scheme", GOSSIP_SCHEMES)
def test_roundrobin_matches_jax(ref, gloo, scheme):
    """Shifts 1, 2, 1 (the shift set of 4 ranks in turn): every step's
    mixed parameters bit for bit."""
    got, inputs = gloo
    optax, _, _, jax_pair_averaging, _ = ref
    tx = jax_pair_averaging(_capture(optax), axis_name="dp", axis_size=N, selector="roundrobin",
                            compression=None if scheme == "none" else scheme)

    def body(a, b):
        w = {"a": a[0], "b": b[0]}
        state = tx.init(w)
        steps = []
        for _ in range(STEPS):
            _, state = tx.update(jax.tree.map(jnp.zeros_like, w), state, w)
            w = state.inner
            steps.append(w)
        return {k: jnp.stack([s[k] for s in steps])[None] for k in SHAPES}

    want = _spmd(ref, body, inputs["a"], inputs["b"])
    for t in range(STEPS):
        for k in SHAPES:
            np.testing.assert_array_equal(got[f"rr/{scheme}/{t}/{k}"], want[k][:, t],
                                          err_msg=f"step {t + 1} {k}")
    # the pull moved every rank's parameters
    assert not np.array_equal(got[f"rr/{scheme}/0/a"], inputs["a"])


def test_random_selector_agrees_and_is_uniform(gloo):
    got, _ = gloo
    draws = got["draws"]
    assert (draws == draws[:1]).all()  # the same shift on every rank
    shifts = _shift_set(N)
    counts = np.array([(draws[0] == s).sum() for s in shifts])
    assert set(np.unique(draws[0])) == set(shifts)
    # each shift's share within 5 standard deviations of 1/|S|
    p = 1 / len(shifts)
    assert (np.abs(counts / RANDOM_DRAWS - p) < 5 * np.sqrt(p * (1 - p) / RANDOM_DRAWS)).all()


def test_random_selector_survives_state_dict(gloo):
    got, _ = gloo
    np.testing.assert_array_equal(got["restored_after"], got["after"])
    assert (got["restored_step"] == 6).all()
    assert (got["after"] == got["after"][:1]).all()


def test_mass_conserved_and_mixing(gloo):
    """As TestPairAveraging.test_mass_conserved_and_mixing holds the JAX
    package's, on the same inputs."""
    got, inputs = gloo
    w0, wf = inputs["mass"], got["mass"]
    np.testing.assert_allclose(wf.mean(axis=0), w0.mean(axis=0), rtol=1e-3, atol=1e-4)
    assert wf.std(axis=0).max() < 0.2 * w0.std(axis=0).max()


def test_randk_pull_changes_the_received_coordinates(gloo):
    got, inputs = gloo
    shift = int(got["randk_shift"][0][0])
    assert (got["randk_shift"] == shift).all() and shift in _shift_set(N)
    for k in SHAPES:
        x = inputs[k].reshape(N, -1)
        new = got[f"randk/{k}"].reshape(N, -1)
        kn = max(1, round(0.01 * x.shape[1]))
        for r in range(N):
            partner = x[(r + shift) % N]
            changed = np.flatnonzero(new[r] != x[r])
            assert 0 < changed.size <= kn, (k, r, changed.size)
            np.testing.assert_array_equal(new[r][changed],
                                          (np.float32(0.5) * (x[r] + partner))[changed])
        # every rank drew the same random subset (the wire generator is alike)
        changed = set().union(*(np.flatnonzero(new[r] != x[r]) for r in range(N)))
        assert len(changed) <= kn


def test_permutation_errors_match_jax(ref, gloo):
    graph = ref[4]
    for pairs, n in [([(1, 0), (2, 1), (3, 2), (0, 3)], 4), ([(0, 1), (2, 1)], 4),
                     ([(0, 0), (0, 1)], 2), ([(5, 0), (0, -1)], 4), ([], 3)]:
        assert permutation_errors(pairs, n) == graph.permutation_errors(pairs, n)
    with pytest.raises(ValueError, match="appears as destination 2 times"):
        validate_permutation([(0, 1), (2, 1)], 4, what="gossip shift")
    got, _ = gloo
    assert all("appears as destination 2 times" in str(m) for m in got["refused"])


def test_pair_shift_and_refusals():
    assert pair_shift([((i + 1) % 4, i) for i in range(4)], 4) == 3  # ring_shift by -1
    assert pair_shift([((i + 2) % 4, i) for i in range(4)], 4) == 2
    with pytest.raises(ValueError, match="not a shift"):
        pair_shift([(1, 0), (0, 1), (3, 2), (2, 3)], 4)  # a permutation, not a shift
    with pytest.raises(ValueError, match="not a shift"):
        pair_shift([(1, 0), (2, 1)], 4)  # partial
    with pytest.raises(ValueError, match="selector"):
        pair_averaging(lambda ps: torch.optim.SGD(ps, lr=0.1), selector="nearest")(
            [torch.nn.Parameter(torch.zeros(2))])
    with pytest.raises(NotImplementedError, match="A.8"):
        pair_averaging(lambda ps: torch.optim.SGD(ps, lr=0.1), analyze=True)
    with pytest.raises(ValueError, match="sparse_pair_exchange needs topk"):
        compression.sparse_pair_exchange(torch.zeros(4), None, [(0, 0)], "int8")


def test_one_rank_pulls_nothing():
    """Without a group the shift set is (0,) and a step is the inner's."""
    w = torch.nn.Parameter(torch.ones(3))
    opt = pair_averaging(lambda ps: torch.optim.SGD(ps, lr=0.5))([w])
    w.grad = torch.ones(3)
    opt.step()
    np.testing.assert_array_equal(w.detach().numpy(), np.full(3, 0.5, np.float32))
    assert opt.state.step == 1 and opt.shifts == (0,)


@pytest.mark.parametrize("chunk", [64, 1 << 20])
def test_pull_packs_leaves_into_chunks(monkeypatch, chunk):
    """At one rank a shift returns what it was given: the packed buffers
    round-trip every leaf of mixed dtypes and odd sizes bit for bit, in
    one chunk and in chunks of at most 64 bytes (a larger leaf alone)."""
    from kungfu_tpu_torch.optimizers import gossip

    monkeypatch.setattr(gossip, "CHUNK_BYTES", chunk)
    gen = torch.Generator().manual_seed(0)
    ps = [torch.randn(5, 7, generator=gen), torch.randn(3, generator=gen).to(torch.bfloat16),
          torch.randn(260, generator=gen), torch.randn((), generator=gen)]
    calls = []

    def recording(sent, group, shift):
        calls.append([b.numel() % 16 for b in sent])
        return shift_wire(sent, group, shift)

    shift_wire = gossip.shift_wire
    monkeypatch.setattr(gossip, "shift_wire", recording)
    for scheme in ("none", "int8", "topk"):
        calls.clear()
        mixed = [p.clone() for p in ps]
        pull_mix_(mixed, None, 0, scheme)
        want = [compression.collectives.pair_mix(p, compression.collectives.pair_wire(p, scheme),
                                                 scheme) for p in ps]
        for m, w in zip(mixed, want):
            assert torch.equal(m, w), scheme
        assert (len(calls) == 1) == (chunk > 4096) and len(calls) <= len(ps)
        assert all(r == 0 for c in calls for r in c)
