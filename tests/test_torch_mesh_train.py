"""Sequence-parallel training: the port's MeshTrainer against the JAX
package's, with ring and Ulysses attention, the dense and the chunked head.

The JAX side is `kungfu_tpu.trainer.MeshTrainer` over `make_mesh(sp=4)`
and `make_mesh(dp=2, sp=2)` on 4 virtual CPU devices, with
`TransformerConfig(attention="ring" or "ulysses", mesh=mesh)` and plain
`optax.sgd`: one program over the mesh, XLA inserting the gradient psum.
The port runs the same model (f32, RoPE, 2 layers, d_model 64, 4 heads,
sequence 64), from the JAX weights converted by `convert.py`, on 4 gloo
ranks in subprocesses: `make_mesh` with the same axes, each rank holding
its dp rows and its sp chunk of the batch, ring attention (impl="einsum"
on the CPU, as the JAX package runs it there) or Ulysses attention (the
all_to_all over gloo, the head group on the plain flash version) over its
sp group, its loss share summed with the others' and its gradients summed
over the mesh (sp=4 through impl="pallas_ring"'s plain ring, dp=2 x sp=2
through "pmean"), and `torch.optim.SGD`.  The runs: ring with the dense
head for 2 steps (the first slice's cases), then for 3 steps Ulysses on
both meshes and head="hidden" (`lm_loss_shard_chunked` against the JAX
`lm_loss_chunked` on the whole batch, vocab blocks of 32) with Ulysses on
sp=4 and ring on dp=2 x sp=2.

Tolerance: the losses to 1e-5 and the parameters after the last step to
1e-5 absolute; both sides sum the same f32 products in other orders
(readings up to 5e-7 for the losses and 6e-8 for the parameters).  RoPE
without the rank's offset moves the first loss by 5e-5 to 1.6e-4 (the
weights are small at init), and gradients averaged instead of summed the
second loss by 0.13.  Every rank must hold the same parameters, bit for
bit.

The per-step loss rng: `jax.random`'s bits cannot be reproduced, so the
port's dropout under dp=2 x sp=2 (rate 0.1, Ulysses) is held by its
properties: rate 0 under a generator is the run without one, bit for bit;
each step's and each shard's generator draws another mask; a generator of
one step drawn twice is the same mask; and the replicas stay bit-identical
through 3 dropout steps whose losses differ from the undropped ones.
"""
from __future__ import annotations

import json
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch import convert
from kungfu_tpu_torch.models import transformer as tt
from kungfu_tpu_torch.plan import mesh as pm
from kungfu_tpu_torch.trainer import MeshTrainer, _local_shard

COMMON = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_len=64,
              rope=True)
LR, STEPS, BATCH, RANKS = 0.1, 2, 2, 4
MESHES = {"sp4": (dict(sp=4), "pallas_ring"), "dp2-sp2": (dict(dp=2, sp=2), "pmean")}
CE_BLOCK = 32  # head="hidden": the vocab block of both chunked losses
# name -> (mesh, attention, head, steps): the first slice's ring runs, then this one's
RUNS = {"sp4": ("sp4", "ring", "dense", STEPS), "dp2-sp2": ("dp2-sp2", "ring", "dense", STEPS),
        "sp4-ulysses": ("sp4", "ulysses", "dense", 3),
        "dp2-sp2-ulysses": ("dp2-sp2", "ulysses", "dense", 3),
        "sp4-ulysses-hidden": ("sp4", "ulysses", "hidden", 3),
        "dp2-sp2-ring-hidden": ("dp2-sp2", "ring", "hidden", 3)}
NEW_RUNS = [name for name in RUNS if name not in MESHES]
TOL_LOSS, TOL_PARAM = 1e-5, 1e-5


def _tokens():
    rng = np.random.default_rng(11)
    return rng.integers(0, COMMON["vocab_size"], (BATCH, COMMON["max_len"])).astype(np.int32)


def _jax_run(mesh_name, attention, head, steps):
    """(initial params, losses, final params) of the JAX MeshTrainer."""
    import optax

    from kungfu_tpu.models import transformer as jt
    from kungfu_tpu.plan import make_mesh
    from kungfu_tpu.trainer import MeshTrainer as JMeshTrainer

    mesh = make_mesh(devices=jax.devices()[:RANKS], **MESHES[mesh_name][0])
    cfg = jt.TransformerConfig(dtype=jnp.float32, attention=attention, mesh=mesh, head=head,
                               **COMMON)
    model = jt.TransformerLM(cfg)
    if head == "hidden":
        def loss(m, p, b):
            return jt.lm_loss_chunked(m, p, b, block=CE_BLOCK)
    else:
        def loss(m, p, b):
            return jt.lm_loss(m.apply({"params": p}, b), b)
    trainer = JMeshTrainer(model, loss, optax.sgd(LR), mesh=mesh)
    tokens = jnp.asarray(_tokens())
    state = trainer.init(jax.random.PRNGKey(3), tokens)
    init = trainer.eval_params(state)
    batch = trainer.shard_batch(tokens)
    losses = []
    for _ in range(steps):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    return init, losses, trainer.eval_params(state)


@pytest.fixture(scope="module")
def ref():
    with jax_reference():
        yield {name: _jax_run(*run) for name, run in RUNS.items()}


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from kungfu_tpu_torch import convert, distributed
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.plan import make_mesh
    from kungfu_tpu_torch.trainer import MeshTrainer

    path, common, sizes, impl, lr, steps, attention, head, block = (sys.argv[1],
                                                                    *map(eval, sys.argv[2:]))
    data = np.load(path + ".in.npz")
    tree = {}
    for key in data.files:
        if key != "tokens":
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    distributed.init_distributed(device="cpu")
    mesh = make_mesh(**sizes)
    cfg = tt.TransformerConfig(dtype=torch.float32, attention=attention, mesh=mesh, head=head,
                               **common)
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree, cfg))
    if head == "hidden":
        def loss(m, b):
            return tt.lm_loss_shard_chunked(m, b.tokens, b.targets, b.count, block=block)
    else:
        def loss(m, b):
            return tt.lm_loss_shard(m(b.tokens), b.targets, b.count)
    trainer = MeshTrainer(loss, lambda params: torch.optim.SGD(params, lr), mesh, impl=impl,
                          device="cpu")
    state = trainer.init(model)
    batch = trainer.shard_batch(torch.from_numpy(data["tokens"]).long())
    losses = []
    for _ in range(steps):
        state, m = trainer.train_step(state, batch)
        losses.append(m["loss"].item())
    out = {k: v.numpy() for k, v in trainer.eval_params(state).items()}
    np.savez(path + f".{mesh.rank}.npz", losses=np.array(losses), **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """{run name: [per-rank npz]} of the port's MeshTrainer on 4 gloo
    ranks, two runs at a time."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    names = list(RUNS)
    for pair in (names[i:i + 2] for i in range(0, len(names), 2)):
        procs = []
        for name in pair:
            mesh_name, attention, head, steps = RUNS[name]
            sizes, impl = MESHES[mesh_name]
            flat = {jax.tree_util.keystr(p, simple=True, separator="/"): v
                    for p, v in jax.tree_util.tree_flatten_with_path(ref[name][0])[0]}
            np.savez(tmp / f"{name}.in.npz", tokens=_tokens(), **flat)
            procs += start_ranks(WORKER, RANKS, [tmp / name, repr(COMMON), repr(sizes),
                                                 repr(impl), repr(LR), repr(steps),
                                                 repr(attention), repr(head), repr(CE_BLOCK)])
        wait_ranks(procs, timeout=300)
    return {name: [np.load(tmp / f"{name}.{r}.npz") for r in range(RANKS)] for name in RUNS}


@pytest.mark.parametrize("name", list(RUNS))
def test_first_step_loss_matches_jax(ref, ranks, name):
    for res in ranks[name]:
        np.testing.assert_allclose(res["losses"][0], ref[name][1][0], rtol=0, atol=TOL_LOSS)


def _steps_match_jax(ref, ranks, name):
    res = ranks[name][0]
    np.testing.assert_allclose(res["losses"], ref[name][1], rtol=0, atol=TOL_LOSS)
    assert len(res["losses"]) == RUNS[name][3] and res["losses"][-1] < res["losses"][0]
    cfg = tt.TransformerConfig(dtype=torch.float32, head=RUNS[name][2], **COMMON)
    got = convert.params_to_flax({k: torch.from_numpy(res[k]) for k in res.files
                                  if k != "losses"}, cfg)
    for path, want in jax.tree_util.tree_flatten_with_path(ref[name][2])[0]:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, want, rtol=0, atol=TOL_PARAM,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(MESHES))
def test_two_steps_match_jax(ref, ranks, name):
    _steps_match_jax(ref, ranks, name)


@pytest.mark.parametrize("name", NEW_RUNS)
def test_three_steps_match_jax(ref, ranks, name):
    """Ulysses and the chunked head: the losses of 3 steps and the
    parameters after them."""
    _steps_match_jax(ref, ranks, name)


@pytest.mark.parametrize("name", list(RUNS))
def test_replicas_identical(ranks, name):
    first = ranks[name][0]
    for res in ranks[name][1:]:
        for key in first.files:
            np.testing.assert_array_equal(res[key], first[key])


def test_config_refusals():
    with pytest.raises(ValueError, match="sliding window"):
        tt.TransformerConfig(attention="ring", window=8)
    with pytest.raises(ValueError, match="sliding window"):
        tt.TransformerConfig(attention="ulysses", window=8)
    # ported: without a mesh axis sp, attention="ulysses" is full attention at offset 0
    cfg = tt.TransformerConfig(attention="ulysses", **COMMON)
    assert not cfg.sequence_parallel and cfg.position_offset(16) == 0
    for axis in ("pp", "ep", "tp"):
        with pytest.raises(NotImplementedError, match="A.6"):
            pm.make_mesh(**{axis: 1})
    assert pm.make_mesh(fsdp=1).shape == {"fsdp": 1}  # ported: fsdp.FSDPTrainer
    with pytest.raises(ValueError, match="unknown axes"):
        pm.make_mesh(xp=1)


def test_hidden_head_refused():
    """head="hidden" is no longer refused: MeshTrainer takes the model,
    and the chunked shares of every rank of dp=2 x sp=2 sum to
    lm_loss_chunked of the whole batch."""
    cfg = tt.TransformerConfig(head="hidden", **COMMON)
    model = tt.TransformerLM(cfg, device="cpu")
    trainer = MeshTrainer(None, lambda p: torch.optim.SGD(p, LR), pm.make_mesh(dp=1, sp=1),
                          device="cpu")
    assert trainer.init(model).params is model
    shape = {"dp": 2, "sp": 2}
    tokens = torch.from_numpy(_tokens()).long()
    B, L = tokens.shape
    total = torch.zeros(())
    for r in range(4):
        mesh = pm.Mesh(shape, r, dict.fromkeys(shape))
        inputs, targets = _local_shard(tokens, mesh)
        total += tt.lm_loss_shard_chunked(_ChunkOf(model, mesh, tokens), inputs, targets,
                                          B * (L - 1), block=CE_BLOCK).detach()
    want = tt.lm_loss_chunked(model, tokens, block=CE_BLOCK).detach()
    torch.testing.assert_close(total, want, rtol=1e-6, atol=0)


class _ChunkOf(torch.nn.Module):
    """The one-process model's hidden states of a shard: the whole batch's
    forward, cut to the shard's rows and chunk (full attention needs the
    whole sequence in one process)."""

    def __init__(self, model, mesh, tokens):
        super().__init__()
        self.model, self.cfg, self.tokens = model, model.cfg, tokens
        self.rows = tokens.shape[0] // mesh.shape["dp"]
        self.chunk = tokens.shape[1] // mesh.shape["sp"]
        self.r0, self.c0 = mesh.coord("dp") * self.rows, mesh.coord("sp") * self.chunk

    def head_weight(self):
        return self.model.head_weight()

    def forward(self, tokens, train=False, generator=None):
        h = self.model(self.tokens)
        return h[self.r0:self.r0 + self.rows, self.c0:self.c0 + self.chunk]


def test_mesh_of_one_process():
    mesh = pm.make_mesh(dp=1, sp=-1)
    assert mesh.shape == {"dp": 1, "sp": 1} and mesh.coords == {"dp": 0, "sp": 0}
    assert mesh.group("sp") is None
    # without a mesh axis sp, attention="ring" is full attention at offset 0
    cfg = tt.TransformerConfig(attention="ring", **COMMON)
    assert not cfg.sequence_parallel and cfg.position_offset(16) == 0


@pytest.mark.parametrize("shape", [{"dp": 2, "sp": 2}, {"dp": 1, "sp": 4}, {"dp": 4}])
def test_rank_layout(shape):
    """dp outer, sp inner: an sp group is consecutive ranks, and the groups
    of an axis partition the world."""
    n = int(np.prod(list(shape.values())))
    seen = [pm.coords(r, shape) for r in range(n)]
    assert len({tuple(c.values()) for c in seen}) == n
    for axis in shape:
        groups = pm.axis_partition(shape, axis)
        assert sorted(r for g in groups for r in g) == list(range(n))
        assert all(len(g) == shape[axis] for g in groups)
    if "sp" in shape:
        assert pm.axis_partition(shape, "sp")[0] == list(range(shape["sp"]))


def test_shards_cover_the_batch_and_its_targets():
    """The shards of every rank of dp=2 x sp=2 put back together are the
    batch, their targets its next tokens (across chunk boundaries), and
    the loss shares sum to lm_loss of the whole batch."""
    shape = {"dp": 2, "sp": 2}
    tokens = torch.from_numpy(_tokens()).long()
    B, L = tokens.shape
    logits = torch.randn(B, L, COMMON["vocab_size"], generator=torch.Generator().manual_seed(5))
    rows, chunk = B // 2, L // 2
    total = torch.zeros(())
    for r in range(4):
        mesh = pm.Mesh(shape, r, dict.fromkeys(shape))
        inputs, targets = _local_shard(tokens, mesh)
        r0, c0 = mesh.coord("dp") * rows, mesh.coord("sp") * chunk
        assert torch.equal(inputs, tokens[r0:r0 + rows, c0:c0 + chunk])
        nxt = torch.cat([tokens[r0:r0 + rows, 1:], torch.full((rows, 1), -1)], 1)
        assert torch.equal(targets, nxt[:, c0:c0 + chunk])
        total += tt.lm_loss_shard(logits[r0:r0 + rows, c0:c0 + chunk], targets, B * (L - 1))
    torch.testing.assert_close(total, tt.lm_loss(logits, tokens), rtol=1e-6, atol=0)
    trainer = MeshTrainer(None, None, pm.make_mesh(dp=1, sp=1), device="cpu")
    shard = trainer.shard_batch(tokens)
    assert shard.count == B * (L - 1) and (shard.targets[:, -1] == -1).all()


SUM_WORKER = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.optimizers.sync import all_reduce_gradients

    distributed.init_distributed(device="cpu")
    r = dist.get_rank()
    out = {}
    for impl in ("pmean", "pallas_ring", "ring", "rs_ag"):
        for op in ("sum", "mean"):
            p = torch.nn.Parameter(torch.zeros(1037))
            p.grad = torch.full((1037,), float(r + 1))
            all_reduce_gradients([p], impl=impl, op=op)
            out[f"{impl}/{op}"] = sorted(set(p.grad.tolist()))
    print("SUMS " + json.dumps(out), flush=True)
    distributed.shutdown_distributed()
""")


def test_gradient_sum_and_mean_for_every_impl():
    """all_reduce_gradients(op="sum") sums over the ranks under every impl
    (MeshTrainer's reduction); op="mean" still averages."""
    outs = wait_ranks(start_ranks(SUM_WORKER, 3, []))
    for out in outs.values():
        got = json.loads(out.split("SUMS ", 1)[1].splitlines()[0])
        for key, values in got.items():
            assert values == ([6.0] if key.endswith("/sum") else [2.0]), (key, values)


DROPOUT_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.plan import make_mesh
    from kungfu_tpu_torch.trainer import MeshTrainer

    path, common, lr, steps = sys.argv[1], *map(eval, sys.argv[2:])
    distributed.init_distributed(device="cpu")
    mesh = make_mesh(dp=2, sp=2)
    tokens = torch.from_numpy(np.load(path + ".tokens.npy")).long()
    init = None

    def run(rate, with_rng):
        global init
        cfg = tt.TransformerConfig(dtype=torch.float32, attention="ulysses", mesh=mesh,
                                   dropout=rate, **common)
        model = tt.TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
        if with_rng:
            def loss(m, b, g):
                return tt.lm_loss_shard(m(b.tokens, train=True, generator=g), b.targets, b.count)
        else:
            def loss(m, b):
                return tt.lm_loss_shard(m(b.tokens), b.targets, b.count)
        trainer = MeshTrainer(loss, lambda p: torch.optim.SGD(p, lr), mesh, device="cpu",
                              seed=7)
        state = trainer.init(model)
        shard = trainer.shard_batch(tokens)
        losses = []
        for _ in range(steps):
            state, m = trainer.train_step(state, shard)
            losses.append(m["loss"].item())
        flat = torch.cat([p.detach().reshape(-1) for p in state.params.parameters()])
        return trainer, np.array(losses), flat.numpy()

    out = {}
    for name, rate, with_rng in (("plain", 0.0, False), ("rate0", 0.0, True),
                                 ("dropout", 0.1, True)):
        trainer, out[name + "/losses"], out[name + "/params"] = run(rate, with_rng)
    # the masks each step's generator draws on this shard, and step 0's drawn again
    for step in range(steps):
        out[f"mask/{step}"] = (torch.rand(4096, generator=trainer.step_generator(step))
                               >= 0.1).numpy()
    out["mask/0/again"] = (torch.rand(4096, generator=trainer.step_generator(0)) >= 0.1).numpy()
    out["takes_rng"] = np.array(trainer._loss_takes_rng)
    np.savez(path + f".{dist.get_rank()}.npz", **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def dropout_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_dropout")
    np.save(tmp / "in.tokens.npy", _tokens())
    wait_ranks(start_ranks(DROPOUT_WORKER, RANKS, [tmp / "in", repr(COMMON), repr(LR), "3"]),
               timeout=300)
    return [np.load(tmp / f"in.{r}.npz") for r in range(RANKS)]


def test_dropout_rate_zero_equals_no_generator(dropout_ranks):
    for f in dropout_ranks:
        assert bool(f["takes_rng"])
        np.testing.assert_array_equal(f["rate0/losses"], f["plain/losses"])
        np.testing.assert_array_equal(f["rate0/params"], f["plain/params"])


def test_dropout_masks_differ_across_steps_and_shards(dropout_ranks):
    """Each (shard, step) generator draws its own mask; one step's drawn
    again is the same mask (a restart at that step draws it again)."""
    masks = [f[f"mask/{s}"] for f in dropout_ranks for s in range(3)]
    for i, a in enumerate(masks):
        assert 0.85 < a.mean() < 0.95
        for b in masks[i + 1:]:
            assert (a != b).any()
    for f in dropout_ranks:
        np.testing.assert_array_equal(f["mask/0/again"], f["mask/0"])


def test_dropout_replicas_stay_identical(dropout_ranks):
    """Under dp=2 x sp=2 the dropout steps keep every rank's parameters
    bit-identical; their losses are not the undropped run's, and fall."""
    first = dropout_ranks[0]
    for f in dropout_ranks[1:]:
        np.testing.assert_array_equal(f["dropout/params"], first["dropout/params"])
        np.testing.assert_array_equal(f["dropout/losses"], first["dropout/losses"])
    assert np.all(np.abs(first["dropout/losses"] - first["plain/losses"]) > 1e-4)
    assert first["dropout/losses"][-1] < first["dropout/losses"][0]
