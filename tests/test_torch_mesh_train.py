"""Sequence-parallel training: the port's MeshTrainer against the JAX
package's, with ring attention.

The JAX side is `kungfu_tpu.trainer.MeshTrainer` over `make_mesh(sp=4)`
and `make_mesh(dp=2, sp=2)` on 4 virtual CPU devices, with
`TransformerConfig(attention="ring", mesh=mesh)` and plain
`optax.sgd`: one program over the mesh, XLA inserting the gradient psum.
The port runs the same model (f32, RoPE, 2 layers, d_model 64, 4 heads,
sequence 64), from the JAX weights converted by `convert.py`, on 4 gloo
ranks in subprocesses: `make_mesh` with the same axes, each rank holding
its dp rows and its sp chunk of the batch, ring attention over its sp
group (impl="einsum" on the CPU, as the JAX package runs it there), its
loss share summed with the others' and its gradients summed over the mesh
(sp=4 through impl="pallas_ring"'s plain ring, dp=2 x sp=2 through
"pmean"), and `torch.optim.SGD`.

Tolerance: the losses to 1e-5 and the parameters after 2 steps to 1e-5
absolute; both sides sum the same f32 products in other orders (readings
up to 5e-7 for the losses and 6e-8 for the parameters).  RoPE without the
rank's offset moves the first loss by 5e-5 to 1.6e-4 (the weights are
small at init), and gradients averaged instead of summed the second loss
by 0.13.  Every rank must hold the same parameters, bit for bit.
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
TOL_LOSS, TOL_PARAM = 1e-5, 1e-5


def _tokens():
    rng = np.random.default_rng(11)
    return rng.integers(0, COMMON["vocab_size"], (BATCH, COMMON["max_len"])).astype(np.int32)


def _jax_run(sizes):
    """(initial params, losses, final params) of the JAX MeshTrainer."""
    import optax

    from kungfu_tpu.models import transformer as jt
    from kungfu_tpu.plan import make_mesh
    from kungfu_tpu.trainer import MeshTrainer as JMeshTrainer

    mesh = make_mesh(devices=jax.devices()[:RANKS], **sizes)
    cfg = jt.TransformerConfig(dtype=jnp.float32, attention="ring", mesh=mesh, **COMMON)
    model = jt.TransformerLM(cfg)
    trainer = JMeshTrainer(model, lambda m, p, b: jt.lm_loss(m.apply({"params": p}, b), b),
                           optax.sgd(LR), mesh=mesh)
    tokens = jnp.asarray(_tokens())
    state = trainer.init(jax.random.PRNGKey(3), tokens)
    init = trainer.eval_params(state)
    batch = trainer.shard_batch(tokens)
    losses = []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    return init, losses, trainer.eval_params(state)


@pytest.fixture(scope="module")
def ref():
    with jax_reference():
        yield {name: _jax_run(sizes) for name, (sizes, _) in MESHES.items()}


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from kungfu_tpu_torch import convert, distributed
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.plan import make_mesh
    from kungfu_tpu_torch.trainer import MeshTrainer

    path, common, sizes, impl, lr, steps = sys.argv[1], *map(eval, sys.argv[2:])
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
    cfg = tt.TransformerConfig(dtype=torch.float32, attention="ring", mesh=mesh, **common)
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree, cfg))
    trainer = MeshTrainer(lambda m, b: tt.lm_loss_shard(m(b.tokens), b.targets, b.count),
                          lambda params: torch.optim.SGD(params, lr), mesh, impl=impl,
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
    """{mesh name: [per-rank npz]} of the port's MeshTrainer on 4 gloo
    ranks, both meshes at once."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    procs = []
    for name, (sizes, impl) in MESHES.items():
        init = ref[name][0]
        flat = {jax.tree_util.keystr(p, simple=True, separator="/"): v
                for p, v in jax.tree_util.tree_flatten_with_path(init)[0]}
        np.savez(tmp / f"{name}.in.npz", tokens=_tokens(), **flat)
        procs += start_ranks(WORKER, RANKS, [tmp / name, repr(COMMON), repr(sizes), repr(impl),
                                             repr(LR), repr(STEPS)])
    wait_ranks(procs, timeout=300)
    return {name: [np.load(tmp / f"{name}.{r}.npz") for r in range(RANKS)] for name in MESHES}


@pytest.mark.parametrize("name", list(MESHES))
def test_first_step_loss_matches_jax(ref, ranks, name):
    for res in ranks[name]:
        np.testing.assert_allclose(res["losses"][0], ref[name][1][0], rtol=0, atol=TOL_LOSS)


@pytest.mark.parametrize("name", list(MESHES))
def test_two_steps_match_jax(ref, ranks, name):
    res = ranks[name][0]
    np.testing.assert_allclose(res["losses"], ref[name][1], rtol=0, atol=TOL_LOSS)
    assert res["losses"][-1] < res["losses"][0]
    cfg = tt.TransformerConfig(dtype=torch.float32, **COMMON)
    got = convert.params_to_flax({k: torch.from_numpy(res[k]) for k in res.files
                                  if k != "losses"}, cfg)
    for path, want in jax.tree_util.tree_flatten_with_path(ref[name][2])[0]:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, want, rtol=0, atol=TOL_PARAM,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(MESHES))
def test_replicas_identical(ranks, name):
    first = ranks[name][0]
    for res in ranks[name][1:]:
        for key in first.files:
            np.testing.assert_array_equal(res[key], first[key])


def test_config_refusals():
    with pytest.raises(ValueError, match="sliding window"):
        tt.TransformerConfig(attention="ring", window=8)
    with pytest.raises(NotImplementedError, match="A.6"):
        tt.TransformerConfig(attention="ulysses")
    for axis in ("pp", "ep", "tp"):
        with pytest.raises(NotImplementedError, match="A.6"):
            pm.make_mesh(**{axis: 1})
    assert pm.make_mesh(fsdp=1).shape == {"fsdp": 1}  # ported: fsdp.FSDPTrainer
    with pytest.raises(ValueError, match="unknown axes"):
        pm.make_mesh(xp=1)


def test_hidden_head_refused():
    """head="hidden" has no chunked loss over a sequence shard yet (A.6)."""
    cfg = tt.TransformerConfig(head="hidden", **COMMON)
    trainer = MeshTrainer(None, None, pm.make_mesh(dp=1, sp=1), device="cpu")
    with pytest.raises(NotImplementedError, match="A.6"):
        trainer.init(tt.TransformerLM(cfg, device="cpu"))


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
