"""Training runs of the port's MeshTrainer against the JAX package's on one
model, mesh, batch and set of weights, for the CPU tests of the model
axes (tests/test_torch_tp.py, test_torch_moe.py, test_torch_pp.py).

The weights are drawn with numpy from a seed at the shapes of the JAX
model's parameters (normal(0, 0.02), norm scales one, biases zero), so the
port's ranks start (`start_port`) before the JAX side compiles anything;
`jax_run` trains the JAX `MeshTrainer` from the same weights in this
process meanwhile, and `port_results` collects the ranks' files.  Both
sides run plain SGD: the JAX side's first-step gradients are (p0 - p1) /
lr, the port's are read from its parameters' `.grad` after step 1, summed
over the data group and gathered (`convert.gather_state_dict`).
"""
from __future__ import annotations

import json
import textwrap

import numpy as np

import jax

from _torch_ranks import start_ranks, wait_ranks


def numpy_weights(model, tokens, seed: int):
    """{flax path tuple: array} drawn at the shapes of `model.init`'s params
    (abstract: nothing is compiled), as a nested dict."""
    import flax.linen as nn

    shapes = nn.meta.unbox(jax.eval_shape(model.init, jax.random.PRNGKey(0), tokens)["params"])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale":
            return np.ones(leaf.shape, np.float32)
        if name == "bias":
            return np.zeros(leaf.shape, np.float32)
        return (0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_run(model, loss_fn, mesh, params, tokens, steps: int, lr: float):
    """(losses, first-step gradients, final params) of the JAX MeshTrainer
    under plain SGD from `params` (a numpy tree), one step a call."""
    import optax

    from kungfu_tpu.train import TrainState
    from kungfu_tpu.trainer import MeshTrainer

    trainer = MeshTrainer(model, loss_fn, optax.sgd(lr), mesh=mesh)
    state = trainer.init(jax.random.PRNGKey(0), tokens)
    placed = jax.tree.map(lambda a, b: jax.device_put(b, a.sharding), state.params, params)
    state = TrainState(params=placed, opt_state=trainer.tx.init(placed), step=0)
    batch = trainer.shard_batch(tokens)
    losses, grads = [], None
    for step in range(steps):
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
        if step == 0:
            grads = jax.tree.map(lambda p0, p1: (p0 - p1) / lr, params,
                                 trainer.eval_params(state))
    return losses, grads, trainer.eval_params(state)


WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import convert, distributed
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.parallel import PipelinedLM
    from kungfu_tpu_torch.parallel.moe import MoEMLP
    from kungfu_tpu_torch.plan import make_mesh
    from kungfu_tpu_torch.trainer import MeshTrainer

    path = sys.argv[1]
    spec = json.load(open(path + ".json"))
    data = np.load(path + ".in.npz")
    whole = {k: torch.from_numpy(data[k]) for k in data.files if k != "tokens"}
    distributed.init_distributed(device="cpu")
    mesh = make_mesh(**spec["mesh"])
    cfg = tt.TransformerConfig(dtype=torch.float32, mesh=mesh, **spec["config"])
    if spec["pipeline"]:
        repeats, micro = spec["pipeline"]
        model = PipelinedLM(cfg, repeats=repeats, microbatches=micro, device="cpu")
    else:
        model = tt.TransformerLM(cfg, device="cpu")
    model.load_state_dict(convert.shard_state_dict(whole, mesh))

    def loss(m, b):
        if cfg.n_experts:
            return tt.lm_loss_shard_with_aux(m, b.tokens, b.targets, b.count)
        return tt.lm_loss_shard(m(b.tokens), b.targets, b.count, m.vocab_group)

    trainer = MeshTrainer(loss, lambda p: torch.optim.SGD(p, spec["lr"]), mesh,
                          impl=spec["impl"], device="cpu")
    state = trainer.init(model)
    batch = trainer.shard_batch(torch.from_numpy(data["tokens"]).long())
    out = {"losses": [], "dropped": []}
    for step in range(spec["steps"]):
        state, m = trainer.train_step(state, batch)
        out["losses"].append(m["loss"].item())
        out["dropped"] += [float(mod.dropped) for mod in model.modules()
                           if isinstance(mod, MoEMLP)]
        if step == 0:
            grads = convert.gather_state_dict(
                {n: p.grad for n, p in state.params.named_parameters()}, mesh)
    params = convert.gather_state_dict(trainer.eval_params(state), mesh)
    np.savez(path + f".{dist.get_rank()}.npz", losses=np.array(out["losses"]),
             dropped=np.array(out["dropped"]),
             **{"grad/" + k: v.numpy() for k, v in grads.items()},
             **{"param/" + k: v.numpy() for k, v in params.items()})
    distributed.shutdown_distributed()
""")


def start_port(tmp, name: str, whole: dict, tokens, mesh: dict, config: dict, steps: int,
               lr: float, pipeline=None, impl: str = "pmean") -> list:
    """Start the port's run `name` on the mesh's ranks: `whole` is the
    port-named whole state dict (numpy), `config` the TransformerConfig
    fields besides dtype and mesh, `pipeline` (repeats, microbatches) for a
    PipelinedLM.  Returns the processes."""
    n = int(np.prod(list(mesh.values())))
    np.savez(tmp / f"{name}.in.npz", tokens=np.asarray(tokens), **whole)
    with open(tmp / f"{name}.json", "w") as f:
        json.dump(dict(mesh=mesh, config=config, steps=steps, lr=lr, pipeline=pipeline,
                       impl=impl), f)
    return start_ranks(WORKER, n, [tmp / name])


def port_results(tmp, name: str, procs, timeout: float = 300) -> list:
    """Each rank's npz of run `name` once its processes have ended."""
    wait_ranks(procs, timeout=timeout)
    return [np.load(tmp / f"{name}.{r}.npz") for r in range(len(procs))]


def by_prefix(res, prefix: str) -> dict:
    """{name: array} of the npz entries under `prefix`/."""
    return {k[len(prefix) + 1:]: res[k] for k in res.files if k.startswith(prefix + "/")}


def assert_tree_close(got_tree, want_tree, atol: float, what: str) -> None:
    """Every leaf of `want_tree` (a flax tree) within atol of `got_tree`'s."""
    for path, want in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        g = got_tree
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def replicas_identical(results) -> None:
    """Every rank gathered the same bits (the shards of each data shard's
    ranks and the replicas of each shard agree)."""
    first = results[0]
    for res in results[1:]:
        for key in first.files:
            np.testing.assert_array_equal(res[key], first[key], err_msg=key)
