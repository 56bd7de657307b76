"""S-SGD training steps of the port against the JAX trainer.

Three `DataParallelTrainer` steps of `synchronous_sgd(adamw)` on a small
TransformerLM, f32 on the CPU, from the same converted weights and data:
one rank against the JAX trainer on a one-device mesh, then n gloo ranks
(brought up from the KungFu env contract) against it on an n-device
mesh: the default pmean at n=2, and impl="pallas_ring" at n=2 and n=3,
where the JAX trainer runs the Pallas ring kernels in interpret mode and
the port's ranks run their plain ring over gloo.

Tolerance: losses to 2e-5 and parameters to 1e-5 absolute.  Each AdamW
step moves a parameter by at most about the learning rate (1e-3); the
gradients behind it agree to f32 summation order, which Adam's
normalisation can magnify only for gradients near zero.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_reference import jax_reference
from kungfu_tpu_torch import convert
from kungfu_tpu_torch.models import transformer as tt
from kungfu_tpu_torch.optimizers import adamw, synchronous_sgd
from kungfu_tpu_torch.train import DataParallelTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = dict(vocab_size=61, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=16,
              rope=True, attention="flash", flash_block_q=8, flash_block_k=8)
LR, STEPS, PER_RANK = 1e-3, 3, 2


@pytest.fixture(scope="module")
def ref():
    with jax_reference():
        import flax.linen as nn
        import optax

        from kungfu_tpu.models import transformer
        from kungfu_tpu.optimizers import synchronous_sgd as jsync
        from kungfu_tpu.train import DataParallelTrainer as JTrainer

        yield transformer, nn, optax, jsync, JTrainer


def _data(seed=0, ranks=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, COMMON["vocab_size"], (ranks * PER_RANK, COMMON["max_len"])
                        ).astype(np.int32)


def _jax_run(ref, tokens, n_devices, impl="pmean"):
    """(initial params, losses, final params) of the JAX trainer."""
    jt, nn, optax, jsync, JTrainer = ref
    from jax.sharding import Mesh

    cfg = jt.TransformerConfig(dtype=jnp.float32, **COMMON)
    model = jt.TransformerLM(cfg)
    params = nn.meta.unbox(
        jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(tokens[:1]))["params"])
    init = jax.tree.map(np.asarray, params)

    def loss_fn(p, batch):
        return jt.lm_loss(model.apply({"params": p}, batch), batch)

    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("dp",))
    trainer = JTrainer(loss_fn, jsync(optax.adamw(LR, b1=0.9, b2=0.95), impl=impl), mesh=mesh)
    state = trainer.init(params)
    batch = trainer.shard_batch(jnp.asarray(tokens))
    losses = []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    return init, losses, jax.tree.map(np.asarray, state.params)


def _assert_params_close(got_sd, want_tree, cfg):
    got = convert.params_to_flax(got_sd, cfg)
    for path, want in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, want, atol=1e-5, err_msg=jax.tree_util.keystr(path))


def test_single_rank_steps_match_jax(ref):
    tokens = _data()
    init, losses_ref, final_ref = _jax_run(ref, tokens, 1)
    cfg = tt.TransformerConfig(dtype=torch.float32, **COMMON)
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(init, cfg))

    def loss_fn(m, batch):
        return tt.lm_loss(m(batch), batch)

    trainer = DataParallelTrainer(
        loss_fn, synchronous_sgd(adamw(LR, b1=0.9, b2=0.95)), device="cpu")
    state = trainer.init(model)
    batch = trainer.shard_batch(torch.from_numpy(tokens).long())
    losses = []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, batch)
        losses.append(m["loss"].item())
    assert state.step == STEPS
    np.testing.assert_allclose(losses, losses_ref, atol=2e-5)
    assert losses[-1] < losses[0]
    _assert_params_close(trainer.eval_params(state), final_ref, cfg)


def test_accum_steps_equal_one_big_batch():
    """accum_steps=2 over a batch gives the step of the whole batch (the
    mean of the micro-batch gradients), up to f32 summation order."""
    cfg = tt.TransformerConfig(dtype=torch.float32, **COMMON)
    tokens = torch.from_numpy(_data(3)).long()

    def run(accum):
        model = tt.TransformerLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(7))
        trainer = DataParallelTrainer(lambda m, b: tt.lm_loss(m(b), b),
                                      synchronous_sgd(adamw(LR)), accum_steps=accum,
                                      device="cpu")
        state, m = trainer.train_steps(trainer.init(model), tokens, 2)
        return m["loss"].item(), trainer.eval_params(state)

    loss1, p1 = run(1)
    loss2, p2 = run(2)
    assert abs(loss1 - loss2) < 2e-5
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=0, atol=1e-5)


def test_has_aux_threads_model_state():
    """has_aux: loss_fn returns (loss, new model_state), and the trainer
    threads the state from step to step (averaged over the group)."""
    cfg = tt.TransformerConfig(dtype=torch.float32, **COMMON)
    tokens = torch.from_numpy(_data(4)).long()

    def loss_fn(m, ms, b):
        loss = tt.lm_loss(m(b), b)
        return loss, {"steps": ms["steps"] + 1,
                      "loss_ema": 0.5 * ms["loss_ema"] + 0.5 * loss.detach()}

    trainer = DataParallelTrainer(loss_fn, synchronous_sgd(adamw(LR)), has_aux=True,
                                  device="cpu")
    with pytest.raises(ValueError, match="model_state"):
        trainer.init(tt.TransformerLM(cfg, device="cpu"))
    state = trainer.init(tt.TransformerLM(cfg, device="cpu"),
                         {"steps": torch.tensor(0), "loss_ema": torch.tensor(0.0)})
    losses = []
    for _ in range(2):
        state, m = trainer.train_step(state, tokens)
        losses.append(m["loss"].item())
    assert state.model_state["steps"].item() == 2
    ema = 0.5 * (0.5 * losses[0]) + 0.5 * losses[1]
    assert abs(state.model_state["loss_ema"].item() - ema) < 1e-6


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import convert, distributed
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.optimizers import adamw, synchronous_sgd
    from kungfu_tpu_torch.train import DataParallelTrainer

    common, lr, steps, per_rank, world, impl, bucket_bytes = eval(sys.argv[3])
    data = np.load(sys.argv[1])
    tree = {}
    for key in data.files:
        if key == "tokens":
            continue
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = data[key]
    assert distributed.init_distributed(device="cpu") == world
    rank = dist.get_rank()
    cfg = tt.TransformerConfig(dtype=torch.float32, **common)
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree, cfg))
    trainer = DataParallelTrainer(
        lambda m, b: tt.lm_loss(m(b), b),
        synchronous_sgd(adamw(lr, b1=0.9, b2=0.95), impl=impl, bucket_bytes=bucket_bytes),
        device="cpu")
    state = trainer.init(model)
    tokens = torch.from_numpy(data["tokens"]).long()
    batch = trainer.shard_batch(tokens[rank * per_rank:(rank + 1) * per_rank])
    losses = []
    for _ in range(steps):
        state, m = trainer.train_step(state, batch)
        losses.append(m["loss"].item())
    out = {k: v.numpy() for k, v in trainer.eval_params(state).items()}
    np.savez(sys.argv[2] + f".{rank}.npz", losses=np.array(losses), **out)
    distributed.shutdown_distributed()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# (impl, ranks, bucket_bytes): the JAX trainer reduces per leaf; pmean's
# mean is element-wise, so bucketing it changes nothing, while a ring's
# chunks follow the buffer, so the ring cases reduce per leaf as JAX does
@pytest.mark.parametrize("impl,world,bucket_bytes",
                         [("pmean", 2, 4096), ("pallas_ring", 2, None), ("pallas_ring", 3, None)])
def test_two_rank_gloo_steps_match_jax(ref, tmp_path, monkeypatch, impl, world, bucket_bytes):
    monkeypatch.setenv("KFT_PALLAS", "interpret")  # the JAX ring runs the Pallas kernels
    tokens = _data(seed=1, ranks=world)
    init, losses_ref, final_ref = _jax_run(ref, tokens, world, impl)
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): v
            for p, v in jax.tree_util.tree_flatten_with_path(init)[0]}
    data = tmp_path / "in.npz"
    np.savez(data, tokens=tokens, **flat)
    port = _free_port()
    peers = ",".join(f"127.0.0.1:{port + r}" for r in range(world))
    procs = []
    for rank in range(world):
        env = dict(os.environ, KFT_SELF_SPEC=f"127.0.0.1:{port + rank}",
                   KFT_INIT_PEERS=peers, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(data), str(tmp_path / "out"),
             repr((COMMON, LR, STEPS, PER_RANK, world, impl, bucket_bytes))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    cfg = tt.TransformerConfig(dtype=torch.float32, **COMMON)
    results = [np.load(tmp_path / f"out.{r}.npz") for r in range(world)]
    for res in results:
        np.testing.assert_allclose(res["losses"], losses_ref, atol=2e-5)
    # S-SGD: every replica holds the same parameters, bit for bit
    for res in results[1:]:
        for key in results[0].files:
            np.testing.assert_array_equal(res[key], results[0][key])
    _assert_params_close({k: torch.from_numpy(results[0][k]) for k in results[0].files
                          if k != "losses"}, final_ref, cfg)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="A4"):
        synchronous_sgd(adamw(LR), impl="hierarchical")
    with pytest.raises(NotImplementedError):
        synchronous_sgd(adamw(LR), bucket_bytes="auto")
    with pytest.raises(NotImplementedError):
        DataParallelTrainer(lambda m, b: 0, synchronous_sgd(adamw(LR)),
                            per_replica_params=True, device="cpu")
