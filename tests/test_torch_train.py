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
from kungfu_tpu_torch.optimizers import adamw, synchronous_sgd
from kungfu_tpu_torch.train import DataParallelTrainer

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


def _jax_run(ref, tokens, n_devices, impl="pmean", compression=None, first=None,
             ce_block=None, extra=None):
    """(initial params, losses, final params) of the JAX trainer.  A dict
    `first` receives, after step 1, the reduced gradients ("g"), rank 0's
    EF residuals ("e", with compression) and the parameters ("p").  With
    `ce_block` the model has head="hidden" and the loss is lm_loss_chunked
    over vocab blocks of that size.  `extra`: more config fields (remat)."""
    jt, nn, optax, jsync, JTrainer = ref
    from jax.sharding import Mesh

    head = "hidden" if ce_block else "dense"
    cfg = jt.TransformerConfig(dtype=jnp.float32, head=head, **COMMON, **(extra or {}))
    model = jt.TransformerLM(cfg)
    params = nn.meta.unbox(
        jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(tokens[:1]))["params"])
    init = jax.tree.map(np.asarray, params)

    def loss_fn(p, batch):
        if ce_block:
            return jt.lm_loss_chunked(model, p, batch, block=ce_block)
        return jt.lm_loss(model.apply({"params": p}, batch), batch)

    # the inner optimizer keeps the reduced gradients it was given
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, st, p=None: (u, u))
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("dp",))
    trainer = JTrainer(loss_fn, jsync(optax.chain(keep, optax.adamw(LR, b1=0.9, b2=0.95)),
                                      impl=impl, compression=compression), mesh=mesh)
    state = trainer.init(params)
    batch = trainer.shard_batch(jnp.asarray(tokens))
    losses = []
    for step in range(STEPS):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
        if step == 0 and first is not None:
            sync_state, (reduced, _) = state.opt_state
            first["g"] = jax.tree.map(np.asarray, reduced)
            first["p"] = jax.tree.map(np.asarray, state.params)
            if compression is not None:  # replicated state: device 0 holds rank 0's
                first["e"] = jax.tree.map(np.asarray, sync_state.ef.residual)
    return init, losses, jax.tree.map(np.asarray, state.params)


def _assert_params_close(got_sd, want_tree, cfg, atol=1e-5):
    got = convert.params_to_flax(got_sd, cfg)
    for path, want in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, want, atol=atol, err_msg=jax.tree_util.keystr(path))


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


def test_chunked_steps_match_jax(ref):
    """head="hidden" + lm_loss_chunked (vocab blocks of 16 over 61: a
    ragged last block) under DataParallelTrainer + synchronous_sgd(adamw),
    three steps against the JAX trainer with its lm_loss_chunked; the
    tolerances of the dense steps above."""
    tokens = _data(2)
    init, losses_ref, final_ref = _jax_run(ref, tokens, 1, ce_block=16)
    cfg = tt.TransformerConfig(dtype=torch.float32, head="hidden", **COMMON)
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(init, cfg))
    trainer = DataParallelTrainer(
        lambda m, b: tt.lm_loss_chunked(m, b, block=16),
        synchronous_sgd(adamw(LR, b1=0.9, b2=0.95)), device="cpu")
    state = trainer.init(model)
    batch = trainer.shard_batch(torch.from_numpy(tokens).long())
    losses = []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, batch)
        losses.append(m["loss"].item())
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

    (common, lr, steps, per_rank, world, impl, bucket_bytes, compression, ce_block,
     extra) = eval(sys.argv[3])
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
    head = "hidden" if ce_block else "dense"
    cfg = tt.TransformerConfig(dtype=torch.float32, head=head, **common, **extra)
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree, cfg))
    # dropout: each rank's masks from its own generator
    gen = torch.Generator().manual_seed(1000 + rank) if cfg.dropout else None

    def loss_fn(m, b, train=True):
        if ce_block:
            return tt.lm_loss_chunked(m, b, block=ce_block, train=train, generator=gen)
        return tt.lm_loss(m(b, train=train, generator=gen), b)

    trainer = DataParallelTrainer(
        loss_fn,
        synchronous_sgd(adamw(lr, b1=0.9, b2=0.95), impl=impl, bucket_bytes=bucket_bytes,
                        compression=compression),
        device="cpu")
    state = trainer.init(model)
    tokens = torch.from_numpy(data["tokens"]).long()
    batch = trainer.shard_batch(tokens[rank * per_rank:(rank + 1) * per_rank])
    losses, out = [], {}
    for step in range(steps):
        state, m = trainer.train_step(state, batch)
        losses.append(m["loss"].item())
        # every parameter's bits, summed: the replicas compare these after each step
        out[f"sums/{step}"] = np.array([p.detach().view(torch.int32).to(torch.int64).sum().item()
                                        for p in state.params.parameters()])
        if step == 0:  # the reduced gradients, residuals and parameters after step 1
            opt = state.opt_state
            named = list(state.params.named_parameters())
            out.update({"g1/" + n: p.grad.numpy() for n, p in named})
            out.update({"p1/" + n: p.detach().numpy().copy() for n, p in named})
            if opt.state is not None:
                out.update({"e1/" + n: e.numpy().copy()
                            for (n, _), e in zip(named, opt.state.ef.residual)})
    out.update({k: v.numpy() for k, v in trainer.eval_params(state).items()})
    if cfg.dropout:  # evaluation: the trained weights with and without dropout configured
        plain = tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32, head=head, **common),
                                 device="cpu")
        plain.load_state_dict(state.params.state_dict())
        with torch.no_grad():
            out["eval"] = np.array([loss_fn(state.params, batch, train=False).item(),
                                    loss_fn(plain, batch, train=False).item()])
    np.savez(sys.argv[2] + f".{rank}.npz", losses=np.array(losses), **out)
    distributed.shutdown_distributed()
""")


def _gloo_run(ref, tmp_path, impl, world, bucket_bytes, compression=None, first=None,
              ce_block=None, extra=None, dropout=0.0):
    """(losses, final params) of every one of `world` gloo ranks, beside
    the JAX trainer's (initial params, losses, final params).  A dict
    `first` receives the step-1 values of both, "g", "e", "p" from the JAX
    trainer and "torch/g", "torch/e", "torch/p" from rank 0 (state dicts).
    With `ce_block` both train head="hidden" on lm_loss_chunked."""
    tokens = _data(seed=1, ranks=world)
    init, losses_ref, final_ref = _jax_run(ref, tokens, world, impl, compression, first,
                                           ce_block, extra)
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): v
            for p, v in jax.tree_util.tree_flatten_with_path(init)[0]}
    data = tmp_path / "in.npz"
    np.savez(data, tokens=tokens, **flat)
    wait_ranks(start_ranks(WORKER, world, [
        data, tmp_path / "out",
        repr((COMMON, LR, STEPS, PER_RANK, world, impl, bucket_bytes, compression,
              ce_block, dict(extra or {}, **({"dropout": dropout} if dropout else {}))))]))
    results = [np.load(tmp_path / f"out.{r}.npz") for r in range(world)]
    # S-SGD: every replica holds the same parameters and gradients, bit for
    # bit, after every step
    for res in results[1:]:
        for key in results[0].files:
            if not key.startswith("e1/") and key != "eval":  # each rank's own
                np.testing.assert_array_equal(res[key], results[0][key], err_msg=key)
    params = {k: torch.from_numpy(results[0][k]) for k in results[0].files
              if k not in ("losses", "eval") and "/" not in k}
    if first is not None:
        for part in ("g", "e", "p"):
            first["torch/" + part] = {k[3:]: torch.from_numpy(results[0][k])
                                      for k in results[0].files if k.startswith(part + "1/")}
    if dropout:
        return [res["losses"] for res in results], params, [res["eval"] for res in results]
    return [res["losses"] for res in results], params, losses_ref, final_ref


# (impl, ranks, bucket_bytes, ce_block, extra): the JAX trainer reduces
# per leaf; pmean's mean is element-wise, so bucketing it changes nothing,
# while a ring's chunks follow the buffer, so the ring cases reduce per
# leaf as JAX does.  The last cases train head="hidden" on lm_loss_chunked
# (vocab blocks of 16 over 61) on four ranks, as `run -np 4` brings them
# up, the second with remat_policy="dots" (jax.checkpoint_policies.
# dots_saveable in the JAX trainer) in both.
@pytest.mark.parametrize("impl,world,bucket_bytes,ce_block,extra", [
    pytest.param("pmean", 2, 4096, None, None, id="pmean-2-4096"),
    pytest.param("pallas_ring", 2, None, None, None, id="pallas_ring-2-None"),
    pytest.param("pallas_ring", 3, None, None, None, id="pallas_ring-3-None"),
    pytest.param("pmean", 4, 4096, 16, None, id="pmean-4-4096-chunked"),
    pytest.param("pmean", 4, 4096, 16, {"remat": True, "remat_policy": "dots"},
                 id="pmean-4-4096-chunked-remat-dots"),
])
def test_two_rank_gloo_steps_match_jax(ref, tmp_path, monkeypatch, impl, world, bucket_bytes,
                                       ce_block, extra):
    monkeypatch.setenv("KFT_PALLAS", "interpret")  # the JAX ring runs the Pallas kernels
    losses, params, losses_ref, final_ref = _gloo_run(ref, tmp_path, impl, world, bucket_bytes,
                                                      ce_block=ce_block, extra=extra)
    for rank_losses in losses:
        np.testing.assert_allclose(rank_losses, losses_ref, atol=2e-5)
    head = "hidden" if ce_block else "dense"
    _assert_params_close(params, final_ref, tt.TransformerConfig(
        dtype=torch.float32, head=head, **COMMON, **(extra or {})))


def test_four_rank_dropout_keeps_replicas_identical(ref, tmp_path):
    """The four-rank chunked-loss case with dropout 0.1 under train=True,
    each rank's masks from its own generator: the replicas bit-identical
    after every step (the reduced gradients are the same on every rank;
    `_gloo_run` compares every parameter's bit sum), the loss finite, and
    the trained model's evaluation loss (train=False) equal to the same
    weights' without dropout configured.  The JAX and torch masks come from
    different generators, so nothing compares them."""
    losses, _, evals = _gloo_run(ref, tmp_path, "pmean", 4, 4096, ce_block=16, dropout=0.1)
    for rank_losses, (with_dropout, without) in zip(losses, evals):
        assert np.isfinite(rank_losses).all()
        assert with_dropout == without
    np.testing.assert_array_equal(losses[1:], np.tile(losses[0], (3, 1)))


# int8 with error feedback, the whole step against the JAX trainer.  The
# local gradients of the two trainers agree to f32 summation order (1e-7
# relative).  Where a gradient has the same layout in both (the embedding,
# the norm scales) the blocks of 256 values hold the same elements, so
# after step 1 the reduced gradients agree to 2e-6 of the leaf's largest
# and rank 0's EF residuals to 4e-6 of it (a dropped or negated residual
# is off by about 2e-3 of it).  A dense weight's gradient is (out, in) in
# torch and (in, out) in flax: its blocks hold other elements, so its codes,
# and with them its reduced gradient, differ by up to a code step (about
# 1e-2 of the leaf's largest; ROADMAP D).  AdamW's first step moves a
# parameter by about LR * sign(g), so after step 1 every parameter is held
# to 1e-5 except those whose gradient's sign or zero code differs: under
# 3% of them, each within the 2 * LR a sign flip can make.  After three
# steps the differences feed back through the model: losses to 3e-4, every
# parameter within 2 * LR * STEPS, and 90% of them to 1e-4.  The wiring of
# the compressed sync itself (residual carried, buckets, cast back) is held
# bit for bit on identical gradients by test_compressed_sync_matches_jax.
@pytest.mark.parametrize("impl", ["pallas_ring", "pmean"])
def test_compressed_gloo_steps_match_jax(ref, tmp_path, monkeypatch, impl):
    monkeypatch.setenv("KFT_PALLAS", "interpret")  # the fused ring's Pallas kernels
    first = {}
    losses, params, losses_ref, final_ref = _gloo_run(ref, tmp_path, impl, 2, None, "int8",
                                                      first)
    cfg = tt.TransformerConfig(dtype=torch.float32, **COMMON)

    def leaves(tree):
        return {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    want = {k: leaves(first[k]) for k in ("g", "e", "p")}
    got = {k: leaves(convert.params_to_flax(first["torch/" + k], cfg)) for k in ("g", "e", "p")}
    moved = total = 0
    for key, g_want in want["g"].items():
        top = np.abs(g_want).max()
        if not key.endswith("['kernel']"):  # the same layout in both trainers
            np.testing.assert_allclose(got["g"][key], g_want, rtol=0, atol=2e-6 * top,
                                       err_msg=f"reduced gradient after step 1, {key}")
            np.testing.assert_allclose(got["e"][key], want["e"][key], rtol=0, atol=4e-6 * top,
                                       err_msg=f"rank 0's residual after step 1, {key}")
        diff = np.abs(got["p"][key] - want["p"][key])
        assert diff.max() <= 2 * LR * (1 + 1e-3), key
        moved += int((diff > 1e-5).sum())
        total += diff.size
    assert moved / total < 0.03, f"{moved} of {total} parameters differ by more than 1e-5"
    for rank_losses in losses:
        np.testing.assert_allclose(rank_losses[0], losses_ref[0], atol=2e-5)
        np.testing.assert_allclose(rank_losses, losses_ref, atol=3e-4)
    assert losses[0][-1] < losses[0][0]
    final = leaves(convert.params_to_flax(params, cfg))
    diff = np.concatenate([np.abs(final[k] - v).ravel() for k, v in leaves(final_ref).items()])
    assert diff.max() <= 2 * LR * STEPS
    assert (diff > 1e-4).mean() < 0.10


# -- the compressed gradient sync alone, on identical gradients -----------
#
# synchronous_sgd(..., compression="int8") with error feedback on two gloo
# ranks against the JAX all_reduce_gradients in shard_map, over three
# steps of the same per-rank gradients (numpy seeds): the residual carried
# from step to step, the corrected leaves concatenated into buckets, the
# mean cast back to each gradient's dtype (one bf16 leaf).  With the same
# inputs the two do the same operations, with two exceptions that XLA
# decides per program:
#   the residual c - code * scale  one fused multiply-add in the port and
#                                  mostly in XLA, but XLA leaves some leaves'
#                                  product unfused (here the (3, 4, 5) one):
#                                  one rounding of code * scale apart, held
#                                  to 2^-21 of the leaf's largest gradient
#                                  (a dropped or negated residual is off by
#                                  about 2^-9 of it)
#   pmean's peer sum and mean      compression.all_reduce against XLA's
#                                  fusion of the f32 accumulation: 1e-6
#                                  relative (tests/test_torch_compression.py)
# Under pallas_ring the reduced gradients are held bit for bit, every step:
# step 2 and 3 reduce g + e, so a residual not carried, not added or of the
# wrong sign changes their codes.

SYNC_SHAPES = ((37, 11), (1000,), (3, 4, 5), (300,), (64, 9))
SYNC_BF16 = 3  # the leaf whose gradient is bf16


def _sync_grads(world):
    """[leaf] -> (world, STEPS, *shape) f32 gradients of mixed magnitude."""
    rng = np.random.default_rng(11)
    return [(rng.standard_normal((world, STEPS) + s) * rng.uniform(1e-3, 3.0, (world, STEPS) + s)
             ).astype(np.float32) for s in SYNC_SHAPES]


def _jax_sync(impl, bucket_bytes, grads):
    """JAX (reduced, residual) per leaf, each (world, STEPS, *shape): one
    compiled step run STEPS times, the state of each rank carried."""
    from jax.sharding import Mesh, PartitionSpec as P

    from kungfu_tpu.compat import shard_map
    from kungfu_tpu.optimizers.sync import all_reduce_gradients as jarg

    world = grads[0].shape[0]
    tx = jarg("dp", impl=impl, compression="int8", bucket_bytes=bucket_bytes)
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))

    def cast(i, g):
        return g.astype(jnp.bfloat16) if i == SYNC_BF16 else g

    def body(gs, state):
        unstack = lambda x: x[0]
        reduced, state = tx.update([cast(i, g[0]) for i, g in enumerate(gs)],
                                   jax.tree.map(unstack, state))
        return [r.astype(jnp.float32)[None] for r in reduced], jax.tree.map(lambda x: x[None],
                                                                              state)

    step = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                             out_specs=(P("dp"), P("dp")), check_vma=False))
    state = tx.init([cast(i, jnp.asarray(g[0, 0])) for i, g in enumerate(grads)])
    state = jax.tree.map(lambda x: jnp.stack([x] * world), state)
    reduced, residual = [[] for _ in grads], [[] for _ in grads]
    for t in range(STEPS):
        out, state = step([jnp.asarray(g[:, t]) for g in grads], state)
        for i in range(len(grads)):
            reduced[i].append(np.asarray(out[i]))
            residual[i].append(np.asarray(state.ef.residual[i]))
    return ([np.stack(r, axis=1) for r in reduced], [np.stack(e, axis=1) for e in residual])


SYNC_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.optimizers import synchronous_sgd

    impl, bucket_bytes, steps, bf16 = eval(sys.argv[3])
    assert distributed.init_distributed(device="cpu") == 2
    d = dist.get_rank()
    data = np.load(sys.argv[1])
    grads = [data[k][d] for k in sorted(data.files, key=int)]
    dtypes = [torch.bfloat16 if i == bf16 else torch.float32 for i in range(len(grads))]
    params = [torch.nn.Parameter(torch.zeros(g.shape[1:], dtype=t)) for g, t in zip(grads, dtypes)]
    # the optimizer carries the state; an inner step of rate 0 leaves the gradients be
    opt = synchronous_sgd(lambda ps: torch.optim.SGD(ps, lr=0.0), impl=impl,
                          bucket_bytes=bucket_bytes, compression="int8")(params)
    out = {}
    for t in range(steps):
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g[t]).to(p.dtype)
        opt.step()
        for i, p in enumerate(params):
            out[f"reduced/{i}/{t}"] = p.grad.float().numpy()
            out[f"residual/{i}/{t}"] = opt.state.ef.residual[i].clone().numpy()
    np.savez(sys.argv[2] + f".{d}.npz", **out)
    distributed.shutdown_distributed()
""")


@pytest.mark.parametrize("impl,bucket_bytes", [("pallas_ring", None), ("pallas_ring", 6000),
                                               ("pmean", 6000)])
def test_compressed_sync_matches_jax(ref, tmp_path, monkeypatch, impl,
                                                  bucket_bytes):
    monkeypatch.setenv("KFT_PALLAS", "interpret")  # the fused ring's Pallas kernels
    grads = _sync_grads(2)
    np.savez(tmp_path / "in.npz", **{str(i): g for i, g in enumerate(grads)})
    procs = start_ranks(SYNC_WORKER, 2, [tmp_path / "in.npz", tmp_path / "out",
                                         repr((impl, bucket_bytes, STEPS, SYNC_BF16))])
    reduced, residual = _jax_sync(impl, bucket_bytes, grads)
    wait_ranks(procs)
    for d in range(2):
        got = np.load(tmp_path / f"out.{d}.npz")
        for i in range(len(grads)):
            for t in range(STEPS):
                where = f"rank {d} leaf {i} step {t + 1}"
                want = reduced[i][d, t]
                if impl == "pallas_ring":
                    np.testing.assert_array_equal(got[f"reduced/{i}/{t}"], want,
                                                  err_msg=f"reduced gradient, {where}")
                else:
                    np.testing.assert_allclose(got[f"reduced/{i}/{t}"], want, rtol=1e-6,
                                               atol=1e-6 * np.abs(want).max(),
                                               err_msg=f"reduced gradient, {where}")
                np.testing.assert_allclose(got[f"residual/{i}/{t}"], residual[i][d, t], rtol=0,
                                           atol=2.0 ** -21 * np.abs(grads[i][d, t]).max(),
                                           err_msg=f"residual, {where}")
    assert all(np.abs(e).max() > 0 for e in residual)


def test_unported_options_raise():
    with pytest.raises(ValueError, match="'dcn', 'ici'"):  # it takes a (dcn, ici) mesh
        synchronous_sgd(adamw(LR), impl="hierarchical")
    with pytest.raises(NotImplementedError):
        synchronous_sgd(adamw(LR), bucket_bytes="auto")
