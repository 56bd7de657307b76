"""The port's adaptive optimizers against the JAX package's.

Two parts, each on gloo ranks of the port (tests/_torch_ranks.py) beside
a CPU mesh of the same size for the JAX package:

* every case of tests/unit/test_optimizers.py's TestSMA, TestAdaptiveSGD,
  TestMonitors and TestInitializer, on 4 ranks, from the same numpy inputs
  (the JAX tests' seeds, 4 rows where they take 8), plus
  noise_adaptive_compression on a bare parameter; one worker runs every
  case once, each test holds its case against the JAX package's.
  Tolerance rtol 1e-5, as those tests use: the same f32 operations,
  summed in another order;
* the trainer: a 2-layer TransformerLM (d_model 64) on 2 ranks against the
  JAX DataParallelTrainer for 3 steps from the same converted weights and
  batches, under SMA(adamw), AdaptiveSGD(sgd) and gossip
  (pair_averaging(sgd, selector="roundrobin")) per replica, the GNS
  monitor over S-SGD(adamw) and noise-driven int8 compression replicated,
  each replica's parameters to 1e-5 (compression: the compressed
  tolerance of test_torch_train.py); and place_state, the optimizers'
  state dicts and eval_model_state.

lm_adamw is held alone, in one process: its schedule at every step
against optax's, and 3 steps against the JAX preset.
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
from kungfu_tpu_torch.optimizers import lm_adamw
from kungfu_tpu_torch.optimizers.presets import warmup_cosine_decay

N = 4  # ranks of the unit cases


@pytest.fixture(scope="module")
def ref():
    with jax_reference() as kf:
        import optax

        from kungfu_tpu import initializer, optimizers
        from kungfu_tpu.compat import shard_map
        from kungfu_tpu.models import transformer
        from kungfu_tpu.train import DataParallelTrainer

        yield kf, optax, optimizers, initializer, shard_map, transformer, DataParallelTrainer


def _mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("dp",))


def _spmd(ref, n, fn, *args):
    from jax.sharding import PartitionSpec as P

    shard_map = ref[4]
    # as the JAX trainer runs its step: optimizer states mix varying and
    # replicated leaves (AdaptiveSGD's cond over Adam's)
    return np.asarray(jax.jit(shard_map(fn, mesh=_mesh(n), in_specs=P("dp"), out_specs=P("dp"),
                                        check_vma=False))(*args))


# -- the unit cases ---------------------------------------------------------

def _unit_inputs():
    same = np.tile(np.arange(4, dtype=np.float32), (N, 1))
    diff = same.copy()
    diff[2] += 1
    return {
        "sma": np.random.RandomState(2).randn(N, 4).astype(np.float32),
        "sma_converge": np.random.RandomState(3).randn(N, 2).astype(np.float32),
        "ada": np.random.RandomState(7).randn(N, 2).astype(np.float32),
        "gns_noisy": np.random.RandomState(8).randn(N, 4096).astype(np.float32) + 0.3,
        "gns_same": np.tile(np.random.RandomState(9).randn(16).astype(np.float32), (N, 1)),
        "var": np.random.RandomState(10).randn(N, 8).astype(np.float32),
        "bcast": np.random.RandomState(11).randn(N, 4).astype(np.float32),
        "same": same, "diff": diff,
        # noise_adaptive_compression: 3 steps of gradients of mixed magnitude
        "nac": (np.random.RandomState(12).randn(N, 3, 1000)
                * np.random.RandomState(13).uniform(1e-3, 3.0, (N, 3, 1000))).astype(np.float32),
        # adaptive_sgd over Adam: each rank's gradients for 3 steps
        "ada_adam": np.random.RandomState(14).randn(N, 3, 6).astype(np.float32),
        "ada_adam_w": np.random.RandomState(15).randn(N, 6).astype(np.float32),
    }


UNIT_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.initializer import broadcast_params, sync_check
    from kungfu_tpu_torch.optimizers import (
        adamw, adaptive_sgd, get_compression_state, get_gradient_variance, get_noise_scale,
        gradient_noise_scale, gradient_variance, noise_adaptive_compression,
        synchronous_averaging, synchronous_sgd)

    n = distributed.init_distributed(device="cpu")
    r = dist.get_rank()
    data = np.load(sys.argv[1])

    def sgd(lr):
        return lambda ps: torch.optim.SGD(ps, lr=lr)

    def run(tx, w0, steps, grad=None):
        w = torch.nn.Parameter(torch.from_numpy(w0).clone())
        opt = tx([w])
        for t in range(steps):
            w.grad = torch.zeros_like(w) if grad is None else torch.from_numpy(grad(t)).clone()
            opt.step()
        return w.detach().numpy().copy(), opt

    out = {}
    out["sma_pull"], _ = run(synchronous_averaging(sgd(0.0), alpha=0.1), data["sma"][r], 1)
    out["sma_converge"], _ = run(synchronous_averaging(sgd(0.0), alpha=0.5),
                                 data["sma_converge"][r], 30)
    for steps in (3, 4):
        out[f"ada_{steps}"], _ = run(adaptive_sgd(sgd(0.0), switch_step=3, alpha=0.0),
                                     data["ada"][r], steps)
    g = data["ada_adam"][r]
    tx = adaptive_sgd(lambda ps: torch.optim.Adam(ps, lr=0.1), switch_step=1)
    out["ada_adam"], _ = run(tx, data["ada_adam_w"][r], 3, lambda t: g[t])
    tx = adaptive_sgd(adamw(0.1), switch_step=1)  # adamw's default decay, 1e-4
    out["ada_adamw"], _ = run(tx, data["ada_adam_w"][r], 3, lambda t: g[t])
    for case in ("gns_noisy", "gns_same"):
        g = data[case][r]
        tx = gradient_noise_scale(synchronous_sgd(sgd(0.1)), local_batch_size=32)
        w, opt = run(tx, np.zeros_like(g), 1, lambda t: g)
        out[case] = get_noise_scale(opt).numpy()
        out[case + "_w"] = w
    g = data["var"][r]
    w, opt = run(gradient_variance(sgd(0.1)), np.zeros_like(g), 1, lambda t: g)
    out["var"] = get_gradient_variance(opt).numpy()
    out["var_w"] = w
    w = torch.from_numpy(data["bcast"][r]).clone()
    broadcast_params(w)
    out["bcast"] = w.numpy()
    out["sync_same"] = np.array(sync_check(torch.from_numpy(data["same"][r])))
    out["sync_diff"] = np.array(sync_check([torch.from_numpy(data["diff"][r])]))
    g = data["nac"][r]
    tx = noise_adaptive_compression(sgd(0.1), local_batch_size=8, compression="int8")
    w, opt = run(tx, np.zeros(g.shape[1:], np.float32), 3, lambda t: g[t])
    st = get_compression_state(opt)
    out["nac_w"], out["nac_gns"], out["nac_compressed"] = w, st.noise_scale.numpy(), st.compressed
    tx = noise_adaptive_compression(sgd(0.1), local_batch_size=8, compression="int8-sr", seed=5)
    out["nac_sr"], _ = run(tx, np.zeros(g.shape[1:], np.float32), 1, lambda t: g[t])
    np.savez(sys.argv[2] + f".{r}.npz", **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def unit(tmp_path_factory):
    """{case: (N, ...) array of every rank's result} from one run of the
    unit cases on N gloo ranks, and their inputs."""
    tmp = tmp_path_factory.mktemp("unit")
    inputs = _unit_inputs()
    np.savez(tmp / "in.npz", **inputs)
    wait_ranks(start_ranks(UNIT_WORKER, N, [tmp / "in.npz", tmp / "out"]))
    outs = [np.load(tmp / f"out.{r}.npz") for r in range(N)]
    return {k: np.stack([o[k] for o in outs]) for k in outs[0].files}, inputs


def _train_jax(ref, tx, w0, steps, grads=None, read=None):
    """Each replica's parameter after `steps` updates of the JAX transform
    (zero gradients unless `grads` gives the replica's at each step); with
    `read`, the metric it reads from the state instead."""
    def body(w, *g):
        w = w[0]
        state = tx.init(w)
        for t in range(steps):
            u, state = tx.update(g[0][0, t] if g else jnp.zeros_like(w), state, w)
            w = w + u
        return (read(state)[None].astype(jnp.float32) if read else w[None])

    args = (w0,) if grads is None else (w0, grads)
    return _spmd(ref, N, body, *args)


def test_sma_pulls_toward_average(ref, unit):
    got, inputs = unit
    opt = ref[2]
    w0 = inputs["sma"]
    want = _train_jax(ref, opt.synchronous_averaging(ref[1].sgd(0.0), alpha=0.1), w0, 1)
    np.testing.assert_allclose(got["sma_pull"], want, rtol=1e-5)
    np.testing.assert_allclose(got["sma_pull"], 0.9 * w0 + 0.1 * w0.mean(0, keepdims=True),
                               rtol=1e-5)


def test_sma_models_converge_over_steps(ref, unit):
    got, inputs = unit
    w0 = inputs["sma_converge"]
    want = _train_jax(ref, ref[2].synchronous_averaging(ref[1].sgd(0.0), alpha=0.5), w0, 30)
    np.testing.assert_allclose(got["sma_converge"], want, rtol=1e-5, atol=1e-7)
    assert got["sma_converge"].std(axis=0).max() < 1e-4
    np.testing.assert_allclose(got["sma_converge"][0], w0.mean(axis=0), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("steps", [3, 4])
def test_adaptive_sgd_switch_unifies_models(ref, unit, steps):
    got, inputs = unit
    w0 = inputs["ada"]
    tx = ref[2].adaptive_sgd(ref[1].sgd(0.0), switch_step=3, alpha=0.0)
    want = _train_jax(ref, tx, w0, steps)
    np.testing.assert_allclose(got[f"ada_{steps}"], want, rtol=1e-5)
    if steps == 3:  # before the switch (alpha=0, lr=0): the models stay apart
        assert got["ada_3"].std(axis=0).max() > 1e-3
    else:  # the switch step ran: every rank took rank 0's model
        np.testing.assert_array_equal(got["ada_4"], np.tile(w0[0], (N, 1)))


def test_adaptive_sgd_keeps_each_replicas_inner_state(ref, unit):
    """Over Adam, the switch broadcasts the parameters only: each rank's
    moments differ, so the replicas part again after it, as in the JAX
    package (whose update at the switch is computed at each replica's own
    parameters, here at rank 0's: Adam's update does not read them)."""
    got, inputs = unit
    g = inputs["ada_adam"]
    tx = ref[2].adaptive_sgd(ref[1].adam(0.1), switch_step=1)
    want = _train_jax(ref, tx, inputs["ada_adam_w"], 3, g)
    np.testing.assert_allclose(got["ada_adam"], want, rtol=1e-5)
    assert got["ada_adam"].std(axis=0).max() > 1e-3 and want.std(axis=0).max() > 1e-3


def test_adaptive_sgd_over_adamw_differs_by_the_decay_at_the_switch(ref, unit):
    """Over AdamW at its default decay wd = 1e-4, the port's switch step
    decays rank 0's parameters p0 where the JAX package decays each
    replica's own p: the two differ by lr * wd * (p - p0) after the switch,
    and each later step decays that difference by (1 - lr * wd).  Held to
    that bound, and to the predicted difference itself."""
    got, inputs = unit
    g, w0 = inputs["ada_adam"], inputs["ada_adam_w"]
    lr, wd = 0.1, 1e-4
    tx = ref[2].adaptive_sgd(ref[1].adamw(lr, weight_decay=wd), switch_step=1)
    want = _train_jax(ref, tx, w0, 3, g)
    before = _train_jax(ref, tx, w0, 1, g)  # each replica's parameters at the switch step
    bound = lr * wd * np.abs(before - before[:1])
    np.testing.assert_array_less(np.abs(got["ada_adamw"] - want), bound + 1e-5 * np.abs(want))
    predicted = lr * wd * (1 - lr * wd) * (before - before[:1])
    assert (np.abs(predicted) > 1e-5 * np.abs(want)).any()  # beyond the tolerance below
    np.testing.assert_allclose(got["ada_adamw"], want + predicted, rtol=1e-5)


@pytest.mark.parametrize("case", ["gns_noisy", "gns_same"])
def test_noise_scale(ref, unit, case):
    got, inputs = unit
    opt = ref[2]
    g = inputs[case]
    tx = opt.gradient_noise_scale(opt.synchronous_sgd(ref[1].sgd(0.1)), local_batch_size=32,
                                  axis_name="dp", axis_size=N)
    gns = _train_jax(ref, tx, np.zeros_like(g), 1, g[:, None], read=opt.get_noise_scale)
    w = _train_jax(ref, tx, np.zeros_like(g), 1, g[:, None])
    # the inner step on the mean, unperturbed: four f32 values summed in
    # another order (a few ulps of the largest where the mean cancels)
    np.testing.assert_allclose(got[case + "_w"], w, rtol=1e-5, atol=1e-6 * np.abs(w).max())
    if case == "gns_noisy":
        np.testing.assert_allclose(got[case], gns, rtol=1e-5)
        assert np.isfinite(got[case]).all() and got[case].mean() > 0
    else:  # identical gradients: no noise
        np.testing.assert_allclose(got[case], gns, atol=1e-4)
        np.testing.assert_allclose(got[case], 0.0, atol=1e-4)


def test_gradient_variance(ref, unit):
    got, inputs = unit
    opt = ref[2]
    g = inputs["var"]
    tx = opt.gradient_variance(ref[1].sgd(0.1), axis_name="dp")
    var = _train_jax(ref, tx, np.zeros_like(g), 1, g[:, None], read=opt.get_gradient_variance)
    np.testing.assert_allclose(got["var"], var, rtol=1e-5)
    want = (g ** 2).sum(axis=1).mean() - (g.mean(axis=0) ** 2).sum()
    np.testing.assert_allclose(got["var"], want, rtol=1e-4)
    # the inner optimizer steps on the local gradients
    np.testing.assert_allclose(got["var_w"], -0.1 * g, rtol=1e-6)


def test_broadcast_params(ref, unit):
    got, inputs = unit
    init = ref[3]
    want = _spmd(ref, N, lambda w: init.broadcast_params(w[0], axis_name="dp")[None],
                 inputs["bcast"])
    np.testing.assert_array_equal(got["bcast"], want)
    np.testing.assert_array_equal(got["bcast"], np.tile(inputs["bcast"][0], (N, 1)))


def test_sync_check(ref, unit):
    got, inputs = unit
    init = ref[3]

    def check(w):
        return _spmd(ref, N, lambda x: init.sync_check(x[0], axis_name="dp")[None]
                     .astype(jnp.int32), w)

    assert got["sync_same"].all() and check(inputs["same"]).all()
    assert not got["sync_diff"].any() and not check(inputs["diff"]).any()


def test_noise_adaptive_compression(ref, unit):
    """int8 (no stochastic rounding: no randomness) over 3 steps: the wire
    is compressed from step 1 (threshold 0), the replicas identical; the
    parameters agree with the JAX package's to the compressed all-reduce's
    f32 accumulation order (1e-6 of the largest, test_torch_compression.py)
    and the noise scale to 1e-5."""
    got, inputs = unit
    opt = ref[2]
    g = inputs["nac"]
    tx = opt.noise_adaptive_compression(ref[1].sgd(0.1), local_batch_size=8, axis_name="dp",
                                        compression="int8")
    w = _train_jax(ref, tx, np.zeros(g.shape[2:], np.float32), 3, g)
    gns = _train_jax(ref, tx, np.zeros(g.shape[2:], np.float32), 3, g,
                     read=lambda s: opt.get_compression_state(s).noise_scale)
    for r in range(1, N):
        np.testing.assert_array_equal(got["nac_w"][r], got["nac_w"][0])
    np.testing.assert_allclose(got["nac_w"], w, rtol=0, atol=1e-6 * np.abs(w).max())
    np.testing.assert_allclose(got["nac_gns"], gns, rtol=1e-5)
    assert got["nac_compressed"].all()


def test_noise_adaptive_compression_stochastic(ref, unit):
    """int8-sr: the two packages draw other random bits, so one step is
    held to the JAX tolerance of a code step a leg (each rank's codes in
    the reduce-scatter, the mean's in the all-gather: at most
    2 * absmax / 127 of the largest block, times the rate 0.1); the
    replicas take the same mean."""
    got, inputs = unit
    opt = ref[2]
    g = inputs["nac"][:, :1]
    tx = opt.noise_adaptive_compression(ref[1].sgd(0.1), local_batch_size=8, axis_name="dp",
                                        compression="int8-sr")
    w = _train_jax(ref, tx, np.zeros(g.shape[2:], np.float32), 1, g)
    exact = -0.1 * g[:, 0].mean(axis=0)
    step = 0.1 * 2 * np.abs(g).max() / 127
    for r in range(N):
        np.testing.assert_array_equal(got["nac_sr"][r], got["nac_sr"][0])
        np.testing.assert_allclose(got["nac_sr"][r], w[r], rtol=0, atol=2 * step)
    np.testing.assert_allclose(got["nac_sr"][0], exact, rtol=0, atol=step)
    assert not np.array_equal(got["nac_sr"][0], exact)  # it did round


# -- lm_adamw -----------------------------------------------------------------

def test_lm_adamw_schedule_matches_optax(ref):
    optax = ref[1]
    for warmup, total, lr in ((2, 10, 1e-2), (5, 40, 3e-4), (1, 3, 1.0)):
        want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total, lr * 0.1)
        got = warmup_cosine_decay(0.0, lr, warmup, total, lr * 0.1)
        for step in range(total + 3):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12,
                                       err_msg=f"step {step}")


def test_lm_adamw_matches_jax(ref):
    """3 steps on a matrix and a vector, gradients large enough to clip on
    the first two: the warmup, the clip, the decay mask, to 1e-5."""
    optax, opt = ref[1], ref[2]
    rng = np.random.default_rng(5)
    p0 = {"w": rng.standard_normal((4, 4)).astype(np.float32),
          "scale": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in p0.items()}
             for s in (3.0, 1.0, 0.05)]
    tx = opt.lm_adamw(1e-2, warmup_steps=2, total_steps=10)
    state, p = tx.init(p0), {k: jnp.asarray(v) for k, v in p0.items()}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    torch_opt = lm_adamw(1e-2, warmup_steps=2, total_steps=10)(params.values())
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, upd)
        for k, t in params.items():
            t.grad = torch.from_numpy(g[k].copy())
        torch_opt.step()
        for k, t in params.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(p[k]), rtol=0, atol=1e-5)
    assert torch_opt.state == 3
    assert not np.allclose(params["w"].detach().numpy(), p0["w"])


# -- the trainer ----------------------------------------------------------------

COMMON = dict(vocab_size=61, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_len=16,
              rope=True, attention="flash", flash_block_q=8, flash_block_k=8)
LR, SGD_LR, STEPS, PER_RANK, WORLD = 1e-3, 0.1, 3, 2, 2

TRAIN_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import convert, distributed, variables as V
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.optimizers import (
        adamw, adaptive_sgd, get_compression_state, get_noise_scale, gradient_noise_scale,
        noise_adaptive_compression, pair_averaging, synchronous_averaging, synchronous_sgd)
    from kungfu_tpu_torch.policy import BasePolicy
    from kungfu_tpu_torch.train import DataParallelTrainer

    common, lr, sgd_lr, steps, per_rank, kind = eval(sys.argv[3])
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
    world = distributed.init_distributed(device="cpu")
    rank = dist.get_rank()
    cfg = tt.TransformerConfig(dtype=torch.float32, **common)
    tokens = torch.from_numpy(data["tokens"]).long()
    batch = tokens[rank * per_rank:(rank + 1) * per_rank]

    def model(snapshot=True):
        m = tt.TransformerLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(100 + rank))
        if snapshot:
            m.load_state_dict(convert.params_from_flax(tree, cfg))
        return m

    def loss_fn(m, b):
        return tt.lm_loss(m(b), b)

    def aux_loss_fn(m, ms, b):
        loss = tt.lm_loss(m(b), b)
        return loss, {"count": ms["count"] + 1, "ema": 0.5 * ms["ema"] + loss.detach()}

    sync = synchronous_sgd(adamw(lr, b1=0.9, b2=0.95))
    txs = {
        "sma": (synchronous_averaging(adamw(lr, b1=0.9, b2=0.95)), True),
        "adaptive": (adaptive_sgd(lambda ps: torch.optim.SGD(ps, lr=sgd_lr), switch_step=1),
                     True),
        "gns": (gradient_noise_scale(sync, local_batch_size=per_rank), False),
        "nac": (noise_adaptive_compression(adamw(lr, b1=0.9, b2=0.95), local_batch_size=per_rank,
                                           compression="int8"), False),
        "gossip": (pair_averaging(lambda ps: torch.optim.SGD(ps, lr=sgd_lr),
                                  selector="roundrobin"), True),
    }
    out = {}

    class Recorder(BasePolicy):
        def __init__(self):
            self.events = []

        def before_step(self):
            self.events.append("bs")

        def after_step(self, metrics=None):
            self.events.append("as")

    if kind == "restore":
        # per replica with model_state: rank 0's snapshot starts every replica
        trainer = DataParallelTrainer(aux_loss_fn, txs["sma"][0], per_replica_params=True,
                                      has_aux=True, device="cpu")
        ms = {"count": torch.tensor(0), "ema": torch.tensor(0.0)}
        state = trainer.place_state(model(snapshot=rank == 0), model_state=ms)
        for _ in range(steps):
            state, m = trainer.train_step(state, batch)
        out["count"] = trainer.eval_model_state(state)["count"].numpy()
        out["ema"] = trainer.eval_model_state(state)["ema"].numpy()
        for bad in (trainer.eval_params, trainer.eval_model_state):
            try:
                bad(state, replica=1)
            except ValueError:
                continue
            raise AssertionError(f"{bad.__name__}(replica=1) did not raise")
        out.update(trainer.eval_params(state))
        # the GNS monitor over S-SGD(adamw), stopped after 2 steps and
        # restored from its parameters and optimizer state dict, against 3
        # steps in one go: bit for bit
        gns = DataParallelTrainer(loss_fn, txs["gns"][0], device="cpu")
        whole = gns.init(model())
        for _ in range(steps):
            whole, _ = gns.train_step(whole, batch)
        first = gns.init(model())
        for _ in range(steps - 1):
            first, _ = gns.train_step(first, batch)
        saved = {k: v.clone() for k, v in gns.eval_params(first).items()}
        opt_sd = first.opt_state.state_dict()
        again = model(snapshot=False)
        again.load_state_dict(saved)
        restored = gns.place_state(again, opt_sd, step=steps - 1)
        restored, _ = gns.train_step(restored, batch)
        assert restored.step == steps
        for k, v in gns.eval_params(whole).items():
            assert torch.equal(v, gns.eval_params(restored)[k]), k
        assert torch.equal(get_noise_scale(whole.opt_state), get_noise_scale(restored.opt_state))
    else:
        tx, per_replica = txs[kind]
        trainer = DataParallelTrainer(loss_fn, tx, per_replica_params=per_replica, device="cpu")
        state = trainer.init(model())
        opt = state.opt_state  # the same optimizer from step to step
        losses, metric = [], []

        class Reader(Recorder):
            def after_step(self, metrics=None):
                super().after_step(metrics)
                losses.append(metrics["loss"].item())
                if kind == "gns":
                    metric.append(get_noise_scale(opt).item())
                elif kind == "nac":
                    st = get_compression_state(opt)
                    metric.append([st.noise_scale.item(), float(st.compressed)])

        policy = Reader()
        state, result = trainer.fit(state, iter(lambda: batch, None), steps, policies=[policy])
        assert policy.events == ["bs", "as"] * steps, policy.events
        assert V.get_variable(V.TRAINED_SAMPLES) == steps * per_rank * world
        assert result["samples_per_sec"] > 0
        out["losses"], out["metric"] = np.array(losses), np.array(metric)
        out.update(trainer.eval_params(state))
    np.savez(sys.argv[2] + f".{rank}.npz", **out)
    distributed.shutdown_distributed()
""")


def _jax_train(ref, kind, tokens, init_params):
    """(losses, per-step metric, {replica: final params}) of the JAX
    trainer on a WORLD-device mesh."""
    _, optax, opt, _, _, jt, JTrainer = ref
    cfg = jt.TransformerConfig(dtype=jnp.float32, **COMMON)
    model = jt.TransformerLM(cfg)
    adam = optax.adamw(LR, b1=0.9, b2=0.95)
    txs = {
        "sma": (opt.synchronous_averaging(adam), True),
        "adaptive": (opt.adaptive_sgd(optax.sgd(SGD_LR), switch_step=1), True),
        "gns": (opt.gradient_noise_scale(opt.synchronous_sgd(adam), local_batch_size=PER_RANK),
                False),
        "nac": (opt.noise_adaptive_compression(adam, local_batch_size=PER_RANK,
                                               compression="int8"), False),
        "gossip": (opt.pair_averaging(optax.sgd(SGD_LR), selector="roundrobin"), True),
    }
    tx, per_replica = txs[kind]

    def loss_fn(p, batch):
        return jt.lm_loss(model.apply({"params": p}, batch), batch)

    trainer = JTrainer(loss_fn, tx, mesh=_mesh(WORLD), per_replica_params=per_replica)
    state = trainer.init(init_params)
    batch = trainer.shard_batch(jnp.asarray(tokens))
    losses, metric = [], []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
        if kind == "gns":
            metric.append(float(opt.get_noise_scale(state.opt_state)))
        elif kind == "nac":
            st = opt.get_compression_state(state.opt_state)
            metric.append([float(st.noise_scale), float(st.compressed)])
    params = {r: jax.tree.map(lambda x: np.asarray(x[r]) if per_replica else np.asarray(x),
                              state.params) for r in range(WORLD)}
    return np.array(losses), np.array(metric), params


def _gloo_train(ref, tmp_path, kind):
    """(JAX init params, tokens, every rank's npz) of TRAIN_WORKER."""
    jt = ref[5]
    cfg = jt.TransformerConfig(dtype=jnp.float32, **COMMON)
    tokens = np.random.default_rng(21).integers(0, COMMON["vocab_size"],
                                                (WORLD * PER_RANK, COMMON["max_len"]))
    tokens = tokens.astype(np.int32)
    params = jax.tree.map(np.asarray, jt.TransformerLM(cfg).init(
        jax.random.PRNGKey(3), jnp.asarray(tokens[:1]))["params"])
    import flax.linen as nn

    params = nn.meta.unbox(params)
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): v
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "in.npz", tokens=tokens, **flat)
    procs = start_ranks(TRAIN_WORKER, WORLD, [tmp_path / "in.npz", tmp_path / "out",
                                              repr((COMMON, LR, SGD_LR, STEPS, PER_RANK, kind))])
    return params, tokens, procs


def _replica(npz):
    return {k: torch.from_numpy(npz[k]) for k in npz.files
            if k not in ("losses", "metric", "count", "ema")}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_replica_close(got, want, what):
    """Each parameter to 1e-5, as test_torch_train.py holds S-SGD(adamw).
    Where each replica's AdamW steps on its own local gradient (SMA), an
    element whose gradient nearly cancels (|g| near Adam's eps, its f32
    sum order-sensitive) may move by up to the 2 * LR a sign flip makes
    each step: held to 1e-5 on all but 0.1% of the elements, every one
    within 2 * LR * STEPS."""
    diff = np.concatenate([np.abs(got[k] - v).ravel() for k, v in want.items()])
    assert diff.max() <= 2 * LR * STEPS, what
    assert (diff > 1e-5).mean() < 1e-3, f"{what}: {(diff > 1e-5).sum()} of {diff.size}"


@pytest.mark.parametrize("kind", ["sma", "adaptive", "gns", "nac", "gossip"])
def test_trainer_steps_match_jax(ref, tmp_path, kind):
    """3 steps of fit (a recording policy) on 2 gloo ranks against the JAX
    trainer's train_step.  Losses to 2e-5 and each replica's parameters to
    1e-5, as in test_torch_train.py (SMA: `_assert_replica_close`; gossip
    to rtol 1e-5: the port's `mixed + u` and the JAX package's
    `params + (u + (mixed - params))` round apart in the last bit); the
    noise scale to 1e-4 relative (a difference of squared norms of two f32
    sums in other orders).  int8 compression: the compressed tolerance of
    test_torch_train.py (transposed kernels block other elements: up to a
    code step); the wire each step takes (compressed at step 1, then the
    noise scale turns negative and both packages take the full-precision
    mean) equal, the noise scale to 10% (the estimator's difference of
    squared norms at b = 2, B = 4 magnifies the code-step differences of
    step 1's mean: 1-4% on these inputs)."""
    init, tokens, procs = _gloo_train(ref, tmp_path, kind)
    losses_ref, metric_ref, final_ref = _jax_train(ref, kind, tokens, init)
    wait_ranks(procs)
    res = [np.load(tmp_path / f"out.{r}.npz") for r in range(WORLD)]
    cfg = tt.TransformerConfig(dtype=torch.float32, **COMMON)
    got = {r: _leaves(convert.params_to_flax(_replica(res[r]), cfg)) for r in range(WORLD)}
    want = {r: _leaves(final_ref[r]) for r in range(WORLD)}
    for r in range(WORLD):
        np.testing.assert_array_equal(res[r]["losses"], res[0]["losses"])
    if kind in ("sma", "gossip"):  # each replica trained on its own batch
        assert any(not np.array_equal(got[1][k], got[0][k]) for k in got[0])
    else:  # adaptive: from the switch on; the replicated ones always
        for k in got[0]:
            np.testing.assert_array_equal(got[1][k], got[0][k], err_msg=k)
    if kind == "nac":
        np.testing.assert_allclose(res[0]["losses"][0], losses_ref[0], atol=2e-5)
        np.testing.assert_allclose(res[0]["losses"], losses_ref, atol=3e-4)
        diff = np.concatenate([np.abs(got[0][k] - v).ravel() for k, v in want[0].items()])
        assert diff.max() <= 2 * LR * STEPS
        assert (diff > 1e-4).mean() < 0.10
        np.testing.assert_array_equal(res[0]["metric"][:, 1], metric_ref[:, 1])
        assert res[0]["metric"][0, 1] == 1  # compressed at step 1 (threshold 0)
        np.testing.assert_allclose(res[0]["metric"][:, 0], metric_ref[:, 0], rtol=0.1)
        return
    np.testing.assert_allclose(res[0]["losses"], losses_ref, atol=2e-5)
    for r in range(WORLD):
        if kind == "sma":
            _assert_replica_close(got[r], want[r], f"replica {r}")
            continue
        if kind == "gossip":  # mixed + u against params + (u + (mixed - params))
            for k, v in want[r].items():
                np.testing.assert_allclose(got[r][k], v, rtol=1e-5, atol=1e-7,
                                           err_msg=f"replica {r} {k}")
            continue
        for k, v in want[r].items():
            np.testing.assert_allclose(got[r][k], v, rtol=0, atol=1e-5,
                                       err_msg=f"replica {r} {k}")
    if kind == "gns":
        for r in range(WORLD):
            np.testing.assert_allclose(res[r]["metric"], metric_ref, rtol=1e-4)


def test_place_state_and_eval_model_state(ref, tmp_path):
    """Per replica with has_aux: place_state starts both replicas from
    rank 0's snapshot (rank 1 was given other weights), SMA(adamw) trains
    3 steps, each replica's parameters against the JAX trainer's
    place_state of the snapshot (`_assert_replica_close`); model_state is each replica's
    own (not averaged), eval_model_state and eval_params refuse another
    replica; a restored optimizer state dict continues bit for bit (in
    the worker)."""
    init, tokens, procs = _gloo_train(ref, tmp_path, "restore")
    _, optax, opt, _, _, jt, JTrainer = ref
    cfg = jt.TransformerConfig(dtype=jnp.float32, **COMMON)
    model = jt.TransformerLM(cfg)

    def loss_fn(p, ms, batch):
        loss = jt.lm_loss(model.apply({"params": p}, batch), batch)
        return loss, {"count": ms["count"] + 1, "ema": 0.5 * ms["ema"] + loss}

    tx = opt.synchronous_averaging(optax.adamw(LR, b1=0.9, b2=0.95))
    trainer = JTrainer(loss_fn, tx, mesh=_mesh(WORLD), per_replica_params=True, has_aux=True)
    state = trainer.place_state(init, tx.init(init),
                                model_state={"count": jnp.int32(0), "ema": jnp.float32(0)})
    batch = trainer.shard_batch(jnp.asarray(tokens))
    for _ in range(STEPS):
        state, _ = trainer.train_step(state, batch)
    wait_ranks(procs)
    res = [np.load(tmp_path / f"out.{r}.npz") for r in range(WORLD)]
    tcfg = tt.TransformerConfig(dtype=torch.float32, **COMMON)
    for r in range(WORLD):
        ms = trainer.eval_model_state(state, replica=r)
        assert int(res[r]["count"]) == int(ms["count"]) == STEPS
        np.testing.assert_allclose(res[r]["ema"], np.asarray(ms["ema"]), rtol=1e-5)
        got = _leaves(convert.params_to_flax(_replica(res[r]), tcfg))
        _assert_replica_close(got, _leaves(trainer.eval_params(state, replica=r)),
                              f"replica {r}")
    assert res[0]["ema"] != res[1]["ema"]  # each replica's own losses
