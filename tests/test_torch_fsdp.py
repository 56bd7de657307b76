"""FSDP training: the port's FSDPTrainer against the JAX package's.

The JAX side is `kungfu_tpu.fsdp.FSDPTrainer(dma_collectives=True)` on 4
virtual CPU devices under the Pallas interpreter (KFT_PALLAS=interpret:
the DMA gather/scatter pair rides the interpreted ring kernels), on
`make_mesh(fsdp=4)` and `make_mesh(dp=2, fsdp=2)`, the latter also with
int8 on the dp leg.  The port runs the same 2-layer f32 TransformerLM
(vocab 256, d_model 64, 4 heads, d_ff 256, length 32), from the JAX
weights converted by `convert.py`, on 4 gloo ranks in subprocesses: the
same meshes, `dma_all_gather` on the plain ring (the kernels' plain
version), 3 Adam steps on the same 8 sequences.  The same ranks also run
the port's own variants: the gather on torch.distributed
(`dma_collectives=False`), `remat=True`, `train_steps(3)`, a restore
through `place_state` after one step, bucketed dp legs, and the port's
DataParallelTrainer on the same data, with Adam and with SGD (whose step,
unlike Adam's, shows a gradient summed where it should be averaged).
The trainer gathers and reduce-scatters a bucket of parameters at a time
(`bucket_plan`); a trainer that runs the DMA pair a parameter at a time
must train the same bits, and the flagship's 195 parameters must make the
plan's 12 buckets (shapes only, FakeTensorMode).

Tolerances, with their reasons:
  losses 2e-5 absolute, parameters 1e-5: both sides sum the same f32
      products in other orders (a flax weight is (in, out), torch's (out,
      in), so a weight's flat chunk holds other elements in the two
      packages and the ring reduce-scatter adds each element in another
      order); Adam's normalisation can magnify that only for gradients
      near zero (readings up to 5e-7 for the losses and 3e-7 for the
      parameters)
  int8 on the dp leg: losses 2e-4; parameters 2e-4 for at least 95% of
      every leaf's elements and 2 x steps x lr (6e-3) for all: the
      quantization blocks of a chunk hold other elements in the two
      layouts, so dense weights' gradients differ by up to a code step
      (ROADMAP D), and where a gradient is near zero Adam turns that into
      a learning-rate-sized step of either sign (readings: 3.1e-3 at most,
      past 2e-4 on up to 3.4% of a leaf)
  no tolerance where the arithmetic is the same: remat, train_steps, the
      restore and the DMA pair a parameter must equal the plain run bit
      for bit.
"""
from __future__ import annotations

import os
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch import convert
from kungfu_tpu_torch.fsdp import FSDPTrainer, _chunk, _unchunk
from kungfu_tpu_torch.models import transformer as tt
from kungfu_tpu_torch.plan import mesh as pm

COMMON = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=256, max_len=32,
              attention="full")
LR, STEPS, BATCH, RANKS = 1e-3, 3, 8, 4
JAX_MESHES = {"fsdp4": (dict(fsdp=4), None), "dp2-fsdp2": (dict(dp=2, fsdp=2), None),
              "dp2-fsdp2-int8": (dict(dp=2, fsdp=2), "int8")}
# (loss atol, parameter atol, share of a leaf's elements allowed past it)
TOL = {"fsdp4": (2e-5, 1e-5, 0.0), "dp2-fsdp2": (2e-5, 1e-5, 0.0),
       "dp2-fsdp2-int8": (2e-4, 2e-4, 0.05)}
ADAM_BOUND = 2 * STEPS * LR  # two runs' Adam updates of opposite signs, every step


def _tokens():
    rng = np.random.default_rng(5)
    return rng.integers(0, COMMON["vocab_size"], (BATCH, COMMON["max_len"])).astype(np.int32)


def _flat(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from kungfu_tpu_torch import convert, distributed
    from kungfu_tpu_torch.fsdp import FSDPTrainer
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.ops.fused_matmul import dma_all_gather
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.plan import make_mesh
    from kungfu_tpu_torch.train import DataParallelTrainer

    path, common, lr, steps = sys.argv[1], *map(eval, sys.argv[2:])
    data = np.load(path + ".in.npz")
    tree = {}
    for key in data.files:
        if key != "tokens":
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    tokens = torch.from_numpy(data["tokens"]).long()
    rank = distributed.init_distributed(device="cpu") and torch.distributed.get_rank()
    cfg = tt.TransformerConfig(dtype=torch.float32, **common)

    def model():
        m = tt.TransformerLM(cfg, device="cpu")
        m.load_state_dict(convert.params_from_flax(tree, cfg))
        return m

    def loss_fn(m, b):
        return tt.lm_loss(m(b), b)

    def tx(params):
        return torch.optim.Adam(params, lr=lr)

    def sgd(params):  # unlike Adam's, its step scales with the gradient
        return torch.optim.SGD(params, lr=0.5)

    out = {}

    def save(name, losses, params):
        out[f"{name}/losses"] = np.array(losses)
        for k, v in params.items():
            out[f"{name}/p/{k}"] = v.numpy()

    class PerLeaf(FSDPTrainer):  # the DMA pair a parameter: no buckets
        def _gather(self, chunks):
            return [dma_all_gather(c, self.fsdp_group) for c in chunks]

    def run(name, mesh, n=steps, opt=tx, cls=FSDPTrainer, **kw):
        trainer = cls(loss_fn, opt, make_mesh(**mesh), device="cpu", **kw)
        state = trainer.init(model())
        batch = trainer.shard_batch(tokens)
        losses = []
        for _ in range(n):
            state, m = trainer.train_step(state, batch)
            losses.append(m["loss"].item())
        save(name, losses, trainer.eval_params(state))
        return trainer, state, batch

    variants = {
        "fsdp4": (dict(fsdp=4), {}),
        "dp2-fsdp2": (dict(dp=2, fsdp=2), {}),
        "dp2-fsdp2-int8": (dict(dp=2, fsdp=2), dict(compression="int8")),
        "fsdp4-lib": (dict(fsdp=4), dict(dma_collectives=False)),
        "fsdp4-remat": (dict(fsdp=4), dict(remat=True)),
        "dp2-fsdp2-buckets": (dict(dp=2, fsdp=2), dict(bucket_bytes=40000)),
        "fsdp4-sgd": (dict(fsdp=4), dict(opt=sgd)),
        "dp2-fsdp2-sgd": (dict(dp=2, fsdp=2), dict(opt=sgd)),
        "fsdp4-per-leaf": (dict(fsdp=4), dict(cls=PerLeaf)),
        "dp2-fsdp2-per-leaf": (dict(dp=2, fsdp=2), dict(cls=PerLeaf)),
    }
    for name, (mesh, kw) in variants.items():
        trainer, state, batch = run(name, mesh, **kw)
        if name == "fsdp4":  # what a rank holds
            out["held/chunks"] = np.array([c.numel() for c in state.params.values()])
            out["held/full"] = np.array([int(np.prod(s)) for s in trainer._shapes.values()])
            out["held/module"] = np.array([p.numel() for p in trainer._module.parameters()])
            out["held/opt"] = np.array([v.numel() for p in state.params.values()
                                        for v in state.opt_state.state[p].values()
                                        if v.ndim >= 1])
            out["held/rows"] = batch.numpy()
            out["held/buckets"] = np.array(trainer._buckets)

    trainer = FSDPTrainer(loss_fn, tx, make_mesh(fsdp=4), device="cpu")
    state = trainer.init(model())
    batch = trainer.shard_batch(tokens)
    state, m = trainer.train_steps(state, batch, steps)
    assert state.step == steps
    save("fsdp4-train_steps", [m["loss"].item()], trainer.eval_params(state))

    trainer = FSDPTrainer(loss_fn, tx, make_mesh(fsdp=4), device="cpu")
    state = trainer.init(model())
    state, m = trainer.train_step(state, batch)
    params, opt_full = trainer.eval_params(state), trainer.eval_opt_state(state)
    again = FSDPTrainer(loss_fn, tx, make_mesh(fsdp=4), device="cpu")
    again.init(model())
    state = again.place_state(params, opt_full, step=1)
    losses = [m["loss"].item()]
    for _ in range(steps - 1):
        state, m = again.train_step(state, batch)
        losses.append(m["loss"].item())
    assert state.step == steps
    save("fsdp4-restored", losses, again.eval_params(state))

    for name, opt in (("dp4", tx), ("dp4-sgd", sgd)):
        dp = DataParallelTrainer(loss_fn, synchronous_sgd(opt), device="cpu")
        state = dp.init(model())
        per = tokens.shape[0] // 4
        batch = dp.shard_batch(tokens[rank * per:(rank + 1) * per])
        losses = []
        for _ in range(steps):
            state, m = dp.train_step(state, batch)
            losses.append(m["loss"].item())
        save(name, losses, dp.eval_params(state))
    np.savez(path + f".{rank}.npz", **out)
    distributed.shutdown_distributed()
""")


def _jax_runs(params, model, tokens):
    """{mesh name: (losses, final params)} of the JAX FSDPTrainer."""
    import optax

    from kungfu_tpu.fsdp import FSDPTrainer as JFSDPTrainer
    from kungfu_tpu.models import transformer as jt
    from kungfu_tpu.plan import make_mesh

    def loss_fn(p, batch):
        return jt.lm_loss(model.apply({"params": p}, batch), batch)

    out = {}
    for name, (sizes, compression) in JAX_MESHES.items():
        trainer = JFSDPTrainer(loss_fn, optax.adam(LR),
                               mesh=make_mesh(devices=jax.devices()[:RANKS], **sizes),
                               compression=compression, dma_collectives=True)
        state = trainer.init(params)
        batch = trainer.shard_batch(jnp.asarray(tokens))
        losses = []
        for _ in range(STEPS):
            state, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
        out[name] = (losses, trainer.eval_params(state))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, [per-rank npz]): the port's ranks run while the JAX
    trainers do."""
    tmp = tmp_path_factory.mktemp("fsdp")
    old = os.environ.get("KFT_PALLAS")
    os.environ["KFT_PALLAS"] = "interpret"
    try:
        with jax_reference():
            import flax.linen as nn

            from kungfu_tpu.models import transformer as jt

            model = jt.TransformerLM(jt.TransformerConfig(dtype=jnp.float32, **COMMON))
            tokens = _tokens()
            params = nn.meta.unbox(jax.jit(model.init)(jax.random.PRNGKey(2),
                                                       jnp.asarray(tokens[:1]))["params"])
            np.savez(tmp / "run.in.npz", tokens=tokens, **_flat(params))
            procs = start_ranks(WORKER, RANKS, [tmp / "run", repr(COMMON), repr(LR),
                                                repr(STEPS)])
            try:
                ref = _jax_runs(params, model, tokens)
            finally:
                outs = wait_ranks(procs, timeout=600)
    finally:
        if old is None:
            del os.environ["KFT_PALLAS"]
        else:
            os.environ["KFT_PALLAS"] = old
    assert outs
    return ref, [np.load(tmp / f"run.{r}.npz") for r in range(RANKS)]


def _params(res, name):
    prefix = f"{name}/p/"
    return {k[len(prefix):]: res[k] for k in res.files if k.startswith(prefix)}


def _cfg():
    return tt.TransformerConfig(dtype=torch.float32, **COMMON)


@pytest.mark.parametrize("name", list(JAX_MESHES))
def test_losses_match_jax(runs, name):
    ref, ranks = runs
    atol = TOL[name][0]
    for res in ranks:
        np.testing.assert_allclose(res[f"{name}/losses"], ref[name][0], rtol=0, atol=atol)
    assert ranks[0][f"{name}/losses"][-1] < ranks[0][f"{name}/losses"][0]


@pytest.mark.parametrize("name", list(JAX_MESHES))
def test_params_match_jax(runs, name):
    ref, ranks = runs
    got = convert.params_to_flax({k: torch.from_numpy(v) for k, v in
                                  _params(ranks[0], name).items()}, _cfg())
    atol, share = TOL[name][1:]
    for path, want in jax.tree_util.tree_flatten_with_path(ref[name][1])[0]:
        g = got
        for key in path:
            g = g[key.key]
        where = jax.tree_util.keystr(path)
        diff = np.abs(np.asarray(g) - np.asarray(want))
        assert (diff > atol).mean() <= share, (where, (diff > atol).mean())
        np.testing.assert_allclose(g, want, rtol=0, atol=ADAM_BOUND if share else atol,
                                   err_msg=where)


@pytest.mark.parametrize("name", ["fsdp4", "dp2-fsdp2", "fsdp4-lib"])
def test_every_rank_holds_the_same_full_params(runs, name):
    ranks = runs[1]
    for res in ranks[1:]:
        for k, v in _params(ranks[0], name).items():
            np.testing.assert_array_equal(res[f"{name}/p/{k}"], v)


@pytest.mark.parametrize("name", ["fsdp4-remat", "fsdp4-train_steps", "fsdp4-restored"])
def test_same_arithmetic_is_bit_equal(runs, name):
    """remat gathers again in the backward, train_steps loops the step,
    place_state restores params and Adam's moments after step 1: all
    compute what the plain run does, bit for bit."""
    res = runs[1][0]
    np.testing.assert_array_equal(res[f"{name}/losses"][-1], res["fsdp4/losses"][-1])
    if name != "fsdp4-train_steps":
        np.testing.assert_array_equal(res[f"{name}/losses"], res["fsdp4/losses"])
    want = _params(res, "fsdp4")
    for k, v in _params(res, name).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("name", ["fsdp4", "dp2-fsdp2"])
def test_grouped_step_equals_per_leaf(runs, name):
    """The gathers and reduce-scatters a bucket of parameters at a time
    train the bits of a DMA pair a parameter, on every rank; the 2-layer
    model's 18 parameters make buckets of several."""
    for res in runs[1]:
        np.testing.assert_array_equal(res[f"{name}-per-leaf/losses"], res[f"{name}/losses"])
        want = _params(res, name)
        for k, v in _params(res, f"{name}-per-leaf").items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    buckets = runs[1][0]["held/buckets"]
    leaves = len(runs[1][0]["held/full"])
    assert 1 < len(buckets) < leaves


def _flagship_chunks(n: int):
    """A rank's chunks of the flagship GPT's 195 parameters at fsdp=n, as
    tensors without storage (FakeTensorMode: the shapes, not 1.5 GB)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        cfg = tt.TransformerConfig(**{**tt.FLAGSHIP_GPT, "dtype": torch.bfloat16,
                                      "attention": "flash"})
        model = tt.TransformerLM(cfg, device="cpu")
        return [torch.empty(-(-p.numel() // n), dtype=p.dtype) for p in model.parameters()]


@pytest.mark.parametrize("n", [2, 4])
def test_bucket_plan_of_the_flagship(n):
    """Consecutive parameters in the module's order, every one in exactly
    one bucket, no bucket past the slot of the largest chunk unless it
    holds one parameter, at most the segment table's count; 12 buckets of
    the 195 parameters at fsdp=4 (the embedding, ten of 13-22 parameters,
    the head)."""
    from kungfu_tpu_torch.fsdp import _ring_bytes, bucket_plan
    from kungfu_tpu_torch.ops import ring_collectives as RC

    chunks = _flagship_chunks(n)
    assert len(chunks) == 195
    plan = bucket_plan(chunks)
    assert [i for start, stop in plan for i in range(start, stop)] == list(range(195))
    cap = _ring_bytes(chunks)
    assert cap == -(-chunks[0].numel() * 4 // 4096) * 4096  # the embedding's chunk
    for start, stop in plan:
        assert 1 <= stop - start <= RC.MAX_SEGMENTS
        nbytes = sum(-(-c.numel() * 4 // 16) * 16 for c in chunks[start:stop])
        assert nbytes <= cap or stop - start == 1
    assert plan[0] == (0, 1) and plan[-1] == (194, 195)
    if n == 4:
        assert len(plan) == 12
        assert max(stop - start for start, stop in plan) == 22


@pytest.mark.parametrize("name,other", [("fsdp4-lib", "fsdp4"), ("dp4", "fsdp4"),
                                        ("dp2-fsdp2-buckets", "dp2-fsdp2"),
                                        ("dp2-fsdp2", "fsdp4"), ("fsdp4-sgd", "dp4-sgd"),
                                        ("dp2-fsdp2-sgd", "dp4-sgd")])
def test_matches_other_schedules(runs, name, other):
    """The gather on torch.distributed, the port's DataParallelTrainer, a
    bucketed dp leg and the hybrid mesh all train the same S-SGD steps,
    up to f32 summation order.  Adam's step does not depend on the
    gradients' scale, so the SGD pairs are the ones that hold the mean
    over the fsdp and dp ranks (a sum would take steps 2 or 4 times too
    long)."""
    res = runs[1][0]
    np.testing.assert_allclose(res[f"{name}/losses"], res[f"{other}/losses"], rtol=0,
                               atol=2e-5)
    want = _params(res, other)
    for k, v in _params(res, name).items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-5, err_msg=k)


def test_each_rank_holds_a_quarter(runs):
    """Every parameter's chunk is ceil(size / 4), the module keeps no
    parameter memory, Adam's two moments are chunks too, and each rank
    trains on its own 2 rows of the batch."""
    for r, res in enumerate(runs[1]):
        full, chunks = res["held/full"], res["held/chunks"]
        np.testing.assert_array_equal(chunks, -(-full // 4))
        assert res["held/module"].sum() == 0
        np.testing.assert_array_equal(np.sort(res["held/opt"]), np.sort(np.repeat(chunks, 2)))
        np.testing.assert_array_equal(res["held/rows"], _tokens()[2 * r:2 * r + 2])


@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 3, 4), ()])
def test_chunk_roundtrip(shape):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    c = _chunk(x, 4)
    assert c.shape[0] == 4 and c.shape[1] == -(-max(x.numel(), 1) // 4)
    assert torch.equal(_unchunk(c, tuple(shape)), x)
    assert torch.equal(c.reshape(-1)[x.numel():], torch.zeros(c.numel() - x.numel()))


def test_refusals():
    def loss_fn(m, b):
        return m(b).sum()

    mesh = pm.make_mesh(fsdp=1)
    with pytest.raises(NotImplementedError, match="A.8"):
        FSDPTrainer(loss_fn, None, mesh, analyze=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A.8"):
        FSDPTrainer(loss_fn, None, mesh, bucket_bytes="auto", device="cpu")
    with pytest.raises(ValueError, match="no 'fsdp' axis"):
        FSDPTrainer(loss_fn, None, pm.make_mesh(dp=1), device="cpu")
    with pytest.raises(ValueError, match="name no known axis"):
        FSDPTrainer(loss_fn, None, mesh, compression={"dpp": "int8"}, device="cpu")
    from kungfu_tpu_torch.trainer import MeshTrainer

    fake = pm.Mesh({"fsdp": 2}, 0, {"fsdp": None})
    with pytest.raises(ValueError, match="FSDPTrainer"):
        MeshTrainer(loss_fn, None, fake, device="cpu")


def test_one_rank_trains_like_one_process():
    """fsdp=1 in one process: the chunk is the whole parameter, and three
    Adam steps equal torch.optim.Adam on the module itself, bit for bit."""
    cfg = _cfg()
    tokens = torch.from_numpy(_tokens()).long()

    def model():
        return tt.TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(4))

    trainer = FSDPTrainer(lambda m, b: tt.lm_loss(m(b), b),
                          lambda ps: torch.optim.Adam(ps, lr=LR), device="cpu")
    state = trainer.init(model())
    state, m = trainer.train_steps(state, trainer.shard_batch(tokens), STEPS)
    ref = model()
    opt = torch.optim.Adam(ref.parameters(), lr=LR)
    for _ in range(STEPS):
        opt.zero_grad()
        loss = tt.lm_loss(ref(tokens), tokens)
        loss.backward()
        opt.step()
    assert m["loss"].item() == loss.item()
    got = trainer.eval_params(state)
    for k, v in ref.named_parameters():
        assert torch.equal(got[k], v.detach()), k


def test_one_rank_trains_the_chunked_head_like_one_process():
    """head="hidden" + lm_loss_chunked with dropout from a generator under
    FSDPTrainer (the loss reads the head weight through the module, which
    the trainer swaps for the gathered one) equals torch.optim.Adam on the
    module itself with a generator of the same seed, bit for bit."""
    import dataclasses

    cfg = dataclasses.replace(_cfg(), head="hidden", dropout=0.1)
    tokens = torch.from_numpy(_tokens()).long()

    def model():
        return tt.TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(4))

    def loss_fn(gen):
        return lambda m, b: tt.lm_loss_chunked(m, b, block=100, train=True, generator=gen)

    trainer = FSDPTrainer(loss_fn(torch.Generator().manual_seed(9)),
                          lambda ps: torch.optim.Adam(ps, lr=LR), device="cpu")
    state, m = trainer.train_steps(trainer.init(model()), trainer.shard_batch(tokens), STEPS)
    ref, ref_loss = model(), loss_fn(torch.Generator().manual_seed(9))
    opt = torch.optim.Adam(ref.parameters(), lr=LR)
    for _ in range(STEPS):
        opt.zero_grad()
        loss = ref_loss(ref, tokens)
        loss.backward()
        opt.step()
    assert m["loss"].item() == loss.item()
    got = trainer.eval_params(state)
    for k, v in ref.named_parameters():
        assert torch.equal(got[k], v.detach()), k
