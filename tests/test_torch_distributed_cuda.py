"""S-SGD across ranks: ranks brought up from the KungFu env contract, each
training on its batch shard with the flash kernels.

NCCL (impl="pmean", ranks on cards of their own) against one process
training on the whole batch.  Tolerance: parameters to 1e-5 absolute after
three AdamW steps at lr 1e-3, f32 throughout (the same f32 products; the
gradient mean is taken over shards instead of the whole batch, another
summation order).

The ring kernels (impl="pallas_ring") against impl="pmean" on the same two
ranks, bit for bit: with two ranks every sum is one add of two values,
which is the same in either order, and halving is exact, so the two means
are the same numbers.  The ranks share the one card there is (a gloo
group) or have a card each (NCCL).

FSDPTrainer on 4 ranks (make_mesh(fsdp=4): every parameter chunked 4
ways, gathered through the ring all-gather B6 and its gradient
reduce-scattered through B5; the ranks share the card or have one each)
against one process training on the whole batch: parameters to 1e-5
absolute after three AdamW steps, f32, for the same reason as the NCCL
case (the reduce-scatter sums four shards' gradients in the ring's order).

The plain rings of `ops/collective.py` over NCCL with a card a rank: the
lax-schedule ring all-reduce on the world group and the hierarchical
all-reduce on a 2 x 2 ("dcn", "ici") mesh (a 2-rank ici ring), each equal
to the stacked sum of integer-valued f32 payloads.  Each hop's send and
receive go to NCCL as one batch: sent one by one, the 4-rank ring
deadlocked and the 2-rank one faulted (an illegal memory access).

Ulysses attention over NCCL with a card a rank, at the flagship's heads:
each rank's output and gradients against flash attention over the
gathered sequence (`tools/ulysses_check.against_flash`), to the flash
kernels' bf16 limit of `utils.compare.REL_LIMIT`.

Tensor parallelism over NCCL with a card a rank: MeshTrainer on dp=2 x
tp=2 (the Megatron all-reduces on the card) against one process training
the same weights on the whole batch, 3 SGD steps: the first step's
gradients to 1e-5 of each leaf's largest, parameters and loss to 1e-5.
Each leaf also prints how far apart the two gradients would send Adam's
first step, whose normalization g / (|g| + eps) turns a near-zero
element's summation order into a large part of a step.

Marked `cuda`; skips without a card, and the NCCL cases without two or
four (the check runs in a fixture).
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_ranks import MAX_WORKER_PORT, _free_port_range
from kungfu_tpu_torch.models import transformer as tt
from kungfu_tpu_torch.optimizers import adamw, synchronous_sgd
from kungfu_tpu_torch.train import DataParallelTrainer

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = dict(vocab_size=509, d_model=128, n_layers=2, n_heads=2, d_ff=256, max_len=128,
              rope=True, attention="flash", dtype=torch.float32)
LR, STEPS, PER_RANK = 1e-3, 3, 2

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers import adamw, synchronous_sgd
    from kungfu_tpu_torch.train import DataParallelTrainer

    common, lr, steps, per_rank, world, impl = eval(sys.argv[2])
    assert distributed.init_distributed(device="cuda") == world
    rank = dist.get_rank()
    cfg = tt.TransformerConfig(**common)
    model = tt.TransformerLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(rank))
    trainer = DataParallelTrainer(lambda m, b: tt.lm_loss(m(b), b),
                                  synchronous_sgd(adamw(lr), impl=impl, bucket_bytes=1 << 20),
                                  device="cuda")
    state = trainer.init(model)  # every rank starts from rank 0's weights
    tokens = torch.from_numpy(np.load(sys.argv[1] + ".tokens.npy")).long()
    batch = trainer.shard_batch(tokens[rank * per_rank:(rank + 1) * per_rank])
    for _ in range(steps):
        state, m = trainer.train_step(state, batch)
    mha = (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV)
    assert all(k.launches == steps * cfg.n_layers for k in mha)
    assert flash.FLASH_BWD_DKV_GQA.launches == 0  # the model is MHA
    ring = [RC.RING_RS.launches, RC.RING_AG.launches]
    assert (min(ring) > 0 and ring[0] == ring[1]) if impl == "pallas_ring" else ring == [0, 0]
    assert RC.FUSED_RS.launches == RC.FUSED_AG.launches == 0  # no compression
    out = {k: v.cpu().numpy() for k, v in trainer.eval_params(state).items()}
    np.savez(sys.argv[1] + f".{rank}.npz", loss=m["loss"].item(), **out)
    distributed.shutdown_distributed()
""")


FSDP_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.fsdp import FSDPTrainer
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers import adamw
    from kungfu_tpu_torch.plan import make_mesh

    common, lr, steps, per_rank, world, impl = eval(sys.argv[2])
    assert distributed.init_distributed(device="cuda") == world
    cfg = tt.TransformerConfig(**common)
    model = tt.TransformerLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(0))
    trainer = FSDPTrainer(lambda m, b: tt.lm_loss(m(b), b), adamw(lr), make_mesh(fsdp=world),
                          device="cuda")
    state = trainer.init(model)  # every rank: the same weights, its quarter kept
    leaves = len(trainer._shapes)
    assert all(p.numel() == 0 for p in model.parameters())
    tokens = torch.from_numpy(np.load(sys.argv[1] + ".tokens.npy")).long()
    batch = trainer.shard_batch(tokens)
    for _ in range(steps):
        state, m = trainer.train_step(state, batch)
    # a grouped gather and a grouped reduce-scatter a bucket of parameters
    assert 1 <= len(trainer._buckets) < leaves
    assert RC.RING_AG.launches == RC.RING_RS.launches == steps * len(trainer._buckets)
    assert all(k.launches == steps * cfg.n_layers
               for k in (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV))
    out = {k: v.cpu().numpy() for k, v in trainer.eval_params(state).items()}
    rank = torch.distributed.get_rank()
    np.savez(sys.argv[1] + f".{rank}.npz", loss=m["loss"].item(), **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from kungfu_tpu_torch.ops import _build

    _build.build_all()  # once, before the ranks start
    return torch.cuda.device_count()


def _train_ranks(world, impl, tmp_path, worker=WORKER):
    """Every rank's final parameters and loss, checked to be the same on
    every rank; and the tokens of the whole batch."""
    tokens = np.random.default_rng(0).integers(
        0, COMMON["vocab_size"], (world * PER_RANK, COMMON["max_len"]))
    tmp_path.mkdir(parents=True, exist_ok=True)
    np.save(tmp_path / "run.tokens.npy", tokens)
    port = _free_port_range(world, MAX_WORKER_PORT, ())
    peers = ",".join(f"127.0.0.1:{port + r}" for r in range(world))
    args = repr((COMMON, LR, STEPS, PER_RANK, world, impl))
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(tmp_path / "run"), args],
        env=dict(os.environ, KFT_SELF_SPEC=f"127.0.0.1:{port + r}", KFT_INIT_PEERS=peers,
                 PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    results = [np.load(tmp_path / f"run.{r}.npz") for r in range(world)]
    for res in results[1:]:  # S-SGD keeps the replicas identical, bit for bit
        for key in results[0].files:
            np.testing.assert_array_equal(res[key], results[0][key])
    return results[0], tokens


def _one_process(result, tokens):
    """Hold `result` against one process training on the whole batch."""
    cfg = tt.TransformerConfig(**COMMON)
    model = tt.TransformerLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(0))
    trainer = DataParallelTrainer(lambda m, b: tt.lm_loss(m(b), b),
                                  synchronous_sgd(adamw(LR)), device="cuda")
    state = trainer.init(model)
    state, m = trainer.train_steps(state, trainer.shard_batch(torch.from_numpy(tokens).long()),
                                   STEPS)
    for key, want in trainer.eval_params(state).items():
        np.testing.assert_allclose(result[key], want.cpu().numpy(), atol=1e-5, err_msg=key)
    assert abs(float(result["loss"]) - m["loss"].item()) < 1e-5


def test_nccl_ssgd_matches_one_process(cards, tmp_path):
    if cards < 2:
        pytest.skip("needs two CUDA cards")
    _one_process(*_train_ranks(min(cards, 4), "pmean", tmp_path))


def test_fsdp_on_four_ranks_matches_one_process(cards, tmp_path):
    _one_process(*_train_ranks(4, None, tmp_path, FSDP_WORKER))


def test_pallas_ring_ssgd_matches_pmean(cards, tmp_path):
    ring, _ = _train_ranks(2, "pallas_ring", tmp_path / "ring")
    pmean, _ = _train_ranks(2, "pmean", tmp_path / "pmean")
    for key in pmean.files:
        np.testing.assert_array_equal(ring[key], pmean[key], err_msg=key)


RINGS_WORKER = textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.plan import make_hierarchical_mesh

    assert distributed.init_distributed(device="cuda") == 4
    assert dist.get_backend() == "nccl"
    rank = dist.get_rank()
    mesh = make_hierarchical_mesh(2)
    xs = [torch.randint(-3, 4, (1 << 20,), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(r)).float()
          for r in range(4)]
    want = torch.stack(xs).sum(0)
    assert torch.equal(C.ring_all_reduce(xs[rank]), want)
    assert torch.equal(C.hierarchical_all_reduce(xs[rank], mesh.group("ici"),
                                                 mesh.group("dcn")), want)
    torch.cuda.synchronize()
    distributed.shutdown_distributed()
""")


def _nccl_ranks(worker):
    """Run `worker` on 4 ranks, a card each; fails with a rank's output."""
    port = _free_port_range(4, MAX_WORKER_PORT, ())
    peers = ",".join(f"127.0.0.1:{port + r}" for r in range(4))
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker],
        env=dict(os.environ, KFT_SELF_SPEC=f"127.0.0.1:{port + r}", KFT_INIT_PEERS=peers,
                 PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
        outs.append(out)
    return outs


def test_plain_rings_over_nccl(cards):
    if cards < 4:
        pytest.skip("needs four CUDA cards")
    _nccl_ranks(RINGS_WORKER)


ULYSSES_WORKER = textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.tools import ulysses_check
    from kungfu_tpu_torch.utils.compare import REL_LIMIT

    assert distributed.init_distributed(device="cuda") == 4
    assert dist.get_backend() == "nccl"
    for kv_heads in (16, 8):  # MHA; GQA with 2 kv heads a rank
        errs = ulysses_check.against_flash(None, 2, 8192, 16, kv_heads, 64)
        print(f"rank {dist.get_rank()} kv_heads {kv_heads}: {errs}", flush=True)
        assert max(errs.values()) <= REL_LIMIT[torch.bfloat16], errs
    distributed.shutdown_distributed()
""")


def test_ulysses_over_nccl(cards):
    """Ulysses attention with a card a rank (all_to_all_single on NCCL) at
    the flagship's heads, 16 of 64 (MHA, and 8 kv heads split 2 a rank),
    B=2, L=8192, bf16, causal: each rank's output, dq, dk and dv against
    flash attention over the gathered sequence (tools/ulysses_check, the
    flash kernels' bf16 gate)."""
    if cards < 4:
        pytest.skip("needs four CUDA cards")
    for out in _nccl_ranks(ULYSSES_WORKER):
        print(out)


TP_COMMON = {**COMMON, "vocab_size": 512, "n_heads": 4, "n_kv_heads": 2}
# plain SGD: a gradient's f32 summation order moves the parameters by as
# much; AdamW's normalization makes a near-zero gradient element's order
# a change of a whole step (one element of 32768 moved 2.9e-5 in 3 steps),
# which the test reads from the first step's gradients (ADAM_EPS)
TP_LR = 0.1
ADAM_EPS = 1e-8  # optimizers.adamw's default
TP_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import convert, distributed
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.plan import make_mesh
    from kungfu_tpu_torch.trainer import MeshTrainer

    common, lr, steps = eval(sys.argv[2])
    assert distributed.init_distributed(device="cuda") == 4
    assert dist.get_backend() == "nccl"
    torch.backends.cuda.matmul.allow_tf32 = False
    whole = tt.TransformerLM(tt.TransformerConfig(**common), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(0))
    mesh = make_mesh(dp=2, tp=2)
    model = tt.TransformerLM(tt.TransformerConfig(mesh=mesh, **common), device="cuda")
    model.load_state_dict(convert.shard_state_dict(whole.state_dict(), mesh))
    assert not C._gloo_card(next(model.parameters()), mesh.group("tp"))  # on the card
    trainer = MeshTrainer(lambda m, b: tt.lm_loss_shard(m(b.tokens), b.targets, b.count,
                                                        m.vocab_group),
                          lambda p: torch.optim.SGD(p, lr), mesh, device="cuda")
    state = trainer.init(model)
    tokens = torch.from_numpy(np.load(sys.argv[1] + ".tokens.npy")).long()
    shard = trainer.shard_batch(tokens)
    for step in range(steps):
        state, m = trainer.train_step(state, shard)
        if step == 0:  # the first step's gradients, summed over dp, gathered over tp
            grads = convert.gather_state_dict({n: p.grad for n, p in model.named_parameters()},
                                              mesh)
    # each rank: its 2 of the 4 heads, 1 of the 2 kv heads (B4), every layer and step
    assert all(k.launches == steps * common["n_layers"]
               for k in (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV_GQA))
    params = convert.gather_state_dict(trainer.eval_params(state), mesh)
    if dist.get_rank() == 0:
        np.savez(sys.argv[1] + ".npz", loss=m["loss"].item(),
                 **{k: v.cpu().numpy() for k, v in params.items()},
                 **{"grad." + k: v.cpu().numpy() for k, v in grads.items()})
    distributed.shutdown_distributed()
""")


def _adam_reading(got: np.ndarray, want: np.ndarray) -> str:
    """Where two gradients of a leaf send Adam's first step furthest apart:
    the step is lr * g / (|g| + eps), so the reading is the largest
    |g / (|g| + eps) - g' / (|g'| + eps)| (in units of lr) and the two
    gradients of that element beside the leaf's largest."""
    step = got / (np.abs(got) + ADAM_EPS) - want / (np.abs(want) + ADAM_EPS)
    i = np.unravel_index(np.argmax(np.abs(step)), step.shape)
    return (f"Adam's first step differs by lr x {abs(step[i]):.3g} at {tuple(map(int, i))}, "
            f"gradients {got[i]:.3g} / {want[i]:.3g} (the leaf's largest "
            f"{np.abs(want).max():.3g})")


def test_tensor_parallel_over_nccl(cards, tmp_path):
    """dp=2 x tp=2 with a card a rank: the Megatron all-reduces (attention
    and MLP outputs, the vocab-parallel embedding and cross entropy) on
    NCCL, MeshTrainer 3 SGD steps in f32 (GQA 4/2: one kv head a rank),
    against one process training the same weights on the whole batch:
    the first step's gathered gradients to 1e-5 of each leaf's largest
    (each leaf's reading of Adam's first step printed), the gathered
    parameters and the loss to 1e-5 absolute."""
    if cards < 4:
        pytest.skip("needs four CUDA cards")
    tokens = np.random.default_rng(0).integers(0, TP_COMMON["vocab_size"],
                                               (8, TP_COMMON["max_len"]))
    np.save(tmp_path / "run.tokens.npy", tokens)
    port = _free_port_range(4, MAX_WORKER_PORT, ())
    peers = ",".join(f"127.0.0.1:{port + r}" for r in range(4))
    procs = [subprocess.Popen(
        [sys.executable, "-c", TP_WORKER, str(tmp_path / "run"), repr((TP_COMMON, TP_LR, STEPS))],
        env=dict(os.environ, KFT_SELF_SPEC=f"127.0.0.1:{port + r}", KFT_INIT_PEERS=peers,
                 PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    result = np.load(tmp_path / "run.npz")
    model = tt.TransformerLM(tt.TransformerConfig(**TP_COMMON), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(0))
    trainer = DataParallelTrainer(lambda m, b: tt.lm_loss(m(b), b),
                                  synchronous_sgd(lambda p: torch.optim.SGD(p, TP_LR)),
                                  device="cuda")
    batch = trainer.shard_batch(torch.from_numpy(tokens).long())
    state, m = trainer.train_step(trainer.init(model), batch)
    grads = {n: p.grad.cpu().numpy() for n, p in model.named_parameters()}
    state, m = trainer.train_steps(state, batch, STEPS - 1)
    for key, want in grads.items():
        got = result["grad." + key]
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"{key}: first-step gradient off by {err:.3g} of its largest; "
              f"{_adam_reading(got, want)}")
        assert err <= 1e-5, key
    for key, want in trainer.eval_params(state).items():
        np.testing.assert_allclose(result[key], want.cpu().numpy(), atol=1e-5, err_msg=key)
    assert abs(float(result["loss"]) - m["loss"].item()) < 1e-5
