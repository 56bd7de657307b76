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

Marked `cuda`; skips without a card, and the NCCL case without two (the
check runs in a fixture).
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
