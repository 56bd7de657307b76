"""S-SGD across cards: ranks brought up from the KungFu env contract over
NCCL, each training on its batch shard with the flash kernels, against
one process training on the whole batch.

Marked `cuda`; skips without two cards (the check runs in a fixture).
Tolerance: parameters to 1e-5 absolute after three AdamW steps at lr
1e-3, f32 throughout (the same f32 products; the gradient mean is taken
over shards instead of the whole batch, another summation order).
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
    from kungfu_tpu_torch.optimizers import adamw, synchronous_sgd
    from kungfu_tpu_torch.train import DataParallelTrainer

    common, lr, steps, per_rank, world = eval(sys.argv[2])
    assert distributed.init_distributed(device="cuda") == world
    rank = dist.get_rank()
    cfg = tt.TransformerConfig(**common)
    model = tt.TransformerLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(rank))
    trainer = DataParallelTrainer(lambda m, b: tt.lm_loss(m(b), b),
                                  synchronous_sgd(adamw(lr), bucket_bytes=1 << 20),
                                  device="cuda")
    state = trainer.init(model)  # every rank starts from rank 0's weights
    tokens = torch.from_numpy(np.load(sys.argv[1] + ".tokens.npy")).long()
    batch = trainer.shard_batch(tokens[rank * per_rank:(rank + 1) * per_rank])
    for _ in range(steps):
        state, m = trainer.train_step(state, batch)
    assert all(k.launches == steps * cfg.n_layers for k in flash.KERNELS)
    out = {k: v.cpu().numpy() for k, v in trainer.eval_params(state).items()}
    np.savez(sys.argv[1] + f".{rank}.npz", loss=m["loss"].item(), **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    return min(torch.cuda.device_count(), 4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_nccl_ssgd_matches_one_process(cards, tmp_path):
    world = cards
    tokens = np.random.default_rng(0).integers(
        0, COMMON["vocab_size"], (world * PER_RANK, COMMON["max_len"]))
    np.save(tmp_path / "run.tokens.npy", tokens)
    port = _free_port()
    peers = ",".join(f"127.0.0.1:{port + r}" for r in range(world))
    args = repr((COMMON, LR, STEPS, PER_RANK, world))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tmp_path / "run"), args],
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

    cfg = tt.TransformerConfig(**COMMON)
    model = tt.TransformerLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(0))
    trainer = DataParallelTrainer(lambda m, b: tt.lm_loss(m(b), b),
                                  synchronous_sgd(adamw(LR)), device="cuda")
    state = trainer.init(model)
    state, m = trainer.train_steps(state, trainer.shard_batch(torch.from_numpy(tokens).long()),
                                   STEPS)
    for key, want in trainer.eval_params(state).items():
        np.testing.assert_allclose(results[0][key], want.cpu().numpy(), atol=1e-5, err_msg=key)
    assert abs(float(results[0]["loss"]) - m["loss"].item()) < 1e-5
