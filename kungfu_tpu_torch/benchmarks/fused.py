"""Fused computation-collective A/B (counterpart of
kungfu_tpu/benchmarks/fused.py), one process per rank.

    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.benchmarks --bench fused

Two measurements, with the JAX record's keys:

  ops        `all_gather_matmul` (B9) and `matmul_reduce_scatter` (B10)
             at the JAX bench's shape (m, ks, nn = 256, 256, 512, f32)
             against their unfused arms (`all_gather_into_tensor` then
             `torch.matmul`; `torch.matmul` then `reduce_scatter_tensor`)
             and a compute-only control (the same product on a resident
             weight), each row with `scaling.step_attribution` of both
             schedules against the control
  fsdp_step  a tiny FSDP transformer step (2 layers, d_model 64 in 4 heads,
             flash attention on a card, full on the CPU, f32), `FSDPTrainer(dma_collectives=True)` (the
             unshard and the gradient reduce-scatter on B6/B5) against False
             (the same step on torch.distributed), and the same model's
             one-process step as the compute control

Each time is the median over `steps` calls of the host clock around a call
that ends in a device sync, on every rank at once; the record keeps the
slowest rank's.  `effective_impl` is "cuda" where the kernels ran and
"plain" where the plain versions did (CPU tensors); nothing falls back.
The unfused arms use the group's backend: NCCL where every rank has a
card, gloo (through host memory for a card's tensors) where ranks share
one or run on the CPU; `unfused_via` says which.  On one card the ranks'
kernels take turns, so every number there counts that switching.  Rank 0
prints the record and writes it to `out`.
"""
from __future__ import annotations

import json
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import distributed
from ..compat import resolve_device
from ..fsdp import FSDPTrainer
from ..models import TransformerConfig, TransformerLM, lm_loss
from ..ops import collective as C
from ..ops import fused_matmul as FM
from ..plan import make_mesh
from .scaling import step_attribution


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _p50(fn: Callable, steps: int, warmup: int, device: torch.device) -> float:
    """This rank's median ms of `fn` (host clock, ending in a device sync),
    then the slowest rank's (collective)."""
    for _ in range(warmup):
        fn()
    _sync(device)
    times: List[float] = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, statistics.median(times))
    return max(every)


def _unfused_via(device: torch.device) -> str:
    backend = dist.get_backend()
    return f"{backend} through host memory" if device.type == "cuda" and backend == "gloo" \
        else backend


def _op_row(op: str, arms: Dict[str, Callable], n: int, steps: int, warmup: int,
            device: torch.device) -> Dict:
    p50 = {name: _p50(fn, steps, warmup, device) for name, fn in arms.items()}
    effective = "cuda" if device.type == "cuda" else "plain"
    row = {
        "op": op,
        "np": n,
        "fused_ms_p50": p50["fused"],
        "unfused_ms_p50": p50["unfused"],
        "compute_ms_p50": p50["compute"],
        "speedup": p50["unfused"] / p50["fused"] if p50["fused"] > 0 else None,
        "effective_impl": effective,
        "fallback_engaged": False,
        "unfused_via": _unfused_via(device),
        "attribution": {
            "fused": step_attribution(p50["fused"], p50["compute"]),
            "unfused": step_attribution(p50["unfused"], p50["compute"]),
        },
    }
    if dist.get_rank() == 0:
        print(f"RESULT: bench=fused op={op} effective={effective} np={n} "
              f"fused_p50={p50['fused']} ms unfused_p50={p50['unfused']} ms "
              f"wait_frac_fused={row['attribution']['fused']['collective_wait_frac']} "
              f"wait_frac_unfused={row['attribution']['unfused']['collective_wait_frac']}",
              flush=True)
    return row


def _bench_ops(steps: int, warmup: int, device: torch.device) -> List[Dict]:
    n, d = dist.get_world_size(), dist.get_rank()
    rng = np.random.RandomState(0)
    m, ks, nn = 256, 256, 512

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    w = on(rng.randn(n, ks, nn).astype(np.float32)[d])
    x = on(rng.randn(m, n * ks).astype(np.float32))  # the same on every rank
    x2 = on(rng.randn(n, m * n, ks).astype(np.float32)[d])
    gathered = torch.empty(n * ks, nn, device=device)
    scattered = torch.empty(m, nn, device=device)
    resident = torch.cat([w] * n)

    def gather_then_dot():
        C.host_staged(dist.all_gather_into_tensor, gathered, w, None)
        return torch.matmul(x, gathered)

    def dot_then_scatter():
        C.host_staged(dist.reduce_scatter_tensor, scattered, torch.matmul(x2, w), None)
        return scattered

    rows = [_op_row("all_gather_matmul", {
        "fused": lambda: FM.all_gather_matmul(x, w),
        "unfused": gather_then_dot,
        "compute": lambda: torch.matmul(x, resident),
    }, n, steps, warmup, device)]
    rows.append(_op_row("matmul_reduce_scatter", {
        "fused": lambda: FM.matmul_reduce_scatter(x2, w),
        "unfused": dot_then_scatter,
        "compute": lambda: torch.matmul(x2, w),
    }, n, steps, warmup, device))
    return rows


def _bench_fsdp_step(steps: int, warmup: int, device: torch.device) -> Optional[Dict]:
    """The FSDP transformer's step ms, dma_collectives on and off, against
    the same model's step in one process with no communication."""
    n = dist.get_world_size()
    if n < 2:
        return None
    # attention "auto", as the JAX row: the flash kernels on a card (heads of 16)
    cfg = TransformerConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=256,
                            max_len=32, dtype=torch.float32)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2 * n, 32)).astype(np.int64))

    def model():
        return TransformerLM(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(0))

    def loss_fn(m, b):
        return lm_loss(m(b), b)

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3)

    def run(dma: bool) -> float:
        trainer = FSDPTrainer(loss_fn, adam, make_mesh(fsdp=n), dma_collectives=dma,
                              device=device)
        box = [trainer.init(model())]
        batch = trainer.shard_batch(tokens)

        def step():
            box[0], m = trainer.train_step(box[0], batch)
            m["loss"].item()
        return _p50(step, steps, warmup, device)

    local, opt_model = tokens[:2].to(device), model()
    opt = adam(opt_model.parameters())

    def one_step():
        opt.zero_grad()
        loss = loss_fn(opt_model, local)
        loss.backward()
        opt.step()
        loss.item()

    compute_ms = _p50(one_step, steps, warmup, device)
    unfused, fused = run(False), run(True)
    effective = "cuda" if device.type == "cuda" else "plain"
    rec = {
        "np": n,
        "unfused_step_ms_p50": unfused,
        "fused_step_ms_p50": fused,
        "compute_ms_p50": compute_ms,
        "speedup": unfused / fused if fused > 0 else None,
        "effective_impl": effective,
        "fallback_engaged": False,
        "unfused_via": _unfused_via(device),
        "attribution": {
            "fused": step_attribution(fused, compute_ms),
            "unfused": step_attribution(unfused, compute_ms),
        },
    }
    if dist.get_rank() == 0:
        print(f"RESULT: bench=fused sweep=fsdp_step np={n} fused_p50={fused} ms "
              f"unfused_p50={unfused} ms speedup={rec['speedup']}", flush=True)
    return rec


def bench_fused(steps: int = 8, warmup: int = 2, out: Optional[str] = None,
                device=None) -> Optional[Dict]:
    """Run the benchmark on every rank of the group (started by the
    launcher); rank 0 returns, prints and writes the record."""
    device = resolve_device(device)
    n = distributed.init_distributed(device=device.type)
    if n < 2:
        raise RuntimeError("--bench fused needs 2 or more ranks: start it with "
                           "python -m kungfu_tpu_torch.run -np N")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    ops = _bench_ops(steps, warmup, device)
    fsdp_step = _bench_fsdp_step(max(steps // 2, 3), warmup, device)
    speedups = [r["speedup"] for r in ops if r.get("speedup")]
    record = {
        "bench": "fused_matmul",
        "backend": device.type,
        "card": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "np": n,
        "ops": ops,
        "fsdp_step": fsdp_step,
        # the headline ratio; > 1.0 means the fused schedule won
        "fused_speedup_vs_unfused": min(speedups) if speedups else None,
        "fused_fallback_engaged": False,
    }
    rank = dist.get_rank()
    distributed.shutdown_distributed()
    if rank != 0:
        return None
    print(json.dumps(record), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=2)
    return record
