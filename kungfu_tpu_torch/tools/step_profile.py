"""Where the time of one training step goes on the card.

    python -m kungfu_tpu_torch.tools.step_profile [--batch 8] [--steps 2]
    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.tools.step_profile \
        --impl pallas_ring --bucket-mib 256 [--compression int8] [--n-kv-heads 8]

Trains the flagship GPT (models.transformer.FLAGSHIP_GPT, bf16, flash
attention; `--n-kv-heads 8` its GQA variant) with DataParallelTrainer +
synchronous_sgd(adamw(3e-4), impl, bucket_bytes, compression), as
chip_smoke.py's main, ranks and gqa phases do (all build it with
flagship_step), warms up for two steps, then profiles `--steps`
steps with torch.profiler.  Started by the launcher, each rank trains on
its share of the batch of `--batch` and profiles its own process: where
ranks share a card, the others' kernels fill its idle time.
Prints the step time on the host clock, the device time of every kernel
summed by category (the port's flash kernels, matrix products, the
optimizer, everything else), the device's idle share (1 - the union of
kernel intervals / the step's wall time), and the kernels that take the
most device time; the last line is the same as one JSON object.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import distributed
from ..models.transformer import FLAGSHIP_GPT, TransformerConfig, TransformerLM, lm_loss
from ..optimizers import adamw, synchronous_sgd
from ..train import DataParallelTrainer

CATEGORIES = (  # first match wins
    ("flash kernels (port)", re.compile(r"flash_(fwd|bwd)")),
    ("ring kernels (port)", re.compile(r"ring_(fused_)?(rs|ag)_kernel")),
    ("matrix products", re.compile(r"gemm|sm90_|cutlass|xmma|nvjet|cublas", re.I)),
    ("optimizer", re.compile(r"multi_tensor|adam", re.I)),
)


def _category(name: str) -> str:
    for label, pattern in CATEGORIES:
        if pattern.search(name):
            return label
    return "other (elementwise, reductions, copies)"


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def flagship_model(seed: int, device="cuda", n_kv_heads: int = 0):
    """(cfg, model): the bf16 flash-attention flagship GPT (GQA with
    `n_kv_heads` kv heads, MHA when 0) with random weights from `seed`."""
    cfg = TransformerConfig(dtype=torch.bfloat16, attention="flash", n_kv_heads=n_kv_heads,
                            **FLAGSHIP_GPT)
    return cfg, TransformerLM(cfg, device=device,
                              generator=torch.Generator(device=device).manual_seed(seed))


def flagship_step(batch: int, seed: int, device="cuda", impl: str = "pmean",
                  bucket_bytes=None, compression=None, n_kv_heads: int = 0):
    """The flagship GPT training step that chip_smoke.py drives and main()
    profiles: `flagship_model`, DataParallelTrainer +
    synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), impl, bucket_bytes,
    compression), and one random [batch, seq] token batch from `seed + 1`.
    Returns (cfg, trainer, state, tokens)."""
    cfg, model = flagship_model(seed, device, n_kv_heads)
    trainer = DataParallelTrainer(lambda m, b: lm_loss(m(b), b),
                                  synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), impl=impl,
                                                  bucket_bytes=bucket_bytes,
                                                  compression=compression), device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    tokens = trainer.shard_batch(torch.randint(0, cfg.vocab_size, (batch, cfg.max_len),
                                               generator=gen, device=device))
    return cfg, trainer, trainer.init(model), tokens


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="pmean", help="synchronous_sgd's gradient mean")
    ap.add_argument("--bucket-mib", type=int, default=0, help="bucket_bytes in MiB (0: per leaf)")
    ap.add_argument("--compression", default=None,
                    help="synchronous_sgd's gradient wire format (int8, fp8, bf16; none if unset)")
    ap.add_argument("--n-kv-heads", type=int, default=0,
                    help="kv heads of the flagship (8: its GQA variant; 0: MHA)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    world = distributed.init_distributed(device="cuda")
    rank = dist.get_rank() if world > 1 else 0
    cfg, trainer, state, tokens = flagship_step(args.batch, args.seed, impl=args.impl,
                                                bucket_bytes=(args.bucket_mib << 20) or None,
                                                compression=args.compression,
                                                n_kv_heads=args.n_kv_heads)
    per = args.batch // world
    tokens = tokens[rank * per:(rank + 1) * per]
    for _ in range(2):
        state, m = trainer.train_step(state, tokens)
    m["loss"].item()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = trainer.train_step(state, tokens)
        m["loss"].item()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device activity only: kernels and copies, not the annotations the
    # profiler mirrors onto the device timeline (e.g. "Optimizer.step#...")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print("step_profile: the profiler recorded no device activity", file=sys.stderr)
        return 1
    by_cat, by_name = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_cat[_category(e.name)] += us
        by_name[e.name] += us
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    steps = args.steps
    step_ms = wall_us / steps / 1e3
    print(f"[profile] {torch.cuda.get_device_name(0)}, flagship GPT batch {args.batch} x "
          f"{cfg.max_len}, {cfg.kv_heads} kv heads (rank {rank} of {world}, batch {per}, "
          f"impl={args.impl}, compression={args.compression}): step "
          f"{step_ms:.1f} ms on the host clock, this process's device busy "
          f"{busy_us / steps / 1e3:.1f} ms, idle share {1 - busy_us / wall_us:.3f}")
    for label, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}: {us / steps / 1e3:.1f} ms/step "
              f"({us / sum(by_cat.values()):.1%} of device time)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for name, us in top:
        print(f"[profile]   {us / steps / 1e3:8.2f} ms/step  {name[:110]}")
    print(json.dumps({
        "rank": rank, "world": world, "step_ms": step_ms, "device_busy_ms": busy_us / steps / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "categories_ms": {k: v / steps / 1e3 for k, v in by_cat.items()},
        "top_kernels_ms": {k[:110]: v / steps / 1e3 for k, v in top},
    }))
    distributed.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
