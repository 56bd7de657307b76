"""Where the time of one training step goes on the card.

    python -m kungfu_tpu_torch.tools.step_profile [--batch 8] [--steps 2]
    python -m kungfu_tpu_torch.tools.step_profile --n-heads 8 --head hidden
    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.tools.step_profile \
        --impl pallas_ring --bucket-mib 256 [--compression int8] [--n-kv-heads 8]
    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.tools.step_profile \
        --sp 4 --seq-len 8192 --batch 2 --impl pallas_ring --bucket-mib 256
    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.tools.step_profile \
        --fsdp 4 --batch 8

Trains the flagship GPT (models.transformer.FLAGSHIP_GPT, bf16, flash
attention; `--n-kv-heads 8` its GQA variant; `--n-heads 8` its row of 8
heads of 128; `--head hidden` the chunked head, `lm_loss_chunked`, in
place of the dense head's logits and `lm_loss`) with DataParallelTrainer +
synchronous_sgd(adamw(3e-4), impl, bucket_bytes, compression), as
chip_smoke.py's main, ranks and gqa phases do (all build it with
flagship_step), warms up for two steps, times `--steps` steps, then
profiles `--steps` more with torch.profiler.  Started by the launcher, each rank trains on
its share of the batch of `--batch` and profiles its own process: where
ranks share a card, the others' kernels fill its idle time.  With `--sp
N` the ranks form a mesh of dp = world / N x sp = N and train the
flagship at `--seq-len` positions sequence-parallel (ring attention, or
Ulysses' all_to_all with `--attention ulysses`; MeshTrainer, the gradients
summed with `--impl`), as chip_smoke.py's phases sp and ulysses do
(flagship_sp_step): each rank holds its rows and its chunk of every
sequence.  With `--fsdp N` the ranks form a mesh of dp =
world / N x fsdp = N and train the flagship with FSDPTrainer (every
parameter chunked N ways, gathered through the ring all-gather B6 and its
gradient reduce-scattered through B5), as chip_smoke.py's phase fsdp does
(flagship_fsdp_step): each rank holds its rows of the batch of `--batch`;
`--nccl` gathers and reduce-scatters a parameter at a time on
torch.distributed instead (`dma_collectives=False`, the yardstick).
Prints the step time on the host clock (with and without the profiler),
the peak memory, the device time of every kernel
summed by category (the port's flash kernels, its ring kernels, NCCL,
matrix products, the optimizer, everything else), that of B5-B8, B11,
the EF residual and NCCL's collectives, B11's time that no other kernel overlaps ("B11
exposed": it runs on a side stream under ring attention's flash blocks),
the ring, shift, flash and residual kernels' launches a step, the device's idle
share (1 - the union of
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
from ..models.transformer import (FLAGSHIP_GPT, TransformerConfig, TransformerLM, lm_loss,
                                  lm_loss_chunked, lm_loss_shard, lm_loss_shard_chunked)
from ..compression import error_feedback as EF
from ..fsdp import FSDPTrainer
from ..ops import flash
from ..ops import fused_matmul as FM
from ..ops import ring_collectives as RC
from ..optimizers import adamw, synchronous_sgd
from ..plan import make_mesh
from ..train import DataParallelTrainer
from ..trainer import MeshTrainer

CATEGORIES = (  # first match wins
    ("flash kernels (port)", re.compile(r"flash_(fwd|bwd)")),
    ("ring kernels (port)", re.compile(r"ring_(fused_)?(rs|ag)_kernel|ring_shift_kernel")),
    ("NCCL", re.compile(r"nccl", re.I)),
    ("matrix products", re.compile(r"gemm|sm90_|cutlass|xmma|nvjet|cublas", re.I)),
    ("optimizer", re.compile(r"multi_tensor|adam", re.I)),
)


COLLECTIVES = {"B5": re.compile(r"ring_rs_kernel"), "B6": re.compile(r"ring_ag_kernel"),
               "B7": re.compile(r"ring_fused_rs_kernel"),
               "B8": re.compile(r"ring_fused_ag_kernel"),
               "B11": re.compile(r"ring_shift_kernel"),
               "EF": re.compile(r"ef_residual_kernel"),
               "NCCL reduce-scatter": re.compile(r"nccl.*ReduceScatter", re.I),
               "NCCL all-gather": re.compile(r"nccl.*AllGather", re.I)}


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


def flagship_model(seed: int, device="cuda", n_kv_heads: int = 0, **overrides):
    """(cfg, model): the bf16 flash-attention flagship GPT (GQA with
    `n_kv_heads` kv heads, MHA when 0; `overrides` replace config fields)
    with random weights from `seed`."""
    cfg = TransformerConfig(**{**FLAGSHIP_GPT, "dtype": torch.bfloat16, "attention": "flash",
                               "n_kv_heads": n_kv_heads, **overrides})
    return cfg, TransformerLM(cfg, device=device,
                              generator=torch.Generator(device=device).manual_seed(seed))


def flagship_tokens(cfg: TransformerConfig, batch: int, seed: int, device="cuda"):
    """The random [batch, max_len] token batch of the flagship paths, from `seed + 1`."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, cfg.max_len), generator=gen, device=device)


def lm_step_loss(model, tokens):
    """The next-token loss of a training step: `lm_loss` of the logits, or
    `lm_loss_chunked` for a model with head="hidden"."""
    if model.cfg.head == "hidden":
        return lm_loss_chunked(model, tokens)
    return lm_loss(model(tokens), tokens)


def flagship_step(batch: int, seed: int, device="cuda", impl: str = "pmean",
                  bucket_bytes=None, compression=None, n_kv_heads: int = 0, **overrides):
    """The flagship GPT training step that chip_smoke.py drives and main()
    profiles: `flagship_model` (`overrides` replace config fields, e.g.
    n_heads=8, head="hidden"), DataParallelTrainer(`lm_step_loss`,
    synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), impl, bucket_bytes,
    compression)), and `flagship_tokens`.  Returns (cfg, trainer, state,
    tokens)."""
    cfg, model = flagship_model(seed, device, n_kv_heads, **overrides)
    trainer = DataParallelTrainer(lm_step_loss,
                                  synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), impl=impl,
                                                  bucket_bytes=bucket_bytes,
                                                  compression=compression), device=device)
    tokens = trainer.shard_batch(flagship_tokens(cfg, batch, seed, device))
    return cfg, trainer, trainer.init(model), tokens


def flagship_sp_step(batch: int, seq_len: int, sp: int, seed: int, device="cuda",
                     impl: str = "pallas_ring", bucket_bytes=None, attention: str = "ring",
                     head: str = "dense", n_kv_heads: int = 0):
    """The flagship's sequence-parallel step: the world's ranks as a mesh
    of dp = world / sp x sp, the flagship (GQA with `n_kv_heads`) with
    `max_len=seq_len`, `attention` ("ring" or "ulysses") over the mesh and
    `head`, MeshTrainer(lm_loss_shard, or lm_loss_shard_chunked for
    head="hidden"; adamw(3e-4, b1=0.9, b2=0.95), impl, bucket_bytes), and
    this rank's shard of `flagship_tokens`.  Returns (cfg, trainer, state,
    shard)."""
    mesh = make_mesh(dp=-1, sp=sp)
    cfg, model = flagship_model(seed, device, n_kv_heads=n_kv_heads, attention=attention,
                                mesh=mesh, max_len=seq_len, head=head)
    if head == "hidden":
        def loss(m, b):
            return lm_loss_shard_chunked(m, b.tokens, b.targets, b.count)
    else:
        def loss(m, b):
            return lm_loss_shard(m(b.tokens), b.targets, b.count)
    trainer = MeshTrainer(loss, adamw(3e-4, b1=0.9, b2=0.95), mesh, impl=impl,
                          bucket_bytes=bucket_bytes, device=device)
    shard = trainer.shard_batch(flagship_tokens(cfg, batch, seed, device))
    return cfg, trainer, trainer.init(model), shard


def flagship_fsdp_step(batch: int, fsdp: int, seed: int, device="cuda",
                       dma_collectives: bool = True):
    """The flagship's FSDP step: the world's ranks as a mesh of dp = world
    / fsdp x fsdp, `flagship_model` chunked by FSDPTrainer(lm_loss,
    adamw(3e-4, b1=0.9, b2=0.95), dma_collectives), and this rank's rows
    of the `batch` sequences of `flagship_tokens`.  Returns (cfg, trainer,
    state, rows)."""
    cfg, model = flagship_model(seed, device)
    trainer = FSDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(3e-4, b1=0.9, b2=0.95),
                          make_mesh(dp=-1, fsdp=fsdp), dma_collectives=dma_collectives,
                          device=device)
    state = trainer.init(model)
    rows = trainer.shard_batch(flagship_tokens(cfg, batch, seed, device))
    return cfg, trainer, state, rows


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
    ap.add_argument("--n-heads", type=int, default=FLAGSHIP_GPT["n_heads"],
                    help="query heads of the flagship (16 of 64; 8: its row of heads of 128)")
    ap.add_argument("--head", default="dense", choices=("dense", "hidden"),
                    help="hidden: the chunked head and lm_loss_chunked (lm_loss_shard_chunked "
                    "with --sp)")
    ap.add_argument("--sp", type=int, default=1,
                    help="ranks of a sequence-parallel group (ring attention, MeshTrainer)")
    ap.add_argument("--attention", default="ring", choices=("ring", "ulysses"),
                    help="with --sp: ring attention or Ulysses' all_to_all")
    ap.add_argument("--seq-len", type=int, default=2048, help="positions of a sequence (--sp)")
    ap.add_argument("--fsdp", type=int, default=0,
                    help="ranks of an fsdp group (FSDPTrainer; 0: data parallel)")
    ap.add_argument("--nccl", action="store_true",
                    help="with --fsdp: FSDPTrainer(dma_collectives=False), a gather and a "
                    "reduce-scatter of torch.distributed a parameter (the yardstick)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    world = distributed.init_distributed(device="cuda")
    rank = dist.get_rank() if world > 1 else 0
    bucket_bytes = (args.bucket_mib << 20) or None
    if args.fsdp:
        cfg, trainer, state, tokens = flagship_fsdp_step(args.batch, args.fsdp, args.seed,
                                                         dma_collectives=not args.nccl)
        buckets = len(getattr(trainer, "_buckets", ()))  # a tree without buckets: 0
        shard = f"batch {tokens.shape[0]}, fsdp={args.fsdp}, " + (
            "NCCL a parameter" if args.nccl else f"{buckets or 'no'} buckets")
    elif args.sp > 1:
        cfg, trainer, state, tokens = flagship_sp_step(
            args.batch, args.seq_len, args.sp, args.seed, impl=args.impl,
            bucket_bytes=bucket_bytes, attention=args.attention, head=args.head,
            n_kv_heads=args.n_kv_heads)
        shard = f"batch {tuple(tokens.tokens.shape)}, sp={args.sp} ({args.attention})"
    else:
        cfg, trainer, state, tokens = flagship_step(args.batch, args.seed, impl=args.impl,
                                                    bucket_bytes=bucket_bytes,
                                                    compression=args.compression,
                                                    n_kv_heads=args.n_kv_heads,
                                                    n_heads=args.n_heads, head=args.head)
        per = args.batch // world
        tokens = tokens[rank * per:(rank + 1) * per]
        shard = f"batch {per}"
    for _ in range(2):
        state, m = trainer.train_step(state, tokens)
    m["loss"].item()
    t0 = time.perf_counter()  # the same steps without the profiler first
    for _ in range(args.steps):
        state, m = trainer.train_step(state, tokens)
    m["loss"].item()
    plain_step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    torch.cuda.reset_peak_memory_stats()
    counted = RC.KERNELS + (FM.SHIFT,) + flash.KERNELS + EF.KERNELS
    for kern in counted:
        kern.launches = 0
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
    # B11's time that no other kernel overlaps (it runs on a side stream)
    others_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels
                          if not COLLECTIVES["B11"].search(e.name))
    launches = {k.name: k.launches / args.steps for k in counted}
    # the collectives of the step by kernel: B5-B8, B11, EF and NCCL's
    collectives = {label: sum(us for name, us in by_name.items() if pattern.search(name))
                   / args.steps / 1e3 for label, pattern in COLLECTIVES.items()}
    collectives["B11 exposed"] = (busy_us - others_us) / args.steps / 1e3
    steps = args.steps
    step_ms = wall_us / steps / 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[profile] {torch.cuda.get_device_name(0)}, flagship GPT batch {args.batch} x "
          f"{cfg.max_len}, {cfg.n_heads} heads of {cfg.d_model // cfg.n_heads}, {cfg.kv_heads} "
          f"kv heads, head={cfg.head} (rank {rank} of {world}, {shard}, "
          f"impl={args.impl}, compression={args.compression}): step "
          f"{step_ms:.1f} ms on the host clock ({plain_step_ms:.1f} ms without the profiler), "
          f"peak memory {peak_gib:.2f} GiB, this process's device busy "
          f"{busy_us / steps / 1e3:.1f} ms, idle share {1 - busy_us / wall_us:.3f}")
    print(f"[profile] collectives ms/step {json.dumps(collectives)}; launches a step "
          f"{json.dumps(launches)}")
    for label, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}: {us / steps / 1e3:.1f} ms/step "
              f"({us / sum(by_cat.values()):.1%} of device time)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for name, us in top:
        print(f"[profile]   {us / steps / 1e3:8.2f} ms/step  {name[:110]}")
    print(json.dumps({
        "rank": rank, "world": world, "tokens": args.batch * cfg.max_len,
        "step_ms": step_ms, "step_ms_unprofiled": plain_step_ms,
        "peak_gib": peak_gib,
        "device_busy_ms": busy_us / steps / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "categories_ms": {k: v / steps / 1e3 for k, v in by_cat.items()},
        "collectives_ms": collectives, "ring_launches": launches,
        "top_kernels_ms": {k[:110]: v / steps / 1e3 for k, v in top},
    }))
    distributed.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
