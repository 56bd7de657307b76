#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kungfu_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--steps 5] [--batch 8] [--seed 0] [--rank-steps 3]
                          [--bucket-mib 256]

Phases, each of which ends the run with a non-zero exit if it fails:

 1. device   the card's name and power limit (nvidia-smi), torch's view
 2. build    every CUDA kernel of the main path, built from csrc/ with nvcc
             (flash attention and the ring collectives), before any rank
             starts
 3. kernels  each flash kernel against its plain PyTorch version at the
             flagship attention shape (B=8, H=16, L=2048, D=64, bf16,
             causal), plus the ragged L=2000, window=256 and non-causal
             cases, head dims 16, 128 and 8 (in the kernels) and 12
             (padded to 16 by the wrappers) at B=2 (16 and 128 at the GQA
             shape too),
             and the backward (B2, B3) with a non-zero lse
             cotangent, causal and not, against the plain blocked
             backward (ring attention's full hops and merges); times of
             kernel, plain version and the library call
             (scaled_dot_product_attention, a yardstick the port never
             calls), and the least time the card could take (bound); then
             the same at the GQA flagship's shape (Hkv=8): the forward, dq
             and the GQA dk/dv kernel (B4) against the plain versions, a
             planted B4 fault (a 64-wide key block missing half its query
             rows) rejected, and B4's times (library: the GQA backward of
             scaled_dot_product_attention(enable_gqa=True))
 3b. wide    the wide flash family (head dims over 128, csrc/flash_wide.cu)
             against its plain versions (which split the work as its
             blocks do) by the same blockwise check: Gemma 2B's attention
             (B=1, H=8, Hkv=1, L=8192, D=256, bf16, causal: the forward,
             dq and the GQA dk/dv), the same with Hkv=8 (dk/dv without a
             group), D=192 causal, windowed and not; the three kernels'
             times at the Gemma-2B shape, the plain versions', SDPA's
             (a yardstick) and the bound; the Gemma shape in fp16 too;
             then a Gemma-2B-shaped model (d_model 2048, 8 heads of 256,
             one kv head, 2 layers) trains 3 steps on 8192 tokens: each
             wide kernel (and its B row) launched once per layer and
             step; the steady step (median of steps 2-3) beside the wide
             kernels' share of it
 4. check    a small f32 model: flash kernels against full attention on the
             same weights (loss and every gradient); then with dropout 0.1:
             train=False equals the model without dropout, train=True from
             generators of one seed gives one loss twice, another seed
             another loss
 5. main     the flagship GPT (vocab 32000, d_model 1024, 24 layers, 16
             heads, d_ff 4096, seq 2048, bf16, RoPE, causal) training with
             DataParallelTrainer + synchronous_sgd(AdamW(3e-4, (0.9, 0.95),
             wd 1e-4)) for a few steps on one repeated random batch of 8, in
             this process: the loss must be finite and fall, and each
             kernel must launch once per layer per step
 5b. chunked the flagship's row of 8 heads of 128 (config_gpt_mfu (8, False,
             True, 8); otherwise as phase main, batch 8): the dense head
             (2 steps), then head="hidden" with lm_loss_chunked (vocab
             blocks of 1024) under the same trainer for 3 steps, on the
             same weights (checksum) and sequences: loss finite and
             falling, the first step within 1e-3 of the dense head's, the
             peak memory at least 1.95 GiB (one f32 logits tensor) below
             the dense step's, B1-B3 once per layer per step; both step
             times and peaks; then one forward and backward under
             remat=True, remat_policy="dots" against remat=False on the
             same weights: the same loss and gradients (within 1e-6
             normwise; bit-equal expected) and a lower peak
 6. gqa-ref  the GQA flagship (n_kv_heads=8, otherwise as phase main) with
             the same seed: its loss on the same 8 sequences in one process
             (forward only), its parameter count and gradient shapes
    ef       the error-feedback residual kernel (compression.error_feedback
             .residual_, csrc/ring.cu) against its plain version
             (compression.quant.residual on the card), bit for bit, int8 and
             fp8, at every gradient size of the GQA flagship and a ragged
             1,000,003; then grouped (residual_group_) over all 195 of its
             gradients: one launch, every gradient bit-equal to its own
             launch and to the plain version; the time of the step's
             grouped call, of a launch per gradient and of the largest
             gradient alone, the plain version's, and the bound
 7. ring     4 ranks started by `python -m kungfu_tpu_torch.run`, rank r on
             card r mod count (all four on a machine with one card), each
             running tools/ring_check: the ring reduce-scatter (B5) and
             all-gather (B6) kernels and their all-reduce against the
             stacked plain versions, bit for bit, in f32 at the flagship's
             gradient size, in bf16 at 64M values, in a ragged f32 case
             of 1,000,003 values and at every payload of phase fsdp (each
             flagship parameter padded to a multiple of 4: chunks of 256 to
             8,192,000 values a rank, below one 1024-value tile up to the
             embedding's), with planted faults rejected, and grouped
             (ring_reduce_scatter_group, ring_all_gather_group) at each of
             phase fsdp's 12 buckets, every tensor bit-equal to its stacked
             plain version, one launch a bucket, planted faults (a tensor
             shifted by a vector, a last value wrong, a hop left out)
             rejected; then the
             fused-codec kernels B7 (reduce-scatter) and B8 (all-gather)
             through fused_ring_all_reduce, int8 and fp8, at the GQA
             flagship's gradient size and at 1,000,003 values: bit-equal to
             the stacked plain version on every rank, B7 alone bit-equal
             to its plain reduce-scatter, within the JAX
             package's quantization tolerance of the exact sum, planted
             faults (a hop's scales dropped, a block's codes zeroed)
             rejected; their times (median of 5 calls, CUDA events), the
             plain versions' times, NCCL's where every rank has a card of
             its own, and the bound
 8. ranks    slice 2's main path: the same flagship GPT on 4 ranks started by
             the launcher, batch 2 each (the same 8 sequences as phase main),
             synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), impl="pallas_ring",
             bucket_bytes=--bucket-mib MiB) for --rank-steps steps: loss
             finite and falling, the first step's loss within 1e-2 of phase
             main's, the replicas bit-identical after the last step (a
             checksum of every parameter's bits, gathered over the group),
             each flash kernel launched once per layer per step and each
             ring kernel once per bucket per step on every rank
 9. gqa      slice 3's main path: the GQA flagship on 4 ranks x batch 2,
             synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), impl="pallas_ring",
             compression="int8", bucket_bytes=--bucket-mib MiB) with
             error feedback, --rank-steps steps: loss finite and falling, the
             first step's loss within 1e-2 of phase gqa-ref's, the replicas
             bit-identical, B1, B2 and B4 launched once per layer per step,
             B7 and B8 once per bucket per step, the residual kernel once
             a step (one table of the 195 gradients), B3, B5 and B6 never
10. shift    4 ranks through the launcher, each running tools/shift_check:
             the ring shift kernel (B11) bit-equal to its stacked plain
             version (torch.roll over the ranks' payloads) on a K/V pair of
             one ring-attention hop (2 x [2, 2048, 16, 64] bf16, 16.8 MB) at
             shift +1 and -1 and on an odd byte count at +1 and +2, then
             interleaved with B5-B8 calls of other sizes; planted faults (a
             pair shifted the wrong way, a 16-byte vector corrupted)
             rejected; the pair on the side stream beside a flash forward
             of ring attention's block shape on the current stream (both
             bit-equal to their results alone) and at grids of 8, 16, 32
             and 66 blocks (bit for bit); its time per call (median of 20),
             the wrapper's issue, at each grid, beside the flash call, the
             plain version's, NCCL's batch_isend_irecv where every rank has
             a card of its own, and the bound
11. sp-ref   the flagship at 8192 positions (max_len 8192) on the 2
             sequences of phase sp, in one process with flash attention
             over the whole sequence, forward only: the first-step loss
12. sp       slice 4's main path: the 8192-position flagship on 4 ranks
             as a mesh of dp=1 x sp=4 (each rank 2048 positions of both
             sequences), attention="ring" (K/V rotating through B11, each
             hop's block on B1-B3), MeshTrainer with adamw(3e-4, b1=0.9,
             b2=0.95) and the gradient sum under impl="pallas_ring" (B5,
             B6, --bucket-mib buckets), 3 steps (SP_STEPS): loss finite and
             falling, the first step's loss within 1e-2 of phase sp-ref's,
             the replicas bit-identical, B11 launched 2 x 3 x 24 = 144 times
             a step on every rank, every one on the workspace's side stream
             (each hop's rotation issued before the previous hop's flash
             block, its backward on the same stream), and B1, B2 and B3 24 x (r + 1) times on
             rank r (the causal ring skips the blocks of later ranks), B5
             and B6 once per bucket; the slowest rank's step time, tokens/s
             and peak memory per rank
13. fused    B9's and B10's product body alone on this card (tools/fused_time:
             `mm_product` at the per-hop and per-rank shapes below, against
             the f32 product, timed beside torch.matmul and the bound), then
             4 ranks through the launcher, each running tools/fused_check:
             the all-gather-matmul (B9) and matmul-reduce-scatter (B10)
             kernels against their stacked plain versions at the flagship
             FSDP step's MLP shapes in bf16 (B9: x [4096, 1024] @ W_in
             [1024, 4096] from shards of [256, 4096]; B10: activations^T
             [1024, 4096] @ dy [4096, 4096], each rank its [256, 4096] rows)
             and in f32 at 24 x (4 x 40) x 72 and 24 x 40 x 72: integer-valued
             operands bit for bit, random ones within the normwise bf16 / f32
             limit; planted faults (a shard consumed twice, a partial
             dropped) rejected; their times (wall time of all ranks' calls on
             a shared card, the event median on cards of their own), the
             plain versions', the unfused NCCL arm where every rank has a
             card, and the bound
14. fsdp     this slice's main path: the flagship on 4 ranks as
             make_mesh(fsdp=4), FSDPTrainer (every parameter chunked 4 ways,
             gathered through the ring all-gather B6 each step and its
             gradient reduce-scattered through B5, one grouped launch a
             bucket of parameters), batch 2 a rank of phase main's 8
             sequences, adamw(3e-4, b1=0.9, b2=0.95), 3 steps (FSDP_STEPS):
             loss finite and falling,
             the first within 1e-2 of phase main's and every step's within
             1e-2 of phase ranks' (the same S-SGD arithmetic), memory after
             init at most 0.3 of a replica's parameters and Adam state and
             after step 1 (AdamW's moments made) at most 0.3 of those and
             its gradients, B6
             and B5 launched once per bucket (12 of the 195 parameters) a
             step, B1-B3 once per layer, no other kernel; the slowest
             rank's step time, tokens/s,
             peak memory per rank
15. report   one JSON line of kernels B1-B11, the wide flash family and the
             residual kernel (launches from rank 0 of the path that runs
             each: phase ranks for B1-B3, B5, B6, phase sp for B11, phase
             fused for B9 and B10, phase wide's model step for the wide
             family, phase gqa for the others), then the last line {"ok":
             true, "device": {"platform": "gpu", ...}}

A rank that fails fails the run: the parent prints the ranks' output and
exits non-zero.  f32 products on the card run in full f32: TF32 is switched
off for matmuls and cuDNN in every process.  Imports nothing of JAX, and
every rank checks that too.  Without a CUDA device, or without the package
beside it, it exits non-zero before printing a result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks at 700 W (NVIDIA data sheet): dense bf16/fp16
# tensor-core rate and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain: each output's normwise relative error, worst over 64-row
# blocks, against kungfu_tpu_torch.utils.compare.REL_LIMIT (bf16 1e-2: a
# few bf16 roundings of P, dS and the output read about 3e-3, a dropped key
# or query block 0.09 or more); lse to LSE_ATOL absolute.
# The f32 model check: same f32 products in another order through two
# layers; loss to 1e-4 absolute, each gradient to a normwise relative
# error of 1e-5.
TOL_MODEL_LOSS = 1e-4
TOL_MODEL_GRAD = 1e-5
# Phase ranks against phase main, first step (no update yet): the same
# weights and sequences, the loss averaged over 4 shards instead of taken
# over one batch of 8, so only bf16 products of other shapes differ.
TOL_RANKS_LOSS = 1e-2
# Phase sp against phase sp-ref, first step: the same weights and
# sequences; ring attention merges four blocks per row in f32 where the
# one-process flash kernel folds them in one pass, the loss a sum of four
# shares, and the bf16 products take other shapes.
TOL_SP_LOSS = 1e-2
# Phase fsdp against phases main (first step) and ranks (every step): the
# same weights, sequences and AdamW; the gradients reduce-scattered per
# parameter chunk instead of all-reduced per bucket, so only the order of
# f32 sums and the shapes of bf16 products differ.
TOL_FSDP_LOSS = 1e-2
# Phase fsdp's memory against a replica's: after init against its f32
# parameters and two Adam moments (sharded 4 ways a rank holds 1/12 of
# those, its parameter chunks), after step 1 against its parameters,
# gradients and moments (sharded: 1/4, the chunks of all four; moments
# that were not sharded would make it 5/8).
FSDP_MEMORY_SHARE = 0.3
# Phase chunked: the chunked head's first-step loss against the dense
# head's on the same weights and sequences (the same f32 log-softmax,
# streamed over 1024-column blocks: f32 sums in another order over 16,376
# positions, about 1e-6); its peak at least one f32 logits tensor
# [8, 2048, 32000] (1.95 GiB) below the dense step's; remat "dots" against
# no remat, loss and every gradient's normwise relative error within 1e-6
# (the recompute repeats the same kernels on the same inputs, so bit-equal
# is expected; a bf16 rounding that differed would read 4e-3).
TOL_CHUNKED_LOSS = 1e-3
CHUNKED_SAVING = int(1.95 * 2**30)
TOL_REMAT = 1e-6
CHUNKED_STEPS = 3
WIDE_STEPS = 3  # phase wide: the Gemma-2B-shaped model's steps (steady: 2 and 3)
# Phase check's dropout: two forwards from generators of one seed, and
# train=False against the model without dropout, repeat the same kernels
# on the same inputs (bit-equal expected; the limit is 1e-6 absolute on a
# loss near log 512); another seed moves the loss by far more than 1e-4.
TOL_DROPOUT_SAME = 1e-6
DROPOUT_MOVES = 1e-4
FSDP_STEPS = 3  # phase fsdp: each step makes 24 ring calls (a card switch each on one card)
N_RANKS = 4
SP_BATCH, SP_SEQ = 2, 8192  # phase sp: 16,384 tokens a step, 2048 positions a rank
SP_STEPS = 3  # phase sp: a few steps at full depth (each shift costs a card switch)
SHIFT_GRIDS = "8,16,32,66"  # phase shift: B11's grids checked and timed
RANKS_LINE = "RANKS_RESULT "
SP_LINE = "SP_RESULT "
FSDP_LINE = "FSDP_RESULT "


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def jax_free() -> bool:
    return not any(m.split(".")[0] in ("jax", "kungfu_tpu") for m in sys.modules)


def spawn_ranks(worker_args, tag: str, timeout: float):
    """This script in rank mode on N_RANKS ranks, started by the launcher;
    {rank: its `tag` line}.  A failed rank fails the phase, with the
    ranks' output."""
    from kungfu_tpu_torch.tools import ring_check

    torch.cuda.empty_cache()  # the ranks share the card with this process
    print(f"[{worker_args[0]}] this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
          f"of the card while {N_RANKS} ranks run")
    # expandable segments: less memory stranded between the ranks' allocations
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    rc, out, results = ring_check.launch(
        N_RANKS, [sys.executable, os.path.abspath(__file__), "--rank-phase", *worker_args],
        env=env, timeout=timeout, tag=tag)
    if rc != 0 or sorted(results) != list(range(N_RANKS)):
        print(out[-12000:], file=sys.stderr)
        raise SmokeFailure(f"rank phase {worker_args[0]}: launcher exit {rc}, "
                           f"results from ranks {sorted(results)}")
    return out, results


# ----------------------------------------------------------------- phases --

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {kind} x{count}")
    tf32_off()
    print("[device] tf32 off for matmuls and cuDNN: f32 products run in full f32")
    return card, kind, count


def phase_build():
    from kungfu_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"[build] {len(paths)} sources in {time.perf_counter() - t0:.1f} s "
          f"(per source: {json.dumps({k: round(v, 1) for k, v in _build.build_seconds.items()})})")
    for stem, path in sorted(paths.items()):
        log = open(path + ".log").read() if os.path.exists(path + ".log") else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
        if regs:
            print(f"[build] {stem}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
                  f"spill stores up to {max(spills or [0])} bytes")


def _pairs(L: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention computes (what this run's masks keep)."""
    if not causal:
        return L * L
    return sum(min(q + 1, window) if window else q + 1 for q in range(L))


def _bound(flops: float, nbytes: float, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(seed: int):
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.utils.compare import LSE_ATOL, REL_LIMIT, rel_errs

    B, H, D, dtype = 8, 16, 64, torch.bfloat16
    errs = {k.name: 0.0 for k in flash.KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # (L, window, causal, batch, heads, head dim): the flagship's, then head
    # dims 16, 128 and 8 in the kernels, and 12 padded to 16 by the wrappers,
    # at batch 2; last the shape of phase chunked's row (8 heads of 128, a
    # full causal 2048: every query block over up to 32 key tiles)
    for L, window, causal, nb, h, d in (
            (2048, 0, True, B, H, D), (2000, 0, True, B, H, D), (2048, 256, True, B, H, D),
            (2048, 0, False, B, H, D), (2048, 0, True, 2, H, 16), (2000, 256, True, 2, H, 128),
            (2048, 0, True, 2, H, 8), (2000, 256, True, 2, H, 12), (2048, 0, True, B, 8, 128)):
        scale = d ** -0.5
        q, k, v, do = (torch.randn(nb, L, h, d, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = flash.flash_fwd(q, k, v, scale, causal, window)
        o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, causal, window)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window)
        dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, window)
        dq_ref, dk_ref, dv_ref = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale,
                                                       causal, 128, window)
        torch.cuda.synchronize()
        case = f"B={nb} L={L} H={h} D={d} window={window}" + ("" if causal else " non-causal")
        limit = REL_LIMIT[dtype]
        rel = {}
        for name, got, want in (("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref),
                                ("dv", dv, dv_ref)):
            whole, worst = rel[name] = rel_errs(got, want)
            check(worst <= limit, f"{name} kernel vs plain at {case}: normwise relative "
                  f"error {whole:.3g}, worst 64-row block {worst:.3g} > {limit}")
        e_lse = max_err(lse, lse_ref)
        check(e_lse <= LSE_ATOL, f"lse at {case}: max abs err {e_lse:.4g} > {LSE_ATOL}")
        print(f"[kernels] {case}: normwise relative error (whole, worst 64-row block) "
              + ", ".join(f"{n} {w:.3g} {b:.3g}" for n, (w, b) in rel.items())
              + f" (bf16, limit {limit} on the worst block); lse max abs err {e_lse:.3g}")
        e = {"flash_fwd": max_err(o, o_ref), "flash_bwd_dq": max_err(dq, dq_ref),
             "flash_bwd_dkv": max(max_err(dk, dk_ref), max_err(dv, dv_ref))}
        print(f"[kernels] {case}: max abs err o {e['flash_fwd']:.3g} "
              f"dq {e['flash_bwd_dq']:.3g} dk/dv {e['flash_bwd_dkv']:.3g}")
        for name, x in e.items():
            errs[name] = max(errs[name], x)
        del o_ref, dq_ref, dk_ref, dv_ref

    # the backward with a non-zero lse cotangent, folded into delta (ring
    # attention differentiates its merges through lse): the kernels against
    # the plain blocked backward, both through the autograd dispatcher
    L, scale = 2048, D ** -0.5
    for causal in (True, False):
        q, k, v, do = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        g_lse = torch.randn(B, H, L, generator=gen, device="cuda")
        o, lse = flash.flash_fwd(q, k, v, scale, causal)
        got = flash._dispatch_bwd(q, k, v, o, lse, do, scale, causal, 128, g_lse, 0, None)
        want = flash._dispatch_bwd(q, k, v, o, lse, do, scale, causal, 128, g_lse, 0, "xla")
        torch.cuda.synchronize()
        case = f"L={L} lse cotangent" + ("" if causal else " non-causal")
        limit = REL_LIMIT[dtype]
        rel = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            whole, worst = rel[name] = rel_errs(g, w)
            check(worst <= limit, f"{name} kernel vs plain at {case}: normwise relative "
                  f"error {whole:.3g}, worst 64-row block {worst:.3g} > {limit}")
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], max_err(got[0], want[0]))
        errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], max_err(got[1], want[1]),
                                    max_err(got[2], want[2]))
        print(f"[kernels] {case}: normwise relative error (whole, worst 64-row block) "
              + ", ".join(f"{n} {w:.3g} {b:.3g}" for n, (w, b) in rel.items())
              + f" (bf16, limit {limit}); max abs err dq {max_err(got[0], want[0]):.3g} "
              f"dk/dv {max(max_err(got[1], want[1]), max_err(got[2], want[2])):.3g}")
        del got, want

    # timing at the flagship shape (fresh inputs, causal, no window)
    L, window = 2048, 0
    q, k, v, do = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    o, lse = flash.flash_fwd(q, k, v, scale, True, window)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    ms = {
        "flash_fwd": time_ms(lambda: flash.flash_fwd(q, k, v, scale, True, window), 20),
        "flash_bwd_dq": time_ms(
            lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True, window), 20),
        "flash_bwd_dkv": time_ms(
            lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True, window), 20),
    }
    plain_fwd = time_ms(lambda: flash._plain_fwd_blhd(q, k, v, scale, True, window), 3, 1)
    plain_bwd = time_ms(lambda: flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True,
                                                      128, window), 3, 1)
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd, "flash_bwd_dkv": plain_bwd}
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True),
                      10)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": None, "flash_bwd_dkv": None}

    pairs = _pairs(L, True, window) * B * H
    elem = q.element_size()
    act = B * L * H * D * elem  # one [B, L, H, D] operand
    row = B * H * L * 4  # one f32 [B, H, L] vector
    work = {  # (matmul flops, bytes each input read once + each output written once)
        "flash_fwd": (4 * D * pairs, 4 * act + row),
        "flash_bwd_dq": (6 * D * pairs, 5 * act + 2 * row),
        "flash_bwd_dkv": (8 * D * pairs, 6 * act + 2 * row),
    }
    bounds = {n: _bound(f, b, dtype) for n, (f, b) in work.items()}
    for n in ms:
        lib = (f"; library scaled_dot_product_attention forward {lib_fwd:.3f} ms"
               if n == "flash_fwd" else f"; library SDPA backward (dq, dk, dv) {lib_bwd:.3f} ms")
        print(f"[kernels] {n}: {ms[n]:.3f} ms, plain {plain[n]:.3f} ms, bound "
              f"{bounds[n][0]:.4f} ms ({bounds[n][1]}: {work[n][0] / 1e9:.1f} GFLOP, "
              f"{work[n][1] / 1e6:.1f} MB), {work[n][0] / ms[n] / 1e9:.1f} TFLOP/s achieved "
              f"({100 * bounds[n][0] / ms[n]:.1f}% of the bound){lib}")
    print(f"[kernels] library scaled_dot_product_attention: forward {lib_fwd:.3f} ms, "
          f"backward (dq, dk, dv in one call) {lib_bwd:.3f} ms; plain backward computes dq, "
          f"dk and dv in one pass ({plain_bwd:.3f} ms)")
    return errs, ms, plain, library, bounds


def _dkv_fault(q, k, v, do, lse, delta, scale, dk, dv):
    """What a dk/dv kernel that left key block 0's query rows >= L/2 out
    would return: the plain dk, dv of those rows alone replaced."""
    from kungfu_tpu_torch.ops import flash

    L = q.shape[1]
    do, delta = do.clone(), delta.clone()
    do[:, L // 2:] = 0
    delta[:, :, L // 2:] = 0
    dk_late, dv_late = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True, 128, 0)[1:]
    dk_bad, dv_bad = dk.float().clone(), dv.float().clone()
    dk_bad[:, :64], dv_bad[:, :64] = dk_late[:, :64].float(), dv_late[:, :64].float()
    return dk_bad, dv_bad


def phase_kernels_gqa(seed: int):
    """B1, B2 and B4 at the GQA flagship's attention shape (Hkv=8)."""
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.utils.compare import LSE_ATOL, REL_LIMIT, rel_errs

    B, H, HKV, D, dtype = 8, 16, 8, 64, torch.bfloat16
    limit = REL_LIMIT[dtype]
    err = 0.0
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)

    def inputs(L, nb=B, d=D):
        def rnd(h):
            return torch.randn(nb, L, h, d, generator=gen, device="cuda").to(dtype)

        return rnd(H), rnd(HKV), rnd(HKV), rnd(H)

    # the GQA flagship's shapes, then head dims 16 and 128 (ROADMAP C.1) at batch 2
    for L, window, nb, d in ((2048, 0, B, D), (2000, 0, B, D), (2048, 256, B, D),
                             (2048, 0, 2, 16), (2000, 256, 2, 128)):
        scale = d ** -0.5
        q, k, v, do = inputs(L, nb, d)
        o, lse = flash.flash_fwd(q, k, v, scale, True, window)
        o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, True, window)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True, window)
        dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True, window)
        refs = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True, 128, window)
        torch.cuda.synchronize()
        case = f"GQA B={nb} H={H} Hkv={HKV} L={L} D={d} window={window}"
        rel = {}
        for name, got, want in (("o", o, o_ref), ("dq", dq, refs[0]), ("dk", dk, refs[1]),
                                ("dv", dv, refs[2])):
            whole, worst = rel[name] = rel_errs(got, want)
            check(worst <= limit, f"{name} kernel vs plain at {case}: normwise relative "
                  f"error {whole:.3g}, worst 64-row block {worst:.3g} > {limit}")
        e_lse = max_err(lse, lse_ref)
        check(e_lse <= LSE_ATOL, f"lse at {case}: max abs err {e_lse:.4g} > {LSE_ATOL}")
        err = max(err, max_err(dk, refs[1]), max_err(dv, refs[2]))
        print(f"[kernels] {case}: normwise relative error (whole, worst 64-row block) "
              + ", ".join(f"{n} {w:.3g} {b:.3g}" for n, (w, b) in rel.items())
              + f" (bf16, limit {limit}); lse max abs err {e_lse:.3g}; dk/dv max abs err "
              f"{max(max_err(dk, refs[1]), max_err(dv, refs[2])):.3g}")
        if L == 2048 and not window and d == D:
            dk_bad, dv_bad = _dkv_fault(q, k, v, do, lse, delta, scale, refs[1], refs[2])
            worst = max(rel_errs(dk_bad, refs[1])[1], rel_errs(dv_bad, refs[2])[1])
            check(worst > limit, f"the check passed a planted B4 fault ({worst:.3g})")
            print(f"[kernels] {case}: planted B4 fault (key block 0 without query rows "
                  f">= L/2) rejected, worst block {worst:.3g} > {limit}")
        del o_ref, refs

    L, scale = 2048, D ** -0.5
    q, k, v, do = inputs(L)
    o, lse = flash.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    name = flash.FLASH_BWD_DKV_GQA.name
    ms = time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True), 20)
    plain = time_ms(lambda: flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True, 128, 0),
                    3, 1)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    lib = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True), 10)
    pairs = _pairs(L, True, 0) * B * H
    elem = q.element_size()
    flops = 8 * D * pairs
    nbytes = (2 * B * L * H * D + 4 * B * L * HKV * D) * elem + 2 * B * H * L * 4
    bound = _bound(flops, nbytes, dtype)
    print(f"[kernels] {name} (B4) at B={B} H={H} Hkv={HKV} L={L} D={D} bf16 causal: "
          f"{ms:.3f} ms, plain backward (dq, dk, dv) {plain:.3f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
          f"{flops / ms / 1e9:.1f} TFLOP/s achieved ({100 * bound[0] / ms:.1f}% of the bound); "
          f"library scaled_dot_product_attention"
          f"(enable_gqa=True) backward (dq, dk, dv in one call) {lib:.3f} ms")
    return {name: err}, {name: ms}, {name: plain}, {name: lib}, {name: bound}


def _flash_check(flash, case: str, q, k, v, do, scale, causal, window, limit):
    """Forward, dq and dk/dv against their plain versions at one shape:
    each output's blockwise normwise relative error within `limit`, lse
    within LSE_ATOL.  Returns {kernel name: max abs err} for the wide
    family."""
    from kungfu_tpu_torch.utils.compare import LSE_ATOL, rel_errs

    o, lse = flash.flash_fwd(q, k, v, scale, causal, window)
    o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, causal, window)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, window)
    refs = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, causal, 128, window)
    torch.cuda.synchronize()
    rel = {}
    for name, got, want in (("o", o, o_ref), ("dq", dq, refs[0]), ("dk", dk, refs[1]),
                            ("dv", dv, refs[2])):
        whole, worst = rel[name] = rel_errs(got, want)
        check(worst <= limit, f"{name} kernel vs plain at {case}: normwise relative "
              f"error {whole:.3g}, worst 64-row block {worst:.3g} > {limit}")
    e_lse = max_err(lse, lse_ref)
    check(e_lse <= LSE_ATOL, f"lse at {case}: max abs err {e_lse:.4g} > {LSE_ATOL}")
    errs = {flash.FLASH_WIDE_FWD.name: max_err(o, o_ref),
            flash.FLASH_WIDE_DQ.name: max_err(dq, refs[0]),
            flash.FLASH_WIDE_DKV.name: max(max_err(dk, refs[1]), max_err(dv, refs[2]))}
    print(f"[wide] {case}: normwise relative error (whole, worst 64-row block) "
          + ", ".join(f"{n} {w:.3g} {b:.3g}" for n, (w, b) in rel.items())
          + f" (limit {limit}); lse max abs err {e_lse:.3g}; max abs err "
          + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()))
    return errs


def phase_wide(seed: int):
    """The wide flash family (head dims over 128, csrc/flash_wide.cu)
    against its plain versions at the Gemma-2B attention shape and others;
    its times, the plain versions', SDPA's and the bound; then a Gemma-2B-
    shaped model's training steps through the entry points, which must run
    on the wide kernels."""
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.tools.flash_time import WIDE_MODEL, wide_steps
    from kungfu_tpu_torch.utils.compare import REL_LIMIT

    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    errs = {kern.name: 0.0 for kern in flash.WIDE_KERNELS}

    def inputs(nb, L, h, hkv, d, dt=dtype):
        def rnd(heads):
            return torch.randn(nb, L, heads, d, generator=gen, device="cuda").to(dt)

        return rnd(h), rnd(hkv), rnd(hkv), rnd(h)

    # (B, L, H, Hkv, D, causal, window, dtype): Gemma 2B's attention (arXiv
    # 2403.08295: 8 heads of 256, one kv head) at 8192 positions, in bf16
    # and fp16, the same without a group (B3's path), then D = 192 causal,
    # windowed and not
    for nb, L, h, hkv, d, causal, window, dt in (
            (1, 8192, 8, 1, 256, True, 0, dtype), (1, 8192, 8, 1, 256, True, 0, torch.float16),
            (1, 8192, 8, 8, 256, True, 0, dtype), (2, 2048, 8, 2, 192, True, 0, dtype),
            (2, 2000, 8, 8, 192, True, 256, dtype), (1, 2048, 8, 1, 192, False, 0, dtype)):
        case = (f"B={nb} L={L} H={h} Hkv={hkv} D={d} window={window}"
                + ("" if causal else " non-causal") + f" {str(dt)[6:]}")
        for name, e in _flash_check(flash, case, *inputs(nb, L, h, hkv, d, dt), d ** -0.5,
                                    causal, window, REL_LIMIT[dt]).items():
            errs[name] = max(errs[name], e)
        torch.cuda.empty_cache()

    # times at the Gemma-2B shape
    nb, L, h, hkv, d = 1, 8192, 8, 1, 256
    scale = d ** -0.5
    q, k, v, do = inputs(nb, L, h, hkv, d)
    o, lse = flash.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    ms = {
        flash.FLASH_WIDE_FWD.name: time_ms(lambda: flash.flash_fwd(q, k, v, scale, True), 3, 1),
        flash.FLASH_WIDE_DQ.name: time_ms(
            lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True), 10),
        flash.FLASH_WIDE_DKV.name: time_ms(
            lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True), 10),
    }
    plain_fwd = time_ms(lambda: flash._plain_fwd_blhd(q, k, v, scale, True, 0), 1, 1)
    plain_bwd = time_ms(lambda: flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True,
                                                      128, 0), 1, 1)
    plain = {flash.FLASH_WIDE_FWD.name: plain_fwd, flash.FLASH_WIDE_DQ.name: plain_bwd,
             flash.FLASH_WIDE_DKV.name: plain_bwd}
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True), 5)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True), 5)
    library = {flash.FLASH_WIDE_FWD.name: lib_fwd, flash.FLASH_WIDE_DQ.name: None,
               flash.FLASH_WIDE_DKV.name: None}
    pairs = _pairs(L, True, 0) * nb * h
    act, kv = nb * L * h * d * 2, nb * L * hkv * d * 2  # bf16 [B, L, H, D], [B, L, Hkv, D]
    row = nb * h * L * 4
    work = {  # (matmul flops, bytes each input read once + each output written once)
        flash.FLASH_WIDE_FWD.name: (4 * d * pairs, 2 * act + 2 * kv + row),
        flash.FLASH_WIDE_DQ.name: (6 * d * pairs, 3 * act + 2 * kv + 2 * row),
        flash.FLASH_WIDE_DKV.name: (8 * d * pairs, 2 * act + 4 * kv + 2 * row),
    }
    bounds = {n: _bound(f, b, dtype) for n, (f, b) in work.items()}
    for n in ms:
        lib = (f"SDPA forward (enable_gqa) {lib_fwd:.3f} ms" if n == flash.FLASH_WIDE_FWD.name
               else f"SDPA backward (dq, dk, dv in one call, enable_gqa) {lib_bwd:.3f} ms")
        print(f"[wide] {n} at B={nb} H={h} Hkv={hkv} L={L} D={d} bf16 causal: {ms[n]:.3f} ms, "
              f"plain {plain[n]:.3f} ms, bound {bounds[n][0]:.4f} ms ({bounds[n][1]}: "
              f"{work[n][0] / 1e9:.1f} GFLOP, {work[n][1] / 1e6:.1f} MB), "
              f"{work[n][0] / ms[n] / 1e9:.1f} TFLOP/s achieved "
              f"({100 * bounds[n][0] / ms[n]:.2f}% of the bound); library {lib}")
    del q, k, v, do, o, lse, delta, qt, kt, vt, dot, qg, kg, vg, out
    torch.cuda.empty_cache()

    # the path: the Gemma-2B-shaped model (flash_time.WIDE_MODEL: Gemma 2B's
    # widths, 2 layers) trains WIDE_STEPS steps on one sequence of 8192 tokens
    for kern in flash.WIDE_KERNELS + flash.KERNELS:
        kern.launches = 0
    steps_ms, losses = wide_steps(WIDE_STEPS, seed)
    launches = {kern.name: kern.launches for kern in flash.WIDE_KERNELS + flash.KERNELS}
    check(all(map(math.isfinite, losses)), f"wide: non-finite loss {losses}")
    layers = WIDE_MODEL["n_layers"]
    want = dict.fromkeys(launches, layers * WIDE_STEPS)
    want[flash.FLASH_BWD_DKV.name] = 0  # one kv head: the dk/dv launches count for B4
    check(launches == want, f"wide: kernel launches {launches}, expected {want}")
    steady = statistics.median(steps_ms[1:])
    bwd = layers * (ms[flash.FLASH_WIDE_DQ.name] + ms[flash.FLASH_WIDE_DKV.name])
    fwd = layers * ms[flash.FLASH_WIDE_FWD.name]
    print(f"[wide] Gemma-2B-shaped model ({json.dumps(WIDE_MODEL)}, bf16), "
          f"{WIDE_STEPS} steps on 1 x {WIDE_MODEL['max_len']} tokens: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step times "
          f"{', '.join(f'{x:.1f}' for x in steps_ms)} ms (the first with its setup); steady step "
          f"{steady:.1f} ms (median of steps 2-{WIDE_STEPS}), of it the wide backward's two "
          f"kernels {bwd:.1f} ms ({100 * bwd / steady:.1f}%) and the wide forward {fwd:.1f} ms "
          f"({100 * fwd / steady:.1f}%) by their own timings; launches {json.dumps(launches)}")
    torch.cuda.empty_cache()
    path = {kern.name: launches[kern.name] for kern in flash.WIDE_KERNELS}
    return (errs, ms, plain, library, bounds), path


def _loss_and_grads(model, tokens):
    """One forward and backward of `lm_step_loss`: (loss, gradients on
    the host, peak device memory in bytes)."""
    from kungfu_tpu_torch.tools.step_profile import lm_step_loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = lm_step_loss(model, tokens)
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}, peak


def phase_chunked(batch: int, seed: int, steps: int = CHUNKED_STEPS):
    """The flagship's row of 8 heads of 128 (config_gpt_mfu (8, False,
    True, 8)) trained with the chunked head (head="hidden",
    lm_loss_chunked) against the dense head on the same weights and
    sequences; then a step under remat_policy="dots" against no remat."""
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.tools.step_profile import flagship_model, flagship_step, flagship_tokens

    runs = {}
    for head in ("dense", "hidden"):
        cfg, trainer, state, tokens = flagship_step(batch, seed, n_heads=8, head=head)
        total = sum(p.double().sum().item() for p in state.params.parameters())
        for kern in flash.KERNELS + flash.WIDE_KERNELS:
            kern.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(steps if head == "hidden" else 2):
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, tokens)
            losses.append(metrics["loss"].item())
            times.append(time.perf_counter() - t0)
        runs[head] = dict(losses=losses, step_ms=times[-1] * 1e3, checksum=total,
                          peak=torch.cuda.max_memory_allocated(),
                          launches={k.name: k.launches for k in flash.KERNELS + flash.WIDE_KERNELS})
        print(f"[chunked] head={head}: losses {' '.join(f'{x:.4f}' for x in losses)}, step "
              f"times {' '.join(f'{t * 1e3:.1f}' for t in times)} ms, peak memory "
              f"{runs[head]['peak'] / 2**30:.2f} GiB")
        del cfg, trainer, state, tokens
        torch.cuda.empty_cache()
    dense, chunked = runs["dense"], runs["hidden"]
    losses = chunked["losses"]
    check(dense["checksum"] == chunked["checksum"], "chunked: the two arms' weights differ")
    check(all(math.isfinite(x) for x in losses), f"chunked: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"chunked: loss did not fall: {losses}")
    check(abs(losses[0] - dense["losses"][0]) <= TOL_CHUNKED_LOSS,
          f"chunked: first-step loss {losses[0]} vs the dense head's {dense['losses'][0]}")
    saved = dense["peak"] - chunked["peak"]
    check(saved >= CHUNKED_SAVING, f"chunked: peak {chunked['peak'] / 2**30:.3f} GiB, only "
          f"{saved / 2**30:.3f} GiB below the dense step's (want {CHUNKED_SAVING / 2**30:.2f})")
    want = {k.name: 24 * steps for k in flash.KERNELS + flash.WIDE_KERNELS}
    for kern in (flash.FLASH_BWD_DKV_GQA,) + flash.WIDE_KERNELS:
        want[kern.name] = 0
    check(chunked["launches"] == want, f"chunked: launches {chunked['launches']}, want {want}")
    print(f"[chunked] 8 heads of 128, batch {batch} x 2048: first-step loss {losses[0]:.6f} vs "
          f"the dense head's {dense['losses'][0]:.6f} (same weights, checksum "
          f"{chunked['checksum']:.6f}); steady step {chunked['step_ms']:.1f} ms vs dense "
          f"{dense['step_ms']:.1f} ms; peak {chunked['peak'] / 2**30:.2f} GiB vs dense "
          f"{dense['peak'] / 2**30:.2f} GiB ({saved / 2**30:.2f} GiB less); launches "
          f"{json.dumps(chunked['launches'])}")

    # remat_policy="dots" against no remat: one forward and backward each
    results = {}
    for remat in (False, True):
        extra = dict(remat=True, remat_policy="dots") if remat else {}
        cfg, model = flagship_model(seed, "cuda", n_heads=8, head="hidden", **extra)
        results[remat] = _loss_and_grads(model, flagship_tokens(cfg, batch, seed))
        del model
        torch.cuda.empty_cache()
    (l0, g0, p0), (l1, g1, p1) = results[False], results[True]
    worst = max(((g1[n].float() - g0[n].float()).norm() / g0[n].float().norm().clamp_min(1e-30))
                .item() for n in g0)
    same = all(torch.equal(g1[n], g0[n]) for n in g0)
    check(abs(l1 - l0) <= TOL_REMAT and worst <= TOL_REMAT,
          f"remat dots: loss {l1} vs {l0}, worst gradient normwise relative error {worst:.3g}")
    check(p1 < p0, f"remat dots: peak {p1 / 2**30:.2f} GiB not below no remat's "
          f"{p0 / 2**30:.2f} GiB")
    print(f"[chunked] remat_policy=\"dots\" vs no remat, one step (head=\"hidden\"): loss "
          f"{l1:.6f} vs {l0:.6f}, gradients {'bit-equal' if same else 'not bit-equal'} (worst "
          f"normwise relative error {worst:.3g}, limit {TOL_REMAT}); peak {p1 / 2**30:.2f} GiB "
          f"vs {p0 / 2**30:.2f} GiB")
    return losses


def phase_gqa_reference(batch: int, seed: int):
    """The GQA flagship's loss on phase main's 8 sequences, in one process."""
    from kungfu_tpu_torch import convert
    from kungfu_tpu_torch.models import lm_loss
    from kungfu_tpu_torch.tools.step_profile import flagship_model

    cfg, model = flagship_model(seed, "cuda", n_kv_heads=8)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_len), generator=gen,
                           device="cuda")
    with torch.no_grad():
        loss = lm_loss(model(tokens), tokens).item()
    n_params = sum(p.numel() for p in model.parameters())
    shapes = [tuple(p.shape) for p in model.parameters()]
    check(math.isfinite(loss), f"gqa-ref: non-finite loss {loss}")
    # the weights convert to the JAX package's layout and back at full width
    sd = {k: v.float().cpu() for k, v in model.state_dict().items()}
    tree = convert.params_to_flax(sd, cfg)
    kv = tree["block_0"]["attn"]["k"]["kernel"].shape
    check(kv == (cfg.d_model, cfg.kv_heads * cfg.d_model // cfg.n_heads),
          f"gqa-ref: converted k kernel {kv}")
    back = convert.params_from_flax(tree, cfg)
    check(all(torch.equal(back[k], v) for k, v in sd.items()), "gqa-ref: convert round trip")
    del sd, tree, back
    print(f"[gqa-ref] GQA flagship {n_params / 1e6:.1f}M params ({cfg.n_heads} query heads, "
          f"{cfg.kv_heads} kv heads; converts to the JAX layout and back), loss on the {batch} "
          f"sequences in one process {loss:.4f}")
    del model
    torch.cuda.empty_cache()
    return loss, n_params, shapes


def phase_ef(shapes, seed: int):
    """The error-feedback residual kernel against its plain version at the
    GQA flagship's gradient sizes; its times and bound."""
    from kungfu_tpu_torch import compression as tc
    from kungfu_tpu_torch.compression import error_feedback as EF

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)

    def gradient(n):  # gradient-like values of mixed magnitude, an all-zero block
        x = torch.randn(n, generator=gen, device="cuda")
        x *= torch.rand(n, generator=gen, device="cuda") * 1e-2
        x[256:512] = 0
        return x

    sizes = sorted({math.prod(s) for s in shapes}) + [1000003]
    err = 0.0
    for scheme in ("int8", "fp8"):
        cfg = tc.resolve(scheme)
        for n in sizes:
            c = gradient(n)
            want = tc.quant.residual(c, cfg)
            got = EF.residual_(c, cfg)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"ef_residual {scheme} x {n}: not bit-equal to the plain version "
                  f"(max abs err {max_err(got, want):.3g})")
            err = max(err, max_err(got, want))
            del c, want, got
    print(f"[ef] residual kernel bit-equal to the plain version, int8 and fp8, at "
          f"{len(sizes)} sizes from {sizes[0]} to {sizes[-1]} values")
    # one step's gradients, every one of the GQA flagship's, in one grouped call
    bufs = [gradient(math.prod(s)) for s in shapes]
    total = sum(b.numel() for b in bufs)
    tables = len(EF.ef_plan([b.numel() for b in bufs]))
    for scheme in ("int8", "fp8"):
        cfg = tc.resolve(scheme)
        grouped = [b.clone() for b in bufs]
        before = EF.EF_RESIDUAL.launches
        EF.residual_group_(grouped, cfg)
        launched = EF.EF_RESIDUAL.launches - before
        check(launched == tables, f"ef_residual group {scheme}: {launched} launches for "
              f"{len(bufs)} gradients, expected {tables}")
        for i, (b, g) in enumerate(zip(bufs, grouped)):
            one = EF.residual_(b.clone(), cfg)  # a launch for this tensor alone
            check(torch.equal(g.view(torch.int32), one.view(torch.int32)),
                  f"ef_residual group {scheme}: gradient {i} ({b.numel()} values) not "
                  f"bit-equal to its own launch (max abs err {max_err(g, one):.3g})")
            err = max(err, max_err(g, tc.quant.residual(b, cfg)))
            del one
        del grouped
    print(f"[ef] grouped residual of the {len(bufs)} gradients ({total} values) in "
          f"{tables} launch(es), int8 and fp8: every gradient bit-equal to its own launch "
          f"and to the plain version")
    cfg = tc.INT8
    largest = max(bufs, key=lambda b: b.numel())
    n = largest.numel()
    big = time_ms(lambda: EF.residual_(largest, cfg), 20)
    step_ms = time_ms(lambda: EF.residual_group_(bufs, cfg), 10, 2)
    per_tensor_ms = time_ms(lambda: [EF.residual_(b, cfg) for b in bufs], 3, 1)
    plain = time_ms(lambda: [tc.quant.residual(b, cfg) for b in bufs], 2, 1)
    bound = _bound(6 * total, 8 * total, torch.float32)  # read and write 4 bytes a value
    print(f"[ef] int8, one step's {len(bufs)} gradients ({total} values): grouped "
          f"{step_ms:.3f} ms in {tables} launch(es), a launch per gradient "
          f"{per_tensor_ms:.3f} ms, plain {plain:.3f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]}: {8 * total / 1e6:.1f} MB); the largest gradient ({n} values) alone "
          f"{big:.3f} ms; library: none computes a blockwise quantization residual")
    del bufs, largest
    torch.cuda.empty_cache()
    name = EF.EF_RESIDUAL.name
    return {name: err}, {name: step_ms}, {name: plain}, {name: None}, {name: bound}


def phase_model_check(seed: int):
    """Small f32 model on the card: the flash kernels against plain full
    attention on the same weights, loss and every gradient."""
    from kungfu_tpu_torch.models import TransformerConfig, TransformerLM, lm_loss
    from kungfu_tpu_torch.ops import flash

    common = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, d_ff=512, max_len=256,
                  dtype=torch.float32, rope=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, 512, (2, 256), generator=gen, device="cuda")
    results = []
    state = None
    for attention in ("flash", "full"):
        model = TransformerLM(TransformerConfig(attention=attention, **common), device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(seed))
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        before = [k.launches for k in flash.KERNELS]
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        launched = [k.launches - n for k, n in zip(flash.KERNELS, before)]
        check(launched == ([2, 2, 2, 0] if attention == "flash" else [0, 0, 0, 0]),
              f"model check ({attention}): kernel launches {launched}")
        results.append((loss.item(), {n: p.grad for n, p in model.named_parameters()}))
    (l_flash, g_flash), (l_full, g_full) = results
    check(abs(l_flash - l_full) <= TOL_MODEL_LOSS,
          f"model check: loss flash {l_flash} vs full {l_full}")
    worst = max(((g_flash[n] - g_full[n]).norm() / g_full[n].norm()).item() for n in g_full)
    check(worst <= TOL_MODEL_GRAD, f"model check: gradient normwise rel err {worst:.3g}")
    print(f"[check] f32 2-layer model, flash kernels vs full attention: loss {l_flash:.6f} vs "
          f"{l_full:.6f}, worst gradient normwise relative error {worst:.3g}")

    # dropout 0.1 on the same weights: only under train=True, from the generator
    model = TransformerLM(TransformerConfig(attention="flash", dropout=0.1, **common),
                          device="cuda")
    model.load_state_dict(state)
    with torch.no_grad():
        def loss_of(**kw):
            return lm_loss(model(tokens, **kw), tokens).item()

        l_eval = loss_of()
        seeded = [loss_of(train=True, generator=torch.Generator(device="cuda").manual_seed(s))
                  for s in (seed + 1, seed + 1, seed + 2)]
    check(abs(l_eval - l_flash) <= TOL_DROPOUT_SAME,
          f"dropout: train=False loss {l_eval} vs the model without dropout {l_flash}")
    check(abs(seeded[0] - seeded[1]) <= TOL_DROPOUT_SAME,
          f"dropout: one seed gave losses {seeded[0]} and {seeded[1]}")
    check(abs(seeded[2] - seeded[0]) > DROPOUT_MOVES,
          f"dropout: another seed gave the same loss {seeded[2]} vs {seeded[0]}")
    print(f"[check] dropout 0.1: train=False loss {l_eval:.6f} (without dropout {l_flash:.6f}); "
          f"train=True, one seed twice {seeded[0]:.6f} {seeded[1]:.6f}, another seed "
          f"{seeded[2]:.6f}")


def phase_main(steps: int, batch: int, seed: int):
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.fsdp import bucket_plan
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.tools.step_profile import flagship_step

    world = distributed.init_distributed(device="cuda")
    cfg, trainer, state, tokens = flagship_step(batch, seed)
    n_params = sum(p.numel() for p in state.params.parameters())
    # every parameter zero-padded to a multiple of N_RANKS: the payloads of
    # phase fsdp's ring calls, one chunk of size / N_RANKS a rank
    fsdp_sizes = sorted({-(-p.numel() // N_RANKS) * N_RANKS for p in state.params.parameters()})
    # phase fsdp's buckets: its grouped ring calls, as ring_check --groups
    chunks = [torch.empty(-(-p.numel() // N_RANKS), dtype=p.dtype, device="meta")
              for p in state.params.parameters()]
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    fsdp_groups = ";".join(f"{names[chunks[a].dtype]}:" + "+".join(str(c.numel())
                                                                   for c in chunks[a:b])
                           for a, b in bucket_plan(chunks))
    print(f"[main] flagship GPT {n_params / 1e6:.1f}M params, world {world}, batch {batch} x "
          f"{cfg.max_len}, {cfg.n_layers} layers, attention={cfg.attention}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in flash.KERNELS:
        kern.launches = 0
    losses, times = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, tokens)
        loss = metrics["loss"].item()  # waits for the step
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"[main] step {step + 1}: loss {loss:.4f}, {times[-1] * 1e3:.1f} ms")
    launches = {k.name: k.launches for k in flash.KERNELS}
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = {k.name: cfg.n_layers * steps for k in flash.KERNELS}
    want[flash.FLASH_BWD_DKV_GQA.name] = 0  # the flagship is MHA
    check(launches == want, f"kernel launches {launches}, expected {want}")
    step_s = statistics.median(times[1:]) if steps > 1 else times[0]
    print(f"[main] steady step {step_s * 1e3:.1f} ms (median of steps 2-{steps}), "
          f"{batch * cfg.max_len / step_s:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {json.dumps(launches)}")
    return losses, n_params, fsdp_sizes, fsdp_groups


def phase_ring(n_params: int, gqa_params: int, fsdp_sizes, fsdp_groups: str, seed: int):
    """B5 and B6, then B7 and B8, on N_RANKS ranks against their stacked
    plain versions; B5 and B6 also at every payload of phase fsdp, and
    grouped at each of its buckets."""
    from kungfu_tpu_torch.ops import ring_collectives as RC

    # the fused cases first: the plain slots of the 367.6M-value case stay
    # allocated for the rest of the phase, and four ranks share the card
    cases = (f"int8:{gqa_params},fp8:{gqa_params},int8:1000003,fp8:1000003,"
             f"f32:{n_params},bf16:{64 << 20},f32:1000003,"
             + ",".join(f"f32:{size}" for size in fsdp_sizes))
    _, res = spawn_ranks(["ring", "--cases", cases, "--groups", fsdp_groups, "--iters", "5",
                          "--seed", str(seed), "--faults"], "RING_CHECK ", 600)
    for r, rr in sorted(res.items()):
        for case in rr["cases"]:
            what = (f"group of {case['segments']}" if "group" in case
                    else f"x {case['size']}")
            check(all(case["ok"].values()), f"ring rank {r} {case['dtype']} {what}: "
                  f"{json.dumps(case['ok'])}, max abs err {json.dumps(case['max_abs_err'])}")
    r0 = res[0]
    print(f"[ring] {N_RANKS} ranks, backend {r0['backend']}, {r0['card']}: every rank's "
          f"reduce-scatter, all-gather and all-reduce (sum, mean) equal the stacked plain "
          f"versions bit for bit, and so do the fused int8/fp8 all-reduces (sum, mean) and "
          f"their reduce-scatter (B7) alone, "
          f"within the reference's tolerance of the exact sum, and the grouped "
          f"reduce-scatter and all-gather at phase fsdp's buckets, each in the launches of "
          f"its segment plan; planted faults rejected")
    singles = [c for c in r0["cases"] if "group" not in c]
    for i, case in enumerate(r0["cases"]):
        if "group" not in case:
            continue
        slowest = {k: max(rr["cases"][i]["ms"][k] for rr in res.values()) for k in case["ms"]}
        print(f"[ring] group {case['dtype']} of {case['segments']} tensors "
              f"({case['chunk_bytes']} bytes a rank): kernel ms (slowest rank's median) rs "
              f"{slowest['rs']:.3f} ag {slowest['ag']:.3f} in {case['launches']['rs']} launch(es) "
              f"each; plain ms {json.dumps(case['plain_ms'])}; bound ms "
              f"{json.dumps(case['bound_ms'])} ({case['bound_note']}); library ms "
              f"{json.dumps(case['library_ms'])}")
    for i, case in enumerate(r0["cases"]):
        if "group" in case:
            continue
        slowest = {k: max(rr["cases"][i]["ms"][k] for rr in res.values()) for k in case["ms"]}
        lib = case["library_ms"]
        lib = ({k: max(rr["cases"][i]["library_ms"][k] for rr in res.values()) for k in lib}
               if lib else None)
        extra = ""
        if "tolerance" in case:
            worst = max(rr["cases"][i]["max_abs_err"]["fused_sum vs exact"] for rr in res.values())
            extra = f"; error vs exact sum {worst:.4g} (tolerance {case['tolerance']:.4g})"
        if case.get("nccl_f32_ms"):
            extra += f"; NCCL f32 at this size (context) {json.dumps(case['nccl_f32_ms'])}"
        if case.get("device_ms"):
            dev = {k: max(rr["cases"][i]["device_ms"][k] for rr in res.values())
                   for k in case["device_ms"]}
            extra += f"; device ms, the host's issue out (slowest rank) {json.dumps(dev)}"
        print(f"[ring] {case['dtype']} x {case['size']} (chunk {case['chunk']}): kernel ms "
              f"(slowest rank's median) rs {slowest['rs']:.3f} ag {slowest['ag']:.3f} "
              f"all-reduce {slowest['ar']:.3f}; plain ms {json.dumps(case['plain_ms'])}; "
              f"bound ms {json.dumps(case['bound_ms'])} ({case['bound_note']}); library ms "
              f"{json.dumps(lib) if lib else 'null: ' + case['library_note']}{extra}")
        case["slowest_ms"], case["library_slowest_ms"] = slowest, lib
    by_case = {(c["dtype"], c["size"]): c for c in singles}
    big, fused = by_case[("f32", n_params)], by_case[("int8", gqa_params)]
    keys = {RC.RING_RS.name: (big, "rs"), RC.RING_AG.name: (big, "ag"),
            RC.FUSED_RS.name: (fused, "rs"), RC.FUSED_AG.name: (fused, "ag")}

    def worst(fused_cases: bool, names) -> float:
        """Largest error against the stacked plain version, every rank and case."""
        return max(v for rr in res.values() for c in rr["cases"]
                   if (c["dtype"] in ("int8", "fp8")) == fused_cases
                   for e, v in c["max_abs_err"].items() if e in names)

    # B7 alone and with B8: its reduce-scatter and the fused all-reduce
    # against their plain versions; B8 with B7
    errs = {RC.RING_RS.name: worst(False, ("rs",)), RC.RING_AG.name: worst(False, ("ag",)),
            RC.FUSED_RS.name: worst(True, ("rs", "fused_sum", "fused_mean")),
            RC.FUSED_AG.name: worst(True, ("fused_sum", "fused_mean"))}
    ms = {name: case["slowest_ms"][k] for name, (case, k) in keys.items()}
    # the stacked plain fused all-reduce computes both kernels' work at once
    plain = {name: case["plain_ms"][k if case is big else "ar"]
             for name, (case, k) in keys.items()}
    library = {name: (case["library_slowest_ms"][k] if case["library_slowest_ms"] else None)
               for name, (case, k) in keys.items()}
    bounds = {name: (case["bound_ms"][k], "bytes") for name, (case, k) in keys.items()}
    return errs, ms, plain, library, bounds


def phase_ranks(steps: int, batch: int, seed: int, bucket_mib: int, ref_loss1: float,
                compression=None):
    """The flagship S-SGD step on N_RANKS ranks through the ring kernels;
    with `compression`, the GQA flagship through the fused-codec kernels."""
    label = "gqa" if compression else "ranks"
    extra = ["--n-kv-heads", "8", "--compression", compression] if compression else []
    out, res = spawn_ranks(["train", "--steps", str(steps), "--batch", str(batch), "--seed",
                            str(seed), "--bucket-mib", str(bucket_mib), *extra], RANKS_LINE, 900)
    for line in out.splitlines():
        if "[ranks]" in line:
            print(line.replace("[ranks]", f"[{label}]"))
    for r, rr in sorted(res.items()):
        check(rr["ok"], f"{label}: rank {r} failed its checks: {json.dumps(rr['checks'])}")
    r0 = res[0]
    loss1 = r0["losses"][0]
    ref = "phase gqa-ref" if compression else "phase main"
    check(abs(loss1 - ref_loss1) <= TOL_RANKS_LOSS,
          f"{label}: first-step loss {loss1} vs {ref}'s {ref_loss1}")
    step_s = max(rr["step_s"] for rr in res.values())
    peaks = " ".join(f"{rr['peak_gib']:.2f}" for rr in res.values())
    print(f"[{label}] {N_RANKS} ranks x batch {batch // N_RANKS} ({r0['backend']}, "
          f"{r0['kv_heads']} kv heads, compression {compression}, {r0['buckets']} buckets of "
          f"at most {bucket_mib} MiB): losses {' '.join(f'{x:.4f}' for x in r0['losses'])}, "
          f"first step {loss1:.4f} vs {ref}'s {ref_loss1:.4f}; replicas bit-identical; "
          f"steady step {step_s * 1e3:.1f} ms (slowest rank), {batch * 2048 / step_s:.0f} "
          f"tokens/s, peak memory per rank {peaks} GiB; rank 0 launches "
          f"{json.dumps(r0['launches'])}")
    return r0["launches"], r0["losses"]


def phase_shift(seed: int):
    """B11 on N_RANKS ranks against its stacked plain version, interleaved
    with B5-B8; its time, the plain version's and the bound."""
    from kungfu_tpu_torch.ops import fused_matmul as FM

    _, res = spawn_ranks(["shift", "--interleave", "--faults", "--beside-flash", "--grid",
                          SHIFT_GRIDS, "--iters", "20", "--seed", str(seed)], "SHIFT_CHECK ", 600)
    for r, rr in sorted(res.items()):
        bad = [k for k, v in rr["ok"].items() if not v]
        check(rr["ok_all"], f"shift rank {r}: failed {bad}, max abs err "
              f"{json.dumps(rr['max_abs_err'])}")
    r0 = res[0]
    t0 = r0["timing"]
    ms = max(rr["timing"]["ms"] for rr in res.values())
    lib = (max(rr["timing"]["library_ms"] for rr in res.values())
           if t0["library_ms"] is not None else None)
    err = max(v for rr in res.values() for v in rr["max_abs_err"].values())
    print(f"[shift] {N_RANKS} ranks, backend {r0['backend']}, {r0['card']}: every rank's "
          f"shifts ({', '.join(k for k in r0['ok'] if 'rejects' not in k)}) equal the stacked "
          f"plain version bit for bit; planted faults rejected; launches on rank 0 "
          f"{json.dumps(r0['launches'])}")
    print(f"[shift] K/V pair {r0['kv']} bf16 x 2 ({t0['bytes'] / 1e6:.1f} MB) at +1: kernel "
          f"{ms:.3f} ms (slowest rank; {r0['timing']['how']}; grid {FM.SHIFT_GRID}), "
          + (f"device alone {max(rr['timing']['device_ms'] for rr in res.values()):.3f} ms, "
             if "device_ms" in t0 else "") + f"host issue "
          f"{max(rr['timing']['host_ms'] for rr in res.values()):.3f} ms, plain "
          f"{t0['plain_ms']:.3f} ms (all ranks in one "
          f"process), bound {t0['bound_ms']:.4f} ms ({t0['bound_note']}), library "
          f"{f'{lib:.3f} ms (NCCL batch_isend_irecv)' if lib is not None else 'null: ' + t0['library_note']}")
    grid = {g: max(rr["grid_ms"][g] for rr in res.values()) for g in r0["grid_ms"]}
    print(f"[shift] grid sweep, the pair bit-equal at every grid, ms (slowest rank): "
          + ", ".join(f"{g} blocks {t:.3f}" for g, t in grid.items()))
    side = {k: max(rr["beside_flash_ms"][k] for rr in res.values())
            for k in ("flash", "shift", "both")}
    print(f"[shift] beside a flash forward on the current stream (both bit-equal to their "
          f"results alone), ms (slowest rank): flash {side['flash']:.3f}, shift "
          f"{side['shift']:.3f}, both {side['both']:.3f} ({r0['beside_flash_ms']['how']})")
    name = FM.SHIFT.name
    return ({name: err}, {name: ms}, {name: t0["plain_ms"]}, {name: lib},
            {name: (t0["bound_ms"], "bytes")})


def phase_sp_reference(seed: int):
    """The 8192-position flagship's loss on phase sp's sequences, one process."""
    from kungfu_tpu_torch.models import lm_loss
    from kungfu_tpu_torch.tools.step_profile import flagship_model, flagship_tokens

    cfg, model = flagship_model(seed, "cuda", max_len=SP_SEQ)
    tokens = flagship_tokens(cfg, SP_BATCH, seed)
    with torch.no_grad():
        loss = lm_loss(model(tokens), tokens).item()
    check(math.isfinite(loss), f"sp-ref: non-finite loss {loss}")
    print(f"[sp-ref] flagship at {SP_SEQ} positions, {SP_BATCH} sequences, flash attention over "
          f"the whole sequence in one process: loss {loss:.4f}")
    del model
    torch.cuda.empty_cache()
    return loss


def phase_sp(steps: int, seed: int, bucket_mib: int, ref_loss: float):
    """The sequence-parallel flagship step on N_RANKS ranks (dp=1 x sp=4)."""
    out, res = spawn_ranks(["sp", "--steps", str(steps), "--seed", str(seed), "--bucket-mib",
                            str(bucket_mib)], SP_LINE, 900)
    for line in out.splitlines():
        if "[sp]" in line:
            print(line)
    for r, rr in sorted(res.items()):
        check(rr["ok"], f"sp: rank {r} failed its checks: {json.dumps(rr['checks'])}; "
              f"launches {json.dumps(rr['launches'])}, expected "
              f"{json.dumps(rr['expected_launches'])}")
    r0 = res[0]
    loss1 = r0["losses"][0]
    check(abs(loss1 - ref_loss) <= TOL_SP_LOSS,
          f"sp: first-step loss {loss1} vs phase sp-ref's {ref_loss}")
    step_s = max(rr["step_s"] for rr in res.values())
    peaks = " ".join(f"{res[r]['peak_gib']:.2f}" for r in sorted(res))
    print(f"[sp] {N_RANKS} ranks as dp=1 x sp=4 ({r0['backend']}, {r0['buckets']} buckets of at "
          f"most {bucket_mib} MiB), {SP_BATCH} x {SP_SEQ} tokens a step: losses "
          f"{' '.join(f'{x:.4f}' for x in r0['losses'])}, first step {loss1:.4f} vs phase "
          f"sp-ref's {ref_loss:.4f}; replicas bit-identical; launches exact on every rank; "
          f"steady step {step_s * 1e3:.1f} ms (slowest rank), {SP_BATCH * SP_SEQ / step_s:.0f} "
          f"tokens/s, peak memory per rank {peaks} GiB; launches per rank "
          + "; ".join(f"{r}: {json.dumps(res[r]['launches'])}" for r in sorted(res)))
    return r0["launches"]


def phase_fused(seed: int):
    """B9 and B10's product body alone on this card against the f32
    product, with its times beside torch.matmul's; then B9 and B10 on
    N_RANKS ranks against their stacked plain versions: their times, the
    plain versions', the library arm's and the bounds."""
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.tools import fused_time

    body = fused_time.measure(fused_time.shapes((4096, 1024, 4096), N_RANKS), 20, 2, seed,
                              torch.device("cuda"))
    for name, r in body.items():
        check(r["ok"], f"fused: the product body at {name} {r['shape']}: integer operands "
              f"exact {r['int_exact']}, worst 64-row block {r['rand_worst_block']:.3g}")
    def ms(v):
        return "not measured" if v is None else f"{v:.4f}"

    print("[fused] product body alone (mm_product, bf16, no peers) against the f32 product "
          "(integer operands bit for bit, normal ones within the bf16 limit), ms (mean of 20 "
          "calls between CUDA events, best of 2; device time from the profiler): " + "; ".join(
              f"{name} {r['shape']}: kernel {ms(min(r['kernel_ms']))} (device "
              f"{ms(r['kernel_device_ms'])}), torch.matmul {ms(min(r['library_ms']))} (device "
              f"{ms(r['library_device_ms'])}), bound {ms(r['bound_ms'])} ({r['bound_by']})"
              for name, r in body.items()))
    _, res = spawn_ranks(["fused", "--faults", "--iters", "5", "--seed", str(seed)],
                         "FUSED_CHECK ", 600)
    for r, rr in sorted(res.items()):
        bad = [k for k, v in rr["ok"].items() if not v]
        check(rr["ok_all"], f"fused rank {r}: failed {bad}, max abs err "
              f"{json.dumps(rr['max_abs_err'])}")
    r0 = res[0]
    print(f"[fused] {N_RANKS} ranks, backend {r0['backend']}, {r0['card']}: every rank's "
          f"all-gather-matmul and matmul-reduce-scatter at {json.dumps(r0['shapes'])} equal the "
          f"stacked plain versions (integer operands bit for bit; random ones, worst 64-row "
          f"block {max(max(rr['worst_block_rel_err'].values()) for rr in res.values()):.3g}); "
          f"planted faults rejected; launches on rank 0 {json.dumps(r0['launches'])}")
    out = tuple({} for _ in range(5))
    for kind, kern in (("b9", FM.AG_MATMUL), ("b10", FM.MATMUL_RS)):
        t0 = r0["timing"][kind]
        ms = max(rr["timing"][kind]["ms"] for rr in res.values())
        lib = (max(rr["timing"][kind]["library_ms"] for rr in res.values())
               if t0["library_ms"] is not None else None)
        err = max(v for rr in res.values() for k, v in rr["max_abs_err"].items()
                  if k.startswith(kind + " "))
        print(f"[fused] {kern.name} ({kind.upper()}) at {t0['shapes']} bf16: kernel {ms:.3f} ms "
              f"(slowest rank; {t0['how']}), plain {t0['plain_ms']:.3f} ms (all ranks in one "
              f"process), bound {t0['bound_ms']:.4f} ms ({t0['bound_by']}), library "
              f"{f'{lib:.3f} ms (NCCL unfused arm)' if lib is not None else 'null: ' + t0['library_note']}")
        for d, v in zip(out, (err, ms, t0["plain_ms"], lib, (t0["bound_ms"], t0["bound_by"]))):
            d[kern.name] = v
    return out, r0["launches"]


def phase_fsdp(steps: int, batch: int, seed: int, main_loss1: float, ranks_losses):
    """The flagship's FSDP step on N_RANKS ranks (fsdp=4) through B6/B5."""
    out, res = spawn_ranks(["fsdp", "--steps", str(steps), "--batch", str(batch), "--seed",
                            str(seed)], FSDP_LINE, 900)
    for line in out.splitlines():
        if "[fsdp]" in line:
            print(line)
    for r, rr in sorted(res.items()):
        check(rr["ok"], f"fsdp: rank {r} failed its checks: {json.dumps(rr['checks'])}; "
              f"launches {json.dumps(rr['launches'])}, expected "
              f"{json.dumps(rr['expected_launches'])}")
    r0 = res[0]
    losses = r0["losses"]
    check(abs(losses[0] - main_loss1) <= TOL_FSDP_LOSS,
          f"fsdp: first-step loss {losses[0]} vs phase main's {main_loss1}")
    worst = max(abs(a - b) for a, b in zip(losses, ranks_losses))
    check(worst <= TOL_FSDP_LOSS, f"fsdp: losses {losses} vs phase ranks' {ranks_losses}")
    step_s = max(rr["step_s"] for rr in res.values())
    peaks = " ".join(f"{res[r]['peak_gib']:.2f}" for r in sorted(res))
    held = " ".join(f"{res[r]['init_gib']:.2f}" for r in sorted(res))
    held1 = " ".join(f"{res[r]['step1_gib']:.2f}" for r in sorted(res))
    print(f"[fsdp] {N_RANKS} ranks as fsdp=4 ({r0['backend']}), {batch} x 2048 tokens a step: "
          f"losses {' '.join(f'{x:.4f}' for x in losses)}, first step {losses[0]:.4f} vs phase "
          f"main's {main_loss1:.4f}, every step within {worst:.4f} of phase ranks'; launches "
          f"exact on every rank (B5 and B6 once a bucket a step: {r0['buckets']} buckets of "
          f"{r0['leaves']} parameters); memory after init {held} GiB a rank (limit "
          f"{r0['limit_gib']:.2f}: {FSDP_MEMORY_SHARE} of a replica's parameters and Adam "
          f"state), after step 1 {held1} (limit {r0['step1_limit_gib']:.2f}: with its "
          f"gradients); steady step {step_s * 1e3:.1f} ms (slowest rank), "
          f"{batch * 2048 / step_s:.0f} tokens/s, peak memory per rank {peaks} GiB; rank 0 "
          f"launches {json.dumps(r0['launches'])}")


def rank_train(argv) -> int:
    """One rank of phase ranks (run by the launcher)."""
    import torch.distributed as dist

    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets
    from kungfu_tpu_torch.tools.step_profile import flagship_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bucket-mib", type=int, default=256)
    ap.add_argument("--n-kv-heads", type=int, default=0)
    ap.add_argument("--compression", default=None)
    args = ap.parse_args(argv)
    tf32_off()
    world = distributed.init_distributed(device="cuda")
    rank = dist.get_rank()
    bucket = args.bucket_mib << 20
    cfg, trainer, state, tokens = flagship_step(args.batch, args.seed, impl="pallas_ring",
                                                bucket_bytes=bucket or None,
                                                compression=args.compression,
                                                n_kv_heads=args.n_kv_heads)
    per = args.batch // world
    batch = tokens[rank * per:(rank + 1) * per]
    params = list(state.params.parameters())
    buckets = len(_pack_buckets(params, bucket)) if bucket else len(params)
    kernels = flash.KERNELS + RC.KERNELS + EF.KERNELS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    losses, times = [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t0)
        print(f"[ranks] rank {rank} step {step + 1}: loss {losses[-1]:.4f}, "
              f"{times[-1] * 1e3:.1f} ms", flush=True)
    launches = {k.name: k.launches for k in kernels}
    sums = [p.detach().view(torch.int32).to(torch.int64).sum().item() for p in params]
    every = [None] * world
    dist.all_gather_object(every, sums)
    gqa = cfg.kv_heads < cfg.n_heads
    per_layer = {flash.FLASH_FWD: True, flash.FLASH_BWD_DQ: True,
                 flash.FLASH_BWD_DKV: not gqa, flash.FLASH_BWD_DKV_GQA: gqa}
    per_bucket = {RC.RING_RS: not args.compression, RC.RING_AG: not args.compression,
                  RC.FUSED_RS: bool(args.compression), RC.FUSED_AG: bool(args.compression)}
    want = {k.name: cfg.n_layers * args.steps * on for k, on in per_layer.items()}
    want.update({k.name: buckets * args.steps * on for k, on in per_bucket.items()})
    # the residuals of a step's gradients: one grouped launch a table
    want[EF.EF_RESIDUAL.name] = (len(EF.ef_plan([p.numel() for p in params])) * args.steps
                                 * bool(args.compression))
    checks = {
        "loss finite": all(math.isfinite(x) for x in losses),
        "loss falls": losses[-1] < losses[0],
        "replicas bit-identical": all(s == every[0] for s in every),
        "launches": launches == want,
        "no JAX": jax_free(),
    }
    result = {"rank": rank, "backend": dist.get_backend(), "losses": losses,
              "step_s": statistics.median(times[1:]) if args.steps > 1 else times[0],
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "buckets": buckets,
              "kv_heads": cfg.kv_heads,
              "launches": launches, "expected_launches": want, "checks": checks,
              "ok": all(checks.values())}
    print(RANKS_LINE + json.dumps(result), flush=True)
    distributed.shutdown_distributed()
    return 0 if result["ok"] else 1


def rank_ring(argv) -> int:
    """One rank of phase ring (run by the launcher)."""
    from kungfu_tpu_torch.tools import ring_check

    tf32_off()
    rc = ring_check.main(argv)
    if not jax_free():
        print("chip_smoke: JAX or the JAX package was imported", file=sys.stderr)
        return 1
    return rc


def rank_shift(argv) -> int:
    """One rank of phase shift (run by the launcher)."""
    from kungfu_tpu_torch.tools import shift_check

    rc = shift_check.main(argv)
    if not jax_free():
        print("chip_smoke: JAX or the JAX package was imported", file=sys.stderr)
        return 1
    return rc


def rank_sp(argv) -> int:
    """One rank of phase sp (run by the launcher)."""
    import torch.distributed as dist

    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets
    from kungfu_tpu_torch.tools.step_profile import flagship_sp_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bucket-mib", type=int, default=256)
    args = ap.parse_args(argv)
    tf32_off()
    world = distributed.init_distributed(device="cuda")
    rank = dist.get_rank()
    bucket = args.bucket_mib << 20
    cfg, trainer, state, shard = flagship_sp_step(SP_BATCH, SP_SEQ, world, args.seed,
                                                  impl="pallas_ring", bucket_bytes=bucket or None)
    sp_rank = trainer.mesh.coord("sp")
    params = list(state.params.parameters())
    buckets = len(_pack_buckets(params, bucket)) if bucket else len(params)
    kernels = flash.KERNELS + RC.KERNELS + EF.KERNELS + FM.KERNELS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    FM.SHIFT.side_launches = 0
    losses, times = [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, shard)
        losses.append(metrics["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t0)
        print(f"[sp] rank {rank} step {step + 1}: loss {losses[-1]:.4f}, "
              f"{times[-1] * 1e3:.1f} ms", flush=True)
    launches = {k.name: k.launches for k in kernels}
    side = FM.SHIFT.side_launches
    sums = [p.detach().view(torch.int32).to(torch.int64).sum().item() for p in params]
    every = [None] * world
    dist.all_gather_object(every, sums)
    # per step: rank r runs r + 1 of the 4 blocks of each layer (the causal
    # ring skips the blocks of later ranks), the K/V pair shifts 3 times a
    # layer forward and 3 times backward, and every bucket is summed once
    blocks = cfg.n_layers * (sp_rank + 1) * args.steps
    want = {k.name: 0 for k in kernels}
    want.update({flash.FLASH_FWD.name: blocks, flash.FLASH_BWD_DQ.name: blocks,
                 flash.FLASH_BWD_DKV.name: blocks, RC.RING_RS.name: buckets * args.steps,
                 RC.RING_AG.name: buckets * args.steps,
                 FM.SHIFT.name: cfg.n_layers * 2 * (world - 1) * args.steps})
    checks = {
        "loss finite": all(math.isfinite(x) for x in losses),
        "loss falls": losses[-1] < losses[0],
        "replicas bit-identical": all(s == every[0] for s in every),
        "launches": launches == want,
        "every shift on the side stream": side == launches[FM.SHIFT.name],
        "no JAX": jax_free(),
    }
    result = {"rank": rank, "sp_rank": sp_rank, "backend": dist.get_backend(),
              "side_launches": side,
              "losses": losses,
              "step_s": statistics.median(times[1:]) if args.steps > 1 else times[0],
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "buckets": buckets,
              "launches": launches, "expected_launches": want, "checks": checks,
              "ok": all(checks.values())}
    print(SP_LINE + json.dumps(result), flush=True)
    distributed.shutdown_distributed()
    return 0 if result["ok"] else 1


def rank_fused(argv) -> int:
    """One rank of phase fused (run by the launcher)."""
    from kungfu_tpu_torch.tools import fused_check

    tf32_off()
    rc = fused_check.main(argv)
    if not jax_free():
        print("chip_smoke: JAX or the JAX package was imported", file=sys.stderr)
        return 1
    return rc


def rank_fsdp(argv) -> int:
    """One rank of phase fsdp (run by the launcher)."""
    import torch.distributed as dist

    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.tools.step_profile import flagship_fsdp_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=FSDP_STEPS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tf32_off()
    world = distributed.init_distributed(device="cuda")
    rank = dist.get_rank()
    cfg, trainer, state, batch = flagship_fsdp_step(args.batch, world, args.seed)
    torch.cuda.synchronize()
    init_bytes = torch.cuda.memory_allocated()  # the chunks, this rank's rows of the batch
    n_params = sum(math.prod(s) for s in trainer._shapes.values())
    n_leaves, n_buckets = len(trainer._shapes), len(trainer._buckets)
    limit = FSDP_MEMORY_SHARE * n_params * 4 * 3  # f32 parameters and two Adam moments
    limit1 = FSDP_MEMORY_SHARE * n_params * 4 * 4  # and the gradients
    kernels = flash.KERNELS + RC.KERNELS + EF.KERNELS + FM.KERNELS
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    losses, times = [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t0)
        if step == 0:
            step1_bytes = torch.cuda.memory_allocated()  # with AdamW's moments
        print(f"[fsdp] rank {rank} step {step + 1}: loss {losses[-1]:.4f}, "
              f"{times[-1] * 1e3:.1f} ms", flush=True)
    launches = {k.name: k.launches for k in kernels}
    want = {k.name: 0 for k in kernels}
    want.update({k.name: cfg.n_layers * args.steps
                 for k in (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV)})
    # one grouped gather a bucket forward, one grouped reduce-scatter backward
    want.update({RC.RING_AG.name: n_buckets * args.steps,
                 RC.RING_RS.name: n_buckets * args.steps})
    checks = {
        "loss finite": all(math.isfinite(x) for x in losses),
        "loss falls": losses[-1] < losses[0],
        "launches": launches == want,
        "memory after init": init_bytes <= limit,
        "memory after step 1": step1_bytes <= limit1,
        "no JAX": jax_free(),
    }
    result = {"rank": rank, "backend": dist.get_backend(), "losses": losses,
              "step_s": statistics.median(times[1:]) if args.steps > 1 else times[0],
              "init_gib": init_bytes / 2**30, "step1_gib": step1_bytes / 2**30,
              "limit_gib": limit / 2**30, "step1_limit_gib": limit1 / 2**30,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "leaves": n_leaves,
              "buckets": n_buckets,
              "launches": launches, "expected_launches": want, "checks": checks,
              "ok": all(checks.values())}
    print(FSDP_LINE + json.dumps(result), flush=True)
    distributed.shutdown_distributed()
    return 0 if result["ok"] else 1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "kungfu_tpu_torch")):
        print("chip_smoke: kungfu_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--rank-phase"]:  # one rank of a phase started by the launcher
        phase, rest = sys.argv[2], sys.argv[3:]
        workers = {"ring": rank_ring, "train": rank_train, "shift": rank_shift, "sp": rank_sp,
                   "fused": rank_fused, "fsdp": rank_fsdp}
        return workers[phase](rest)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank-steps", type=int, default=3)
    ap.add_argument("--bucket-mib", type=int, default=256,
                    help="bucket_bytes of phases ranks, gqa and sp in MiB (0: one ring call "
                    "per gradient)")
    args = ap.parse_args()
    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import ring_collectives as RC

    try:
        _, kind, count = phase_device()
        phase_build()
        results = [phase_kernels(args.seed), phase_kernels_gqa(args.seed)]
        wide, wide_launches = phase_wide(args.seed)
        results.append(wide)
        phase_model_check(args.seed)
        main_losses, n_params, fsdp_sizes, fsdp_groups = phase_main(args.steps, args.batch,
                                                                    args.seed)
        torch.cuda.empty_cache()
        phase_chunked(args.batch, args.seed)
        torch.cuda.empty_cache()  # the ranks need the card's memory
        gqa_loss, gqa_params, gqa_shapes = phase_gqa_reference(args.batch, args.seed)
        results.append(phase_ef(gqa_shapes, args.seed))
        results.append(phase_ring(n_params, gqa_params, fsdp_sizes, fsdp_groups, args.seed))
        ranks_launches, ranks_losses = phase_ranks(args.rank_steps, args.batch, args.seed,
                                                   args.bucket_mib, main_losses[0])
        gqa_launches, _ = phase_ranks(args.rank_steps, args.batch, args.seed, args.bucket_mib,
                                      gqa_loss, compression="int8")
        results.append(phase_shift(args.seed))
        sp_loss = phase_sp_reference(args.seed)
        sp_launches = phase_sp(SP_STEPS, args.seed, args.bucket_mib, sp_loss)
        fused, fused_launches = phase_fused(args.seed)
        results.append(fused)
        phase_fsdp(FSDP_STEPS, args.batch, args.seed, main_losses[0],
                   ranks_losses[:FSDP_STEPS])
        # each kernel's launches from the path that runs it
        launches = {name: n or gqa_launches[name] for name, n in ranks_launches.items()}
        launches[FM.SHIFT.name] = sp_launches[FM.SHIFT.name]
        for kern in (FM.AG_MATMUL, FM.MATMUL_RS):
            launches[kern.name] = fused_launches[kern.name]
        launches.update(wide_launches)
        check(all(launches.values()), f"a kernel of the main paths never launched: {launches}")
        check(jax_free(), "JAX or the JAX package was imported")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    errs, ms, plain, library, bounds = ({k: v for r in results for k, v in r[i].items()}
                                        for i in range(5))
    kernels = [{
        "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
        "launches": launches[k.name], "max_abs_err": errs[k.name], "ms": ms[k.name],
        "plain_ms": plain[k.name], "bound_ms": bounds[k.name][0],
        "bound_by": bounds[k.name][1], "library_ms": library[k.name],
    } for k in flash.KERNELS + flash.WIDE_KERNELS + RC.KERNELS + FM.KERNELS + EF.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
