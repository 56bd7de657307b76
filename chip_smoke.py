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
             causal), plus the ragged L=2000 and window=256 cases; times of
             kernel, plain version and the library call
             (scaled_dot_product_attention, a yardstick the port never
             calls), and the least time the card could take (bound)
 4. check    a small f32 model: flash kernels against full attention on the
             same weights (loss and every gradient)
 5. main     the flagship GPT (vocab 32000, d_model 1024, 24 layers, 16
             heads, d_ff 4096, seq 2048, bf16, RoPE, causal) training with
             DataParallelTrainer + synchronous_sgd(AdamW(3e-4, (0.9, 0.95),
             wd 1e-4)) for a few steps on one repeated random batch of 8, in
             this process: the loss must be finite and fall, and each
             kernel must launch once per layer per step
 6. ring     4 ranks started by `python -m kungfu_tpu_torch.run`, rank r on
             card r mod count (all four on a machine with one card), each
             running tools/ring_check: the ring reduce-scatter (B5) and
             all-gather (B6) kernels and their all-reduce against the
             stacked plain versions, bit for bit, in f32 at the flagship's
             gradient size, in bf16 at 64M values and in a ragged f32 case
             of 1,000,003 values, with planted faults rejected; their times
             (median of 5 calls, CUDA events), the plain versions' times,
             NCCL's where every rank has a card of its own, and the bound
 7. ranks    the new main path: the same flagship GPT on 4 ranks started by
             the launcher, batch 2 each (the same 8 sequences as phase main),
             synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), impl="pallas_ring",
             bucket_bytes=--bucket-mib MiB) for --rank-steps steps: loss
             finite and falling, the first step's loss within 1e-2 of phase
             main's, the replicas bit-identical after the last step (a
             checksum of every parameter's bits, gathered over the group),
             each flash kernel launched once per layer per step and each
             ring kernel once per bucket per step on every rank
 8. report   one JSON line of kernels (launches from rank 0 of phase ranks),
             then the last line {"ok": true, "device": {"platform": "gpu", ...}}

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
N_RANKS = 4
RANKS_LINE = "RANKS_RESULT "


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

    rc, out, results = ring_check.launch(
        N_RANKS, [sys.executable, os.path.abspath(__file__), "--rank-phase", *worker_args],
        timeout=timeout, tag=tag)
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
    scale = D ** -0.5
    errs = {k.name: 0.0 for k in flash.KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for L, window in ((2048, 0), (2000, 0), (2048, 256)):
        q, k, v, do = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = flash.flash_fwd(q, k, v, scale, True, window)
        o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, True, window)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True, window)
        dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True, window)
        dq_ref, dk_ref, dv_ref = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale,
                                                       True, 128, window)
        torch.cuda.synchronize()
        case = f"L={L} window={window}"
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
        print(f"[kernels] {n}: {ms[n]:.3f} ms, plain {plain[n]:.3f} ms, bound "
              f"{bounds[n][0]:.4f} ms ({bounds[n][1]}: {work[n][0] / 1e9:.1f} GFLOP, "
              f"{work[n][1] / 1e6:.1f} MB), {work[n][0] / ms[n] / 1e9:.1f} TFLOP/s achieved")
    print(f"[kernels] library scaled_dot_product_attention: forward {lib_fwd:.3f} ms, "
          f"backward (dq, dk, dv in one call) {lib_bwd:.3f} ms; plain backward computes dq, "
          f"dk and dv in one pass ({plain_bwd:.3f} ms)")
    return errs, ms, plain, library, bounds


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
        check(launched == ([2, 2, 2] if attention == "flash" else [0, 0, 0]),
              f"model check ({attention}): kernel launches {launched}")
        results.append((loss.item(), {n: p.grad for n, p in model.named_parameters()}))
    (l_flash, g_flash), (l_full, g_full) = results
    check(abs(l_flash - l_full) <= TOL_MODEL_LOSS,
          f"model check: loss flash {l_flash} vs full {l_full}")
    worst = max(((g_flash[n] - g_full[n]).norm() / g_full[n].norm()).item() for n in g_full)
    check(worst <= TOL_MODEL_GRAD, f"model check: gradient normwise rel err {worst:.3g}")
    print(f"[check] f32 2-layer model, flash kernels vs full attention: loss {l_flash:.6f} vs "
          f"{l_full:.6f}, worst gradient normwise relative error {worst:.3g}")


def phase_main(steps: int, batch: int, seed: int):
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.tools.step_profile import flagship_step

    world = distributed.init_distributed(device="cuda")
    cfg, trainer, state, tokens = flagship_step(batch, seed)
    n_params = sum(p.numel() for p in state.params.parameters())
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
    want = cfg.n_layers * steps
    check(all(n == want for n in launches.values()),
          f"kernel launches {launches}, expected {want} each ({cfg.n_layers} per step)")
    step_s = statistics.median(times[1:]) if steps > 1 else times[0]
    print(f"[main] steady step {step_s * 1e3:.1f} ms (median of steps 2-{steps}), "
          f"{batch * cfg.max_len / step_s:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {json.dumps(launches)}")
    return losses, n_params


def phase_ring(n_params: int, seed: int):
    """B5 and B6 on N_RANKS ranks against their stacked plain versions."""
    from kungfu_tpu_torch.ops import ring_collectives as RC

    cases = f"f32:{n_params},bf16:{64 << 20},f32:1000003"
    _, res = spawn_ranks(["ring", "--cases", cases, "--iters", "5", "--seed", str(seed),
                          "--faults"], "RING_CHECK ", 600)
    for r, rr in sorted(res.items()):
        for case in rr["cases"]:
            check(all(case["ok"].values()), f"ring rank {r} {case['dtype']} x {case['size']}: "
                  f"{json.dumps(case['ok'])}, max abs err {json.dumps(case['max_abs_err'])}")
    r0 = res[0]
    print(f"[ring] {N_RANKS} ranks, backend {r0['backend']}, {r0['card']}: every rank's "
          f"reduce-scatter, all-gather and all-reduce (sum, mean) equal the stacked plain "
          f"versions bit for bit; planted faults rejected")
    for i, case in enumerate(r0["cases"]):
        slowest = {k: max(rr["cases"][i]["ms"][k] for rr in res.values()) for k in case["ms"]}
        lib = case["library_ms"]
        lib = ({k: max(rr["cases"][i]["library_ms"][k] for rr in res.values()) for k in lib}
               if lib else None)
        print(f"[ring] {case['dtype']} x {case['size']} (chunk {case['chunk']}): kernel ms "
              f"(slowest rank's median) rs {slowest['rs']:.3f} ag {slowest['ag']:.3f} "
              f"all-reduce {slowest['ar']:.3f}; plain ms {json.dumps(case['plain_ms'])}; "
              f"bound ms {json.dumps(case['bound_ms'])} ({case['bound_note']}); NCCL ms "
              f"{json.dumps(lib) if lib else 'null: ' + case['library_note']}")
        case["slowest_ms"], case["library_slowest_ms"] = slowest, lib
    big = r0["cases"][0]  # the flagship's gradient size
    keys = {RC.RING_RS.name: "rs", RC.RING_AG.name: "ag"}
    errs = {name: max(c["max_abs_err"][k] for rr in res.values() for c in rr["cases"])
            for name, k in keys.items()}
    ms = {name: big["slowest_ms"][k] for name, k in keys.items()}
    plain = {name: big["plain_ms"][k] for name, k in keys.items()}
    library = {name: (big["library_slowest_ms"][k] if big["library_slowest_ms"] else None)
               for name, k in keys.items()}
    bounds = {name: (big["bound_ms"][k], "bytes") for name, k in keys.items()}
    return errs, ms, plain, library, bounds


def phase_ranks(steps: int, batch: int, seed: int, bucket_mib: int, main_loss1: float):
    """The flagship S-SGD step on N_RANKS ranks through the ring kernels."""
    out, res = spawn_ranks(["train", "--steps", str(steps), "--batch", str(batch), "--seed",
                            str(seed), "--bucket-mib", str(bucket_mib)], RANKS_LINE, 900)
    for line in out.splitlines():
        if "[ranks]" in line:
            print(line)
    for r, rr in sorted(res.items()):
        check(rr["ok"], f"ranks: rank {r} failed its checks: {json.dumps(rr['checks'])}")
    r0 = res[0]
    loss1 = r0["losses"][0]
    check(abs(loss1 - main_loss1) <= TOL_RANKS_LOSS,
          f"ranks: first-step loss {loss1} vs phase main's {main_loss1}")
    step_s = max(rr["step_s"] for rr in res.values())
    peaks = " ".join(f"{rr['peak_gib']:.2f}" for rr in res.values())
    print(f"[ranks] {N_RANKS} ranks x batch {batch // N_RANKS} ({r0['backend']}, "
          f"{r0['buckets']} buckets of at most {bucket_mib} MiB): losses "
          f"{' '.join(f'{x:.4f}' for x in r0['losses'])}, first step {loss1:.4f} vs phase "
          f"main's {main_loss1:.4f}; replicas bit-identical; steady step "
          f"{step_s * 1e3:.1f} ms (slowest rank), {batch * 2048 / step_s:.0f} tokens/s, peak "
          f"memory per rank {peaks} GiB; "
          f"rank 0 launches {json.dumps(r0['launches'])}")
    return r0["launches"]


def rank_train(argv) -> int:
    """One rank of phase ranks (run by the launcher)."""
    import torch.distributed as dist

    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets
    from kungfu_tpu_torch.tools.step_profile import flagship_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bucket-mib", type=int, default=256)
    args = ap.parse_args(argv)
    tf32_off()
    world = distributed.init_distributed(device="cuda")
    rank = dist.get_rank()
    bucket = args.bucket_mib << 20
    cfg, trainer, state, tokens = flagship_step(args.batch, args.seed, impl="pallas_ring",
                                                bucket_bytes=bucket or None)
    per = args.batch // world
    batch = tokens[rank * per:(rank + 1) * per]
    params = list(state.params.parameters())
    buckets = len(_pack_buckets(params, bucket)) if bucket else len(params)
    kernels = flash.KERNELS + RC.KERNELS
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
    want = {k.name: cfg.n_layers * args.steps for k in flash.KERNELS}
    want.update({k.name: buckets * args.steps for k in RC.KERNELS})
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "kungfu_tpu_torch")):
        print("chip_smoke: kungfu_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--rank-phase"]:  # one rank of phase ring or ranks
        phase, rest = sys.argv[2], sys.argv[3:]
        return rank_ring(rest) if phase == "ring" else rank_train(rest)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank-steps", type=int, default=3)
    ap.add_argument("--bucket-mib", type=int, default=256,
                    help="bucket_bytes of phase ranks in MiB (0: one ring call per gradient)")
    args = ap.parse_args()
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import ring_collectives as RC

    try:
        _, kind, count = phase_device()
        phase_build()
        results = [phase_kernels(args.seed)]
        phase_model_check(args.seed)
        main_losses, n_params = phase_main(args.steps, args.batch, args.seed)
        torch.cuda.empty_cache()  # the ranks need the card's memory
        results.append(phase_ring(n_params, args.seed))
        launches = phase_ranks(args.rank_steps, args.batch, args.seed, args.bucket_mib,
                               main_losses[0])
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
    } for k in flash.KERNELS + RC.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
