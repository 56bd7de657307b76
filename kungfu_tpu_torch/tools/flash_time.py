"""Time the flash kernels at the flagship attention shape on one card.

    python -m kungfu_tpu_torch.tools.flash_time [--iters 20] [--repeats 3] [--head-dim 64]
    python -m kungfu_tpu_torch.tools.flash_time --wide [--dtype fp16] [--steps 3]

Builds the kernels of the checkout it runs from, then times each kernel's
wrapper at B=8, H=16, L=2048, D=64, bf16, causal (`--head-dim D` keeps the
width H * D = 1024: D=128 runs H=8): the forward, dq and the MHA dk/dv
kernel (B3), and, where the checkout has it, the GQA dk/dv kernel (B4) at
Hkv=H/2.  Beside them, as yardsticks the port never calls, it times
PyTorch's scaled_dot_product_attention on the same inputs: its forward,
its backward (dq, dk and dv in one call) and its GQA backward
(enable_gqa=True).  Each reading is the mean of `--iters` back-to-back
launches (CUDA events); every kernel is read `--repeats` times, in turn.
Before timing, each kernel's output is held against its plain version on
the same inputs (normwise relative error, worst 64-row block, against
utils.compare.REL_LIMIT; the forward's lse against LSE_ATOL), and the run
exits non-zero if one fails.  Prints the card's name and power limit, then
one JSON line with the readings, each kernel's bound (the larger of its
FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s), its best reading's
TFLOP/s and its check.  To compare two versions of a kernel, run it from
both checkouts in one call to the card, in the order old, new, new, old.

`--wide` times the wide family instead, at Gemma 2B's attention (B=1, H=8,
Hkv=1, L=8192, D=256, causal; arXiv 2403.08295): its forward, dq and dk/dv
kernels (each launch of dk/dv counts for B4 here) beside SDPA's forward
and backward with enable_gqa=True, each checked against the plain versions
first; `--steps N` then trains a Gemma-2B-shaped model (d_model 2048, 8
heads of 256, one kv head, d_ff 16384, vocab 32000, 2 layers, bf16) N
steps on one sequence of 8192 tokens through DataParallelTrainer and
prints each step's time (host clock around a step that ends in a device
sync) and the median of steps 2..N.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM
PEAK_BYTES_PER_S = 3.35e12


def time_ms(fn, iters: int) -> float:
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


def check_kernels(flash, scale, mha, gqa):
    """Each kernel's outputs against its plain version on the same inputs:
    {kernel: {"worst_block": x, "limit": y, "ok": bool}} (the forward's
    lse by its largest absolute error too)."""
    from ..utils.compare import LSE_ATOL, REL_LIMIT, rel_errs

    out = {}
    for gqa_inputs, (q, k, v, do, lse, delta) in ((False, mha), (True, gqa)):
        tag = "_gqa" if gqa_inputs else ""
        limit = REL_LIMIT[q.dtype]
        o, lse_k = flash.flash_fwd(q, k, v, scale, True)
        o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, True, 0)
        lse_err = (lse_k - lse_ref).abs().max().item()
        worst = rel_errs(o, o_ref)[1]
        out["flash_fwd" + tag] = {"worst_block": round(worst, 6), "limit": limit,
                                  "lse_err": round(lse_err, 6),
                                  "ok": worst <= limit and lse_err <= LSE_ATOL}
        del o_ref, lse_ref
        dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True)
        dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True)
        refs = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True, 128, 0)
        for name, w in (("flash_bwd_dq" + tag, rel_errs(dq, refs[0])[1]),
                        ("flash_bwd_dkv" + tag, max(rel_errs(dk, refs[1])[1],
                                                    rel_errs(dv, refs[2])[1]))):
            out[name] = {"worst_block": round(w, 6), "limit": limit, "ok": w <= limit}
        del refs
    return out


# Gemma 2B's widths (arXiv 2403.08295 Table 1: d_model 2048, 8 heads of
# 256, one kv head, d_ff 16384); depth cut to 2 layers, vocab to 32000,
# GELU in place of GeGLU; one sequence of 8192 tokens
WIDE_MODEL = dict(vocab_size=32000, d_model=2048, n_layers=2, n_heads=8, n_kv_heads=1,
                  d_ff=16384, max_len=8192, rope=True, attention="flash")


def wide_steps(steps: int, seed: int = 0):
    """Times (ms, host clock, each step ending in a device sync) of `steps`
    training steps of the Gemma-2B-shaped model (WIDE_MODEL, bf16) on one
    card through DataParallelTrainer and AdamW, and their losses."""
    import time

    from ..models import TransformerConfig, TransformerLM
    from ..optimizers import adamw, synchronous_sgd
    from ..train import DataParallelTrainer
    from .step_profile import lm_step_loss

    cfg = TransformerConfig(**WIDE_MODEL, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = TransformerLM(cfg, device="cuda", generator=gen)
    trainer = DataParallelTrainer(lm_step_loss, synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95)),
                                  device="cuda")
    state = trainer.init(model)
    tokens = torch.randint(0, cfg.vocab_size, (1, cfg.max_len), generator=gen, device="cuda")
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, tokens)
        losses.append(metrics["loss"].item())  # .item() syncs the card
        times.append((time.perf_counter() - t0) * 1e3)
    return times, losses


def main_wide(args, card: str) -> int:
    from ..ops import flash
    from ..utils.compare import LSE_ATOL, REL_LIMIT, rel_errs

    B, H, HKV, L, D = 1, 8, 1, 8192, 256
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16}[args.dtype]
    scale = D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(B, L, HKV, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
    o, lse = flash.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()

    limit = REL_LIMIT[dtype]
    o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, True, 0)
    worst_o = rel_errs(o, o_ref)[1]
    lse_err = (lse - lse_ref).abs().max().item()
    del o_ref, lse_ref
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True)
    refs = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True, 128, 0)
    worst = {"flash_wide_fwd": worst_o, "flash_wide_dq": rel_errs(dq, refs[0])[1],
             "flash_wide_dkv": max(rel_errs(dk, refs[1])[1], rel_errs(dv, refs[2])[1])}
    checks = {n: {"worst_block": round(w, 6), "limit": limit, "ok": w <= limit}
              for n, w in worst.items()}
    checks["flash_wide_fwd"].update(lse_err=round(lse_err, 6),
                                    ok=worst_o <= limit and lse_err <= LSE_ATOL)
    del dq, dk, dv, refs

    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    fns = {
        "flash_wide_fwd": lambda: flash.flash_fwd(q, k, v, scale, True),
        "flash_wide_dq": lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True),
        "flash_wide_dkv": lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True),
        "sdpa_fwd_gqa": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                               enable_gqa=True),
        "sdpa_bwd_gqa": lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True),
    }
    ms = {name: [] for name in fns}
    for _ in range(args.repeats):
        for name, fn in fns.items():
            ms[name].append(round(time_ms(fn, args.iters), 4))

    pairs = B * H * L * (L + 1) // 2
    act, kv, row = B * L * H * D * 2, B * L * HKV * D * 2, B * H * L * 4
    work = {  # (FLOPs, bytes: each input read once, each output written once)
        "flash_wide_fwd": (4 * D * pairs, 2 * act + 2 * kv + row),
        "flash_wide_dq": (6 * D * pairs, 3 * act + 2 * kv + 2 * row),
        "flash_wide_dkv": (8 * D * pairs, 2 * act + 4 * kv + 2 * row),
    }
    bound = {n: round(max(f / PEAK_FLOPS, b / PEAK_BYTES_PER_S) * 1e3, 4)
             for n, (f, b) in work.items()}
    tflops = {n: round(work[n][0] / min(ms[n]) / 1e9, 1) for n in bound}
    record = {"card": card, "shape": {"B": B, "H": H, "Hkv": HKV, "L": L, "D": D,
                                      "dtype": args.dtype, "causal": True},
              "ms": ms, "bound_ms": bound, "tflops": tflops, "check": checks}
    if args.steps:
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot, qg, kg, vg, out
        torch.cuda.empty_cache()
        times, losses = wide_steps(args.steps)
        record["model_steps"] = {"ms": [round(t, 3) for t in times],
                                 "losses": [round(x, 6) for x in losses],
                                 "steady_ms": statistics.median(times[1:] or times)}
    print(json.dumps(record))
    return 0 if all(c["ok"] for c in checks.values()) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--wide", action="store_true",
                    help="the wide family at Gemma 2B's attention (see above)")
    ap.add_argument("--dtype", choices=("bf16", "fp16"), default="bf16", help="with --wide")
    ap.add_argument("--steps", type=int, default=0,
                    help="with --wide: train the Gemma-2B-shaped model this many steps")
    args = ap.parse_args(argv)
    from ..ops import flash

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card.splitlines()[0] if card else "nvidia-smi: no reading")
    if args.wide:
        return main_wide(args, card)
    B, L, D, dtype = 8, 2048, args.head_dim, torch.bfloat16
    H = 1024 // D
    scale = D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(hkv):
        q, do = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(B, L, hkv, D, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        o, lse = flash.flash_fwd(q, k, v, scale, True)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, lse, delta

    def sdpa_bwd(q, k, v, do, gqa):
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        qg, kg, vg = (x.requires_grad_() for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=gqa)
        return lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True)

    q, k, v, do, lse, delta = inputs(H)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fns = {
        "flash_fwd": lambda: flash.flash_fwd(q, k, v, scale, True),
        "flash_bwd_dq": lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True),
        "flash_bwd_dkv": lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True),
        "sdpa_fwd": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        "sdpa_bwd": sdpa_bwd(q, k, v, do, False),
    }
    g = inputs(H // 2)
    if hasattr(flash, "FLASH_BWD_DKV_GQA"):
        fns["flash_bwd_dkv_gqa"] = lambda: flash.flash_bwd_dkv(*g, scale, True)
    fns["sdpa_bwd_gqa"] = sdpa_bwd(*g[:4], True)
    checks = check_kernels(flash, scale, (q, k, v, do, lse, delta), g)
    ms = {name: [] for name in fns}
    for _ in range(args.repeats):
        for name, fn in fns.items():
            ms[name].append(round(time_ms(fn, args.iters), 4))

    pairs = B * H * L * (L + 1) // 2  # causal (query, key) pairs
    act, row = B * L * H * D * 2, B * H * L * 4
    work = {  # (FLOPs, bytes: each input read once, each output written once)
        "flash_fwd": (4 * D * pairs, 4 * act + row),
        "flash_bwd_dq": (6 * D * pairs, 5 * act + 2 * row),
        "flash_bwd_dkv": (8 * D * pairs, 6 * act + 2 * row),
        "flash_bwd_dkv_gqa": (8 * D * pairs, 4 * act + 2 * row),
    }
    bound = {n: round(max(f / PEAK_FLOPS, b / PEAK_BYTES_PER_S) * 1e3, 4)
             for n, (f, b) in work.items() if n in ms}
    tflops = {n: round(work[n][0] / min(ms[n]) / 1e9, 1) for n in bound}
    print(json.dumps({"card": card, "shape": {"B": B, "H": H, "L": L, "D": D, "dtype": "bf16",
                                              "causal": True, "Hkv_gqa": H // 2},
                      "ms": ms, "bound_ms": bound, "tflops": tflops, "check": checks}))
    return 0 if all(c["ok"] for c in checks.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
