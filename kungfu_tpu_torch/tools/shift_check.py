"""The ring shift kernel (B11) against its stacked plain version, run as one rank.

    python -m kungfu_tpu_torch.run -np 4 python -m kungfu_tpu_torch.tools.shift_check \\
        [--kv 2,2048,16,64] [--odd 1000003] [--gossip BYTES] [--interleave] [--faults] \\
        [--beside-flash] [--grid 8,16,32,66] [--iters 5] [--seed 0] [--device cpu]

Every rank makes every rank's payloads from the seed on its own device, so
the check needs no communication.  Cases, each held against the stacked
plain version (`ops.fused_matmul._plain_ring_shift`, `torch.roll` over the
ranks' payloads) bit for bit:

  kv+1, kv-1   ring_shift_pair(k, v) at shift +1 and -1: K and V of one
               ring-attention hop, bf16 [B, L, H, D] (`--kv`), one launch
  odd+1, odd+2 ring_shift of `--odd` bytes (uint8), a count that is not a
               multiple of the kernel's 16-byte vectors; +2 stores into a
               peer that is not a neighbour (n > 2)
  gossip-1, gossip-2  (with `--gossip BYTES`) ring_shift of one uint8
               payload of BYTES at the gossip pull's shifts (rank i
               pulls i + 1, i + 2): a packed chunk of
               `optimizers.gossip.pair_averaging`
  gossip int8 pair-1  ring_shift_pair of an int8 pull's two payloads of
               unequal sizes and dtypes: BYTES uint8 codes and an f32
               scale a block of 256 codes

`--interleave` then issues, back to back on the same group and without a
sync, the ring kernels B5-B8 on payloads of other sizes between shifts of
both directions, and holds every result against its plain version: the
kinds keep their own flags, counters and slots.  `--faults` shows that
the comparison rejects a pair shifted the wrong way and one 16-byte
vector corrupted.  `--beside-flash` shifts the pair as ring attention
does, on the group's side stream (`ring_shift_pair_async`), while a flash
forward at ring attention's block shape (q, k, v of `--kv`, not causal)
runs on the current stream: both bit-equal to their results alone, and
on a card the times of each alone and of both together.  `--grid 8,16,32`
repeats kv+1 and odd+1 with B11's grid set to each of those block counts
(every rank the same), bit for bit, and on a card times the pair at each.

On a card, B11 is then timed on the kv+1 pair, on every rank at once.
With a card per rank: the median of `--iters` calls between two CUDA
events ("ms", the wrapper's issue included, as earlier versions read it),
and the device time alone ("device_ms": each call queued behind a spin
kernel after a barrier, so it starts on every rank together, within the
hosts' skew; the grid sweep and the case beside a flash call are timed
so too); "host_ms" is the wrapper's issue alone.  With ranks sharing a card, which runs them in turn, a rank's
events can miss the others' turns, so every rank issues `--iters` calls
between two barriers taken after a device sync, and the wall time over
`--iters` is the time of a call of all ranks.  Rank 0 alone times
the stacked plain version (every rank's result in one process).  Where
every rank has a card of its own (an NCCL group), every rank also times
NCCL's `batch_isend_irecv` of the same pair, a yardstick the port never
calls.  The bound is the larger of two times: the bytes a rank sends over
450 GB/s of NVLink each way (only between cards), and the bytes the ranks
of one card read and write, each input read once and each output written
once, over its 3.35 TB/s.

Prints one line `SHIFT_CHECK {json}` and exits non-zero when a check
failed.  Start it with `ring_check.launch`.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import distributed
from ..compression import config as comp_config
from ..ops import collective as C
from ..ops import flash
from ..ops import fused_matmul as FM
from ..ops import peer_memory
from ..ops import ring_collectives as RC
from .ring_check import (HBM_BYTES_PER_S, NVLINK_BYTES_PER_S, _host_ms, _median_ms, _primed_ms,
                         make_inputs)

LINE = "SHIFT_CHECK "


def stacked(n: int, shape: Sequence[int], dtype: torch.dtype, seed: int, device
            ) -> torch.Tensor:
    """Every rank's payload, rank-major: normal values from (seed, rank)
    for a float dtype, random bytes for uint8."""
    out = []
    for r in range(n):
        gen = torch.Generator(device=device).manual_seed(seed * 1013 + r)
        if dtype == torch.uint8:
            out.append(torch.randint(0, 256, tuple(shape), generator=gen, device=device,
                                     dtype=torch.uint8))
        else:
            out.append(torch.randn(tuple(shape), generator=gen, device=device).to(dtype))
    return torch.stack(out)


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item() if got.numel() else 0.0


def bound_ms(n: int, nbytes: int, own_cards: bool) -> float:
    """Least time of one shift of `nbytes` a rank: the bytes it sends over
    NVLink (between cards) or all ranks' reads and writes on one card."""
    t_link = nbytes / NVLINK_BYTES_PER_S if own_cards else 0.0
    t_mem = (1 if own_cards else n) * 2 * nbytes / HBM_BYTES_PER_S
    return max(t_link, t_mem) * 1e3


def planted_faults(got: Sequence[torch.Tensor], xs: Sequence[torch.Tensor], d: int,
                   shift: int) -> Dict[str, List[torch.Tensor]]:
    """Rank d's result of a pair shift with one fault each: the pair
    shifted the wrong way (n > 2), a 16-byte vector of k with its bits
    flipped."""
    n = xs[0].shape[0]
    faults = {}
    if n > 2:
        faults["shifted the wrong way"] = [FM._plain_ring_shift(x, -shift)[d] for x in xs]
    k = got[0].clone()
    raw = k.view(-1).view(torch.uint8)
    mid = raw.numel() // 32 * 16  # a vector in the middle
    raw[mid:mid + 16] = ~raw[mid:mid + 16]
    faults["a 16-byte vector corrupted"] = [k, got[1]]
    return faults


def run_cases(n: int, d: int, kv: Sequence[int], odd: int, seed: int, device,
              faults: bool) -> Dict:
    ok, err = {}, {}
    ks, vs = (stacked(n, kv, torch.bfloat16, seed + i, device) for i in (0, 1))
    for shift in (1, -1):
        got = FM.ring_shift_pair(ks[d], vs[d], None, shift)
        want = [FM._plain_ring_shift(x, shift)[d] for x in (ks, vs)]
        key = f"kv{shift:+d}"
        ok[key] = all(torch.equal(g, w) for g, w in zip(got, want))
        err[key] = max(_err(g, w) for g, w in zip(got, want))
        if faults:
            for name, bad in planted_faults(got, (ks, vs), d, shift).items():
                ok[f"{key} rejects {name}"] = not all(
                    torch.equal(g, b) for g, b in zip(got, bad))
    xs = stacked(n, (odd,), torch.uint8, seed + 2, device)
    for shift in (1, 2) if n > 2 else (1,):
        key = f"odd{shift:+d}"
        got = FM.ring_shift(xs[d], None, shift)
        want = FM._plain_ring_shift(xs, shift)[d]
        ok[key], err[key] = torch.equal(got, want), _err(got, want)
    return {"ok": ok, "max_abs_err": err}


def run_gossip(n: int, d: int, nbytes: int, seed: int, device) -> Dict:
    """The gossip pull's payloads: one uint8 chunk of `nbytes` at the
    pull's shifts, and an int8 wire's codes and scales as one pair."""
    ok, err = {}, {}
    xs = stacked(n, (nbytes,), torch.uint8, seed + 50, device)
    for shift in (-1, -2) if n > 2 else (-1,):
        key = f"gossip{shift:+d}"
        got = FM.ring_shift(xs[d], None, shift)
        want = FM._plain_ring_shift(xs, shift)[d]
        ok[key], err[key] = torch.equal(got, want), _err(got, want)
    del xs, got, want
    codes = stacked(n, (nbytes,), torch.uint8, seed + 51, device)
    scales = stacked(n, (-(-nbytes // 256),), torch.float32, seed + 52, device)
    got = FM.ring_shift_pair(codes[d], scales[d], None, -1)
    want = [FM._plain_ring_shift(x, -1)[d] for x in (codes, scales)]
    ok["gossip int8 pair-1"] = all(torch.equal(g, w) for g, w in zip(got, want))
    err["gossip int8 pair-1"] = max(_err(g, w) for g, w in zip(got, want))
    return {"ok": ok, "max_abs_err": err}


def run_interleaved(n: int, d: int, kv: Sequence[int], seed: int, device) -> Dict:
    """B11 between calls of B5-B8 of other sizes, no sync in between."""
    ks, vs = (stacked(n, kv, torch.bfloat16, seed + 10 + i, device) for i in (0, 1))
    odd = stacked(n, (4099,), torch.uint8, seed + 12, device)
    ar = make_inputs(n, 1000003, torch.float32, seed + 13, device)
    rs = [x[:n * 3001].view(n, 3001) for x in make_inputs(n, n * 3001, torch.float32,
                                                          seed + 14, device)]
    ag = make_inputs(n, 5003, torch.bfloat16, seed + 15, device)
    fused = make_inputs(n, 300007, torch.float32, seed + 16, device)
    cfg = comp_config.resolve("int8")
    calls = [
        ("ring_all_reduce", lambda: RC.ring_all_reduce(ar[d]),
         lambda: C._plain_ring_all_reduce(ar)[d]),
        ("kv+1", lambda: FM.ring_shift_pair(ks[d], vs[d], None, 1),
         lambda: tuple(FM._plain_ring_shift(x, 1)[d] for x in (ks, vs))),
        ("ring_reduce_scatter", lambda: RC.ring_reduce_scatter(rs[d]),
         lambda: C._plain_ring_reduce_scatter(rs)[d]),
        ("odd-1", lambda: FM.ring_shift(odd[d], None, -1),
         lambda: FM._plain_ring_shift(odd, -1)[d]),
        ("fused_ring_all_reduce", lambda: RC.fused_ring_all_reduce(fused[d], None, cfg),
         lambda: C._plain_fused_ring_all_reduce(fused, cfg)[d]),
        ("kv-1", lambda: FM.ring_shift_pair(ks[d], vs[d], None, -1),
         lambda: tuple(FM._plain_ring_shift(x, -1)[d] for x in (ks, vs))),
        ("ring_all_gather", lambda: RC.ring_all_gather(ag[d]),
         lambda: C._plain_ring_all_gather(ag)[d]),
        ("odd+1", lambda: FM.ring_shift(odd[d], None, 1),
         lambda: FM._plain_ring_shift(odd, 1)[d]),
    ]
    got = [fn() for _, fn, _ in calls]  # all issued before any is compared
    ok, err = {}, {}
    for (name, _, plain), g in zip(calls, got):
        w = plain()
        g, w = (g, w) if isinstance(g, tuple) else ((g,), (w,))
        ok[f"interleaved {name}"] = all(torch.equal(a, b) for a, b in zip(g, w))
        err[f"interleaved {name}"] = max(_err(a, b) for a, b in zip(g, w))
    return {"ok": ok, "max_abs_err": err}


def _span_ms(fn, iters: int, device) -> float:
    """Wall time per call of `iters` calls issued by every rank, from a
    barrier to the barrier after this rank's card ran its calls."""
    fn()
    torch.cuda.synchronize(device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize(device)
    dist.barrier()
    return (time.perf_counter() - t0) * 1e3 / iters


def _call_ms(fn, iters: int, device, own_cards: bool) -> float:
    """A call's device time: primed (`_primed_ms`) with a card per rank, the
    wall time of every rank's calls on a shared card."""
    return _primed_ms(fn, iters) if own_cards else _span_ms(fn, iters, device)


@contextlib.contextmanager
def shift_grid(blocks: int, device):
    """B11's grid set to `blocks` (every rank must set the same), its
    cached plans forgotten on the way in and out."""
    def forget():
        if device.type == "cuda":
            peer_memory.workspace(None, device).shift_plans.clear()

    old = FM.SHIFT_GRID
    FM.SHIFT_GRID = blocks
    forget()
    try:
        yield
    finally:
        FM.SHIFT_GRID = old
        forget()


def run_grids(n: int, d: int, kv: Sequence[int], odd: int, seed: int, device,
              grids: Sequence[int], iters: int, own_cards: bool) -> Dict:
    """kv+1 and odd+1 at each grid of `grids`, bit for bit; on a card the
    pair's time at each."""
    ks, vs = (stacked(n, kv, torch.bfloat16, seed + 30 + i, device) for i in (0, 1))
    xs = stacked(n, (odd,), torch.uint8, seed + 32, device)
    want_kv = [FM._plain_ring_shift(x, 1)[d] for x in (ks, vs)]
    want_odd = FM._plain_ring_shift(xs, 1)[d]
    ok, err, ms = {}, {}, {}
    for g in grids:
        with shift_grid(g, device):
            got = FM.ring_shift_pair(ks[d], vs[d], None, 1)
            ok[f"grid {g} kv+1"] = all(torch.equal(a, b) for a, b in zip(got, want_kv))
            err[f"grid {g} kv+1"] = max(_err(a, b) for a, b in zip(got, want_kv))
            got = FM.ring_shift(xs[d], None, 1)
            ok[f"grid {g} odd+1"], err[f"grid {g} odd+1"] = (torch.equal(got, want_odd),
                                                             _err(got, want_odd))
            if device.type == "cuda":
                dist.barrier()
                ms[str(g)] = _call_ms(lambda: FM.ring_shift_pair(ks[d], vs[d], None, 1), iters,
                                      device, own_cards)
    return {"ok": ok, "max_abs_err": err, "grid_ms": ms}


def run_beside_flash(n: int, d: int, kv: Sequence[int], seed: int, device, iters: int,
                     own_cards: bool) -> Dict:
    """The pair shifted on the side stream while a flash forward of ring
    attention's block shape runs on the current stream."""
    ks, vs = (stacked(n, kv, torch.bfloat16, seed + 40 + i, device) for i in (0, 1))
    q = stacked(1, kv, torch.bfloat16, seed + 42, device)[0]
    k, v = ks[d], vs[d]

    def attend():
        return flash.flash_attention_with_lse(q, k, v, causal=False)

    def both():
        wait = FM.ring_shift_pair_async(k, v, None, 1)
        out = attend()
        return wait(), out

    alone = attend()
    want = [FM._plain_ring_shift(x, 1)[d] for x in (ks, vs)]
    got, beside = both()
    ok = {"beside flash kv+1": all(torch.equal(a, b) for a, b in zip(got, want)),
          "flash beside the shift": all(torch.equal(a, b) for a, b in zip(beside, alone))}
    err = {"beside flash kv+1": max(_err(a, b) for a, b in zip(got, want)),
           "flash beside the shift": max(_err(a, b) for a, b in zip(beside, alone))}
    res = {"ok": ok, "max_abs_err": err}
    if device.type == "cuda":
        dist.barrier()
        res["beside_flash_ms"] = {
            "flash": _call_ms(attend, iters, device, own_cards),
            "shift": _call_ms(lambda: FM.ring_shift_pair(k, v, None, 1), iters, device,
                              own_cards),
            "both": _call_ms(both, iters, device, own_cards),
            "how": "flash forward [B, L, H, D] = --kv, not causal, on the current stream; "
                   "the shift alone on the current stream; both: the shift on the side "
                   "stream issued first, the flash call, then the wait"}
    return res


def time_pair(n: int, d: int, kv: Sequence[int], seed: int, device, iters: int,
              own_cards: bool) -> Dict:
    """Times of B11 on the kv+1 pair, its plain version and NCCL's."""
    ks, vs = (stacked(n, kv, torch.bfloat16, seed + i, device) for i in (0, 1))
    k, v = ks[d], vs[d]
    nbytes = 2 * k.numel() * k.element_size()

    def shift():
        return FM.ring_shift_pair(k, v, None, 1)

    dist.barrier()
    res = {"bytes": nbytes,
           "ms": _median_ms(shift, iters) if own_cards else _span_ms(shift, iters, device),
           "how": (f"median of {iters} calls between CUDA events, the host's issue "
                   "included" if own_cards else
                   f"wall time of {iters} calls of all ranks between barriers, per call")}
    dist.barrier()
    if own_cards:  # the card's own time, the issue ahead of it
        res["device_ms"] = _primed_ms(shift, iters)
        dist.barrier()
    res["host_ms"] = _host_ms(shift, iters)  # the wrapper's issue, the card idle
    dist.barrier()
    if d == 0:
        res["plain_ms"] = _median_ms(
            lambda: [FM._plain_ring_shift(x, 1) for x in (ks, vs)], iters)
    dist.barrier()
    if own_cards:
        outs = [torch.empty_like(k), torch.empty_like(v)]

        def nccl():
            ops = []
            for x, o in zip((k, v), outs):
                ops += [dist.P2POp(dist.isend, x, (d + 1) % n),
                        dist.P2POp(dist.irecv, o, (d - 1) % n)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()

        res["library_ms"] = _median_ms(nccl, iters)
    else:
        res["library_ms"] = None
        res["library_note"] = ("NCCL refuses two ranks of one communicator on one card: no "
                               "library time with ranks sharing a card")
    res["bound_ms"] = bound_ms(n, nbytes, own_cards)
    res["bound_note"] = ("NVLink bytes each rank sends vs device bytes of its card" if own_cards
                         else f"device bytes of all {n} ranks on one card")
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kv", default="2,2048,16,64", help="shape of K and of V, bf16")
    ap.add_argument("--odd", type=int, default=1000003, help="bytes of the odd case")
    ap.add_argument("--gossip", type=int, default=0,
                    help="bytes of the gossip pull's cases (0: none)")
    ap.add_argument("--interleave", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--beside-flash", action="store_true")
    ap.add_argument("--grid", default="", help="B11 grids to check (and time) the pair at")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = distributed.init_distributed(device=args.device)
    if n < 2:
        print("shift_check: needs a group of 2 or more ranks (start it with "
              "python -m kungfu_tpu_torch.run -np N)", file=sys.stderr)
        return 2
    d = dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" \
        else torch.device("cpu")
    own_cards = dist.get_backend() == "nccl"
    kv = [int(x) for x in args.kv.split(",")]
    for k in FM.KERNELS + RC.KERNELS:
        k.launches = 0
    FM.SHIFT.side_launches = 0
    res = run_cases(n, d, kv, args.odd, args.seed, device, args.faults)
    more = []
    if args.gossip:
        more.append(run_gossip(n, d, args.gossip, args.seed, device))
    if args.interleave:
        more.append(run_interleaved(n, d, kv, args.seed, device))
    if args.beside_flash:
        more.append(run_beside_flash(n, d, kv, args.seed, device, args.iters, own_cards))
    grids = [int(g) for g in args.grid.split(",") if g]
    if grids:
        more.append(run_grids(n, d, kv, args.odd, args.seed, device, grids, args.iters,
                              own_cards))
    for m in more:
        res["ok"].update(m.pop("ok"))
        res["max_abs_err"].update(m.pop("max_abs_err"))
        res.update(m)
    launches = {k.name: k.launches for k in FM.KERNELS + RC.KERNELS}
    launches["ring_shift on the side stream"] = FM.SHIFT.side_launches
    if device.type == "cuda":
        res["timing"] = time_pair(n, d, kv, args.seed, device, args.iters, own_cards)
    out = {"rank": d, "n": n, "device": str(device), "backend": dist.get_backend(),
           "card": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "kv": kv, "launches": launches, **res, "ok_all": all(res["ok"].values())}
    print(LINE + json.dumps(out), flush=True)
    distributed.shutdown_distributed()
    return 0 if out["ok_all"] else 1


if __name__ == "__main__":
    sys.exit(main())
