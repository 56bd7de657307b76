"""The ring kernels (reduce-scatter B5, all-gather B6, and their
fused-codec forms B7, B8) on cards, against their stacked plain versions,
bit for bit.

Marked `cuda`; without a card every test skips (the check runs in a
fixture).  Run them on a machine with H100s with

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_ring_cuda.py

Each test starts n ranks through `python -m kungfu_tpu_torch.run`, each
running `kungfu_tpu_torch.tools.ring_check`: every rank rebuilds every
rank's input from the seed, runs ring_reduce_scatter, ring_all_gather and
ring_all_reduce (sum and mean) through the kernels and compares its result
with the stacked plain version, with no tolerance; the int8 and fp8
cases run fused_ring_all_reduce (sum and mean) through B7/B8 the same way,
and must also lie within the JAX package's quantization tolerance of the
exact sum.  The cases are f32 and bf16 of ragged sizes (not multiples of
n * 1024, rows not multiples of 4 at n = 3), and the planted faults (a
chunk misrouted, a hop left out; a hop's scales dropped, a block's codes
zeroed) must be rejected; B7 and B8 alone are each held to their plain
versions bit for bit, also at capped grids, at quantization blocks of 8,
32 and 256 values and at payloads that end mid-stage, mid-segment and
mid-vector, and call after call with changing sizes and grids while one
rank comes late to each (B8's check must reject a stage's record left
out and a scale wrong); a peer that runs B7 but never B8 makes B8 raise.
Plain and fused calls of
different sizes, interleaved as the buckets of a step interleave them,
stay bit-equal.
Groups of tensors through the grouped calls (one launch of B5 or B6 for up
to MAX_SEGMENTS tensors that fit a slot) are bit-equal tensor by tensor,
take the launches of their segment plan, reject planted faults (a tensor
shifted by a vector, a last value wrong, a hop left out), and their tables
may change from call to call between plain calls.  Ranks share one card (a gloo group; their kernels take turns
on it) or have a card each (an NCCL group, needs n cards).  A peer that
stops calling makes the kernel give up within its bounded wait and the
wrapper raise.  The last test prints the kernels' times against NCCL's on
four cards.
"""
from __future__ import annotations

import json
import os
import sys
import textwrap

import pytest
import torch

from kungfu_tpu_torch.tools import ring_check

pytestmark = pytest.mark.cuda

CASES = ("f32:1000003,bf16:4099,f32:8388608,bf16:3000001,"
         "int8:1000003,fp8:4099,int8:8388608,fp8:3000001")
FLAGSHIP_GRAD = 367_576_064  # parameters of the flagship GPT (models.transformer.FLAGSHIP_GPT)


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ring kernels have no CPU build")
    from kungfu_tpu_torch.ops import _build

    _build.build_all()  # once, before the ranks start
    return torch.cuda.device_count()


def _run(n: int, visible: str, cases: str, *extra: str):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible, KFT_RING_TIMEOUT_S="60")
    rc, out, results = ring_check.launch(
        n, [sys.executable, "-m", "kungfu_tpu_torch.tools.ring_check", "--cases", cases,
            "--faults", *extra], env=env, timeout=900)
    assert rc == 0, out[-8000:]
    assert sorted(results) == list(range(n)), out[-8000:]
    for r, res in results.items():
        assert res["ok"], json.dumps(res["cases"])
        for case in res["cases"]:  # faults are planted in the small cases, which span two chunks
            if case.get("size", 0) <= ring_check.FAULT_CASE_MAX and "group" not in case:
                assert {"rejects chunk misrouted", "rejects hop left out"} <= set(case["ok"]) \
                    or {"rejects scales of a hop dropped",
                        "rejects codes of a 256-value block zeroed"} <= set(case["ok"])
        # one launch of each kernel per call of its own, two of each all-reduce
        assert all(v > 0 for v in res["launches"].values()), res["launches"]
    return results


@pytest.mark.parametrize("n", [2, 3, 4])
def test_ranks_share_one_card(cards, n):
    results = _run(n, "0", CASES)
    assert {res["backend"] for res in results.values()} == {"gloo"}


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_on_their_own_cards(cards, n):
    if cards < n:
        pytest.skip(f"needs {n} cards")
    results = _run(n, ",".join(str(i) for i in range(n)), CASES)
    assert {res["backend"] for res in results.values()} == {"nccl"}


# The fused reduce-scatter B7 runs in stages of FRS_STAGE_VALUES values: a
# chunk of one short stage (100 values), chunks that end mid-stage and
# payloads that end mid-segment and mid-vector, int8 and fp8, sum and mean;
# B7 alone bit-equal to its plain version at its own grid and at grids of 1,
# 3 and 7 blocks (a block of many stages counts them in its flag as it goes).
# (f32:4099 runs B5/B6 beside them: `_run` wants every ring kernel launched.)
FUSED_STAGE_CASES = "int8:100,fp8:36827,int8:36827,fp8:131075,int8:1000003,fp8:8193,f32:4099"


def _check_fused_stages(results):
    for res in results.values():
        fused = [c for c in res["cases"] if c["dtype"] in ring_check.SCHEMES]
        assert len(fused) == 6, res
        for case in fused:
            assert {"rs", "rs grid 1", "rs grid 3", "rs grid 7", "fused_sum",
                    "fused_mean"} <= set(case["ok"]), case


@pytest.mark.parametrize("n", [2, 3, 4])
def test_fused_stages_share_one_card(cards, n):
    _check_fused_stages(_run(n, "0", FUSED_STAGE_CASES, "--grid", "1,3,7"))


@pytest.mark.parametrize("n", [2, 4])
def test_fused_stages_on_their_own_cards(cards, n):
    if cards < n:
        pytest.skip(f"needs {n} cards")
    _check_fused_stages(_run(n, ",".join(str(i) for i in range(n)), FUSED_STAGE_CASES,
                             "--grid", "1,3,7"))


def test_times_against_nccl(cards):
    """The kernels at the flagship's gradient size, f32, on four cards."""
    if cards < 4:
        pytest.skip("needs 4 cards")
    # (int8:4099 beside it: `_run` wants every ring kernel launched)
    results = _run(4, "0,1,2,3", f"f32:{FLAGSHIP_GRAD},int8:4099", "--iters", "5")
    for r, res in sorted(results.items()):
        case = res["cases"][0]
        print(f"rank {r} {res['card']}: kernel ms {case['ms']}, NCCL ms {case['library_ms']}, "
              f"bound ms {case['bound_ms']} ({case['bound_note']}), plain ms "
              f"{case.get('plain_ms')}")
        assert case["library_ms"] is not None


STUCK_PEER = textwrap.dedent("""
    import json, time
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import peer_memory
    from kungfu_tpu_torch.ops import ring_collectives as RC

    distributed.init_distributed(device="cuda")
    x = torch.ones(1 << 20, device="cuda")
    RC.ring_all_reduce(x)  # every rank: the workspace is made and mapped
    peer_memory.check_all()
    if dist.get_rank() == 0:  # rank 1 never makes the second call
        t0 = time.monotonic()
        try:
            RC.ring_all_reduce(x)
            peer_memory.check_all()
            out = {"raised": False}
        except peer_memory.RingError as e:
            out = {"raised": True, "seconds": time.monotonic() - t0, "message": str(e)}
        print("STUCK " + json.dumps(out), flush=True)
    dist.barrier()
    distributed.shutdown_distributed()
""")


@pytest.mark.parametrize("call", ["RC.ring_all_reduce(x)", "RC.fused_ring_all_reduce(x, None, 'int8')",
                                  "RC.ring_reduce_scatter_group([x.view(2, -1), x[:998].view(2, -1)])"],
                         ids=["plain", "fused", "group"])
def test_a_missing_peer_raises_instead_of_hanging(cards, call):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", KFT_RING_TIMEOUT_S="3")
    rc, out, results = ring_check.launch(
        2, [sys.executable, "-c", STUCK_PEER.replace("RC.ring_all_reduce(x)", call)], env=env,
        timeout=300, tag="STUCK ")
    assert rc == 0, out[-8000:]
    got = results[0]
    assert got["raised"], out[-8000:]
    assert 3 <= got["seconds"] < 30
    assert "rank 0/2" in got["message"] and "gave up after 3 s" in got["message"]


INTERLEAVED = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.compression import resolve
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.ops import peer_memory
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.tools.ring_check import make_inputs

    n = distributed.init_distributed(device="cuda")
    d = dist.get_rank()
    ok = []
    # buckets of a step: sizes that shrink and grow, plain and fused calls in turn
    for i, (size, kind) in enumerate([(3000001, "int8"), (1000003, "f32"), (4099, "fp8"),
                                      (5000000, "int8"), (777, "f32"), (2000003, "fp8")]):
        xs = make_inputs(n, size, torch.float32, i, torch.device("cuda"))
        if kind == "f32":
            got, want = RC.ring_all_reduce(xs[d], op="mean"), C._plain_ring_all_reduce(xs, "mean")[d]
        else:
            got = RC.fused_ring_all_reduce(xs[d], None, kind, "mean")
            want = C._plain_fused_ring_all_reduce(xs, resolve(kind), "mean")[d]
        ok.append(bool(torch.equal(got, want)))
    peer_memory.check_all()
    print("INTERLEAVED " + json.dumps({"ok": ok}), flush=True)
    distributed.shutdown_distributed()
""")


@pytest.mark.parametrize("n", [2, 3])
def test_plain_and_fused_calls_interleave(cards, n):
    """Each kind of call has its own flags, acknowledgements and slots, so
    calls of both kinds and of any sizes follow each other safely."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", KFT_RING_TIMEOUT_S="60")
    rc, out, results = ring_check.launch(n, [sys.executable, "-c", INTERLEAVED], env=env,
                                         timeout=600, tag="INTERLEAVED ")
    assert rc == 0, out[-8000:]
    assert sorted(results) == list(range(n)), out[-8000:]
    for r, res in results.items():
        assert all(res["ok"]), (r, res)


B7_BACK_TO_BACK = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.compression import resolve
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.ops import peer_memory
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.tools.ring_check import fused_grid, make_inputs, plain_fused_rs

    n = distributed.init_distributed(device="cuda")
    d = dist.get_rank()
    dev = torch.device("cuda")
    # B7 alone, call after call with no host sync between them, the sizes
    # shrinking and growing and the grid changing; before call i rank i % n
    # spins, so its left neighbour may finish call i - 1 and start call i
    # while it still reads that call's slots
    calls = [(3000001, "int8", 132), (100, "fp8", 1), (1000003, "int8", 7),
             (5000000, "fp8", 132), (36827, "int8", 3), (2000003, "int8", 66),
             (8193, "fp8", 132), (3000001, "fp8", 16), (1000003, "int8", 132)]
    xs = [make_inputs(n, size, torch.float32, 20 + i, dev) for i, (size, _, _) in enumerate(calls)]
    torch.cuda.synchronize()
    dist.barrier()
    got = []
    for i, (size, kind, grid) in enumerate(calls):
        cfg = resolve(kind)
        if d == i % n:
            torch.cuda._sleep(4_000_000)  # about 2 ms of an H100's clock
        with fused_grid(grid):
            got.append(RC._fused_rs(xs[i][d], cfg, C.fused_chunk_elems(size, n, cfg), None))
    peer_memory.check_all()
    ok = [bool(torch.equal(g, plain_fused_rs(x, resolve(kind), d)))
          for g, x, (_, kind, _) in zip(got, xs, calls)]
    print("B7 " + json.dumps({"ok": ok}), flush=True)
    distributed.shutdown_distributed()
""")


def _b7_back_to_back(n: int, visible: str):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible, KFT_RING_TIMEOUT_S="60")
    rc, out, results = ring_check.launch(n, [sys.executable, "-c", B7_BACK_TO_BACK], env=env,
                                         timeout=600, tag="B7 ")
    assert rc == 0, out[-8000:]
    assert sorted(results) == list(range(n)), out[-8000:]
    for r, res in results.items():
        assert len(res["ok"]) == 9 and all(res["ok"]), (r, res)


@pytest.mark.parametrize("n", [3, 4])
def test_b7_back_to_back_shares_one_card(cards, n):
    """B7 alone, call after call: a block stores into its right
    neighbour's slots only after that neighbour acknowledged every block of
    the earlier calls, whatever their sizes and grids."""
    _b7_back_to_back(n, "0")


def test_b7_back_to_back_on_their_own_cards(cards):
    if cards < 4:
        pytest.skip("needs 4 cards")
    _b7_back_to_back(4, "0,1,2,3")


# The fused all-gather B8 alone (ring_check holds it against
# `plain_fused_ag` on every rank's chunk as B7 leaves it): a chunk of one
# short stage, chunks that end mid-stage, payloads that end mid-segment and
# mid-vector (the last chunk's tail past the payload unwritten), int8 and
# fp8, quantization blocks of 8, 32 and 256 values, at its own grid and at
# grids of 1, 3 and 7 blocks (more blocks than stages included).
FUSED_AG_STAGE_CASES = ("int8:100,fp8/8:36827,int8/32:36827,fp8:131075,int8/8:1000003,"
                        "fp8/32:8193,int8:3000001,f32:4099")


def _check_fused_ag_stages(results):
    for res in results.values():
        fused = [c for c in res["cases"] if c["dtype"] in ring_check.SCHEMES]
        assert len(fused) == 7, res
        assert {c["block"] for c in fused} == {8, 32, 256}, res
        for case in fused:
            assert {"ag", "ag grid 1", "ag grid 3", "ag grid 7", "ag rejects a scale wrong",
                    "ag rejects a stage's record left out", "fused_sum",
                    "fused_mean"} <= set(case["ok"]), case


@pytest.mark.parametrize("n", [2, 3, 4])
def test_fused_ag_stages_share_one_card(cards, n):
    _check_fused_ag_stages(_run(n, "0", FUSED_AG_STAGE_CASES, "--grid", "1,3,7"))


@pytest.mark.parametrize("n", [2, 4])
def test_fused_ag_stages_on_their_own_cards(cards, n):
    if cards < n:
        pytest.skip(f"needs {n} cards")
    _check_fused_ag_stages(_run(n, ",".join(str(i) for i in range(n)), FUSED_AG_STAGE_CASES,
                                "--grid", "1,3,7"))


B8_BACK_TO_BACK = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.ops import peer_memory
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.tools.ring_check import (fused_config, fused_grid, make_inputs,
                                                   plain_fused_ag)

    n = distributed.init_distributed(device="cuda")
    d = dist.get_rank()
    dev = torch.device("cuda")
    # B8 alone, call after call with no host sync between them, the sizes
    # shrinking and growing and the grid changing; before call i rank i % n
    # spins, so its left neighbour may finish call i - 1 and start call i
    # while it still reads that call's slots
    calls = [(3000001, "int8", 132), (100, "fp8", 1), (1000003, "int8/8", 7),
             (5000000, "fp8", 132), (36827, "int8/32", 3), (2000003, "int8", 66),
             (8193, "fp8/8", 132), (3000001, "fp8", 16), (1000003, "int8", 132)]
    mines = []
    for i, (size, name, _) in enumerate(calls):
        chunk = C.fused_chunk_elems(size, n, fused_config(name))
        mines.append(make_inputs(n, chunk, torch.float32, 40 + i, dev))
    torch.cuda.synchronize()
    dist.barrier()
    got = []
    for i, (size, name, grid) in enumerate(calls):
        cfg = fused_config(name)
        if d == i % n:
            torch.cuda._sleep(4_000_000)  # about 2 ms of an H100's clock
        with fused_grid(grid):
            got.append(RC._fused_ag(mines[i][d], cfg, mines[i][d].numel(), size, None))
    peer_memory.check_all()
    ok = [bool(torch.equal(g, plain_fused_ag(m, fused_config(name), d, size)))
          for g, m, (size, name, _) in zip(got, mines, calls)]
    print("B8 " + json.dumps({"ok": ok}), flush=True)
    distributed.shutdown_distributed()
""")


def _b8_back_to_back(n: int, visible: str):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible, KFT_RING_TIMEOUT_S="60")
    rc, out, results = ring_check.launch(n, [sys.executable, "-c", B8_BACK_TO_BACK], env=env,
                                         timeout=600, tag="B8 ")
    assert rc == 0, out[-8000:]
    assert sorted(results) == list(range(n)), out[-8000:]
    for r, res in results.items():
        assert len(res["ok"]) == 9 and all(res["ok"]), (r, res)


@pytest.mark.parametrize("n", [3, 4])
def test_b8_back_to_back_shares_one_card(cards, n):
    """B8 alone, call after call: every thread stores into its right
    neighbour's slots only after that neighbour acknowledged every block
    of the earlier calls, whatever their sizes and grids."""
    _b8_back_to_back(n, "0")


def test_b8_back_to_back_on_their_own_cards(cards):
    if cards < 4:
        pytest.skip("needs 4 cards")
    _b8_back_to_back(4, "0,1,2,3")


B7_NOT_B8 = textwrap.dedent("""
    import json, time
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.compression import resolve
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.ops import peer_memory
    from kungfu_tpu_torch.ops import ring_collectives as RC

    n = distributed.init_distributed(device="cuda")
    cfg = resolve("int8")
    x = torch.ones(1 << 20, device="cuda")
    chunk = C.fused_chunk_elems(x.numel(), n, cfg)
    mine = RC._fused_rs(x, cfg, chunk, None)  # every rank: B7
    peer_memory.check_all()
    if dist.get_rank() == 0:  # rank 1 never runs B8
        t0 = time.monotonic()
        try:
            RC._fused_ag(mine, cfg, chunk, x.numel(), None)
            peer_memory.check_all()
            out = {"raised": False}
        except peer_memory.RingError as e:
            out = {"raised": True, "seconds": time.monotonic() - t0, "message": str(e)}
        print("STUCK " + json.dumps(out), flush=True)
    dist.barrier()
    distributed.shutdown_distributed()
""")


def test_a_peer_without_b8_makes_b8_raise(cards):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", KFT_RING_TIMEOUT_S="3")
    rc, out, results = ring_check.launch(2, [sys.executable, "-c", B7_NOT_B8], env=env,
                                         timeout=300, tag="STUCK ")
    assert rc == 0, out[-8000:]
    got = results[0]
    assert got["raised"], out[-8000:]
    assert 3 <= got["seconds"] < 30
    assert "rank 0/2" in got["message"] and "gave up after 3 s" in got["message"]


# Groups through the grouped B5/B6 (ring_check --groups): one tensor, two,
# the segment table's maximum, one more than it (two launches), unaligned
# and tiny rows, a group past one slot, in f32 and bf16.
_TINY = [1, 2, 3, 5, 7, 8, 9, 4]


def _group_spec() -> str:
    from kungfu_tpu_torch.ops.ring_collectives import MAX_SEGMENTS as M

    tiny = (_TINY * M)[:M]
    groups = ["f32:8", "f32:1+4099", "f32:" + "+".join(map(str, tiny)),
              "bf16:" + "+".join(map(str, tiny + [11])),
              "f32:1+255+256+1000+4099", "bf16:3+4099+8",
              "f32:" + "+".join(["262144", "256", "1048576"] * 3)]
    return ";".join(groups)


def _check_groups(results):
    from kungfu_tpu_torch.ops.ring_collectives import MAX_SEGMENTS

    for res in results.values():
        groups = [c for c in res["cases"] if "group" in c]
        assert len(groups) == 7, res
        for case in groups:
            assert case["ok"]["launches"], case
            assert {"rs rejects a hop left out", "ag rejects a tensor shifted by a vector",
                    "ag rejects a last value wrong"} <= set(case["ok"]), case
        by_count = {c["segments"]: c for c in groups}
        assert by_count[MAX_SEGMENTS]["launches"] == {"rs": 1, "ag": 1}
        assert by_count[MAX_SEGMENTS + 1]["launches"] == {"rs": 2, "ag": 2}
        assert by_count[9]["launches"]["rs"] > 1  # past one slot: split


@pytest.mark.parametrize("n", [2, 3, 4])
def test_groups_share_one_card(cards, n):
    _check_groups(_run(n, "0", "f32:4099,int8:4099", "--groups", _group_spec()))


@pytest.mark.parametrize("n", [2, 4])
def test_groups_on_their_own_cards(cards, n):
    if cards < n:
        pytest.skip(f"needs {n} cards")
    _check_groups(_run(n, ",".join(str(i) for i in range(n)), "f32:4099,int8:4099",
                       "--groups", _group_spec()))


CHANGING_TABLES = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.ops import peer_memory
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.tools.ring_check import make_inputs

    n = distributed.init_distributed(device="cuda")
    d = dist.get_rank()
    dev = torch.device("cuda")
    ok = []
    # back to back, tables of other counts and sizes each call, between
    # plain all-reduces (one-segment tables) of other sizes
    for i, rows in enumerate([[5, 4099, 1], [1 << 20], [7] * 40, [1000, 256, 3, 262144],
                              [1], [4099] * 3 + [1 << 18]]):
        dtype = torch.bfloat16 if i % 2 else torch.float32
        xs = [[x.view(n, row) for x in make_inputs(n, n * row, dtype, 10 * i + j, dev)]
              for j, row in enumerate(rows)]
        got = RC.ring_reduce_scatter_group([x[d] for x in xs])
        ok += [bool(torch.equal(g, C._plain_ring_reduce_scatter(x)[d])) for g, x in zip(got, xs)]
        mine = [[x[0] for x in per] for per in xs]
        got = RC.ring_all_gather_group([m[d] for m in mine])
        ok += [bool(torch.equal(g, C._plain_ring_all_gather(m)[d])) for g, m in zip(got, mine)]
        ys = make_inputs(n, 1000003 + 4096 * i, torch.float32, 100 + i, dev)
        ok.append(bool(torch.equal(RC.ring_all_reduce(ys[d]), C._plain_ring_all_reduce(ys)[d])))
    peer_memory.check_all()
    print("TABLES " + json.dumps({"ok": ok}), flush=True)
    distributed.shutdown_distributed()
""")


@pytest.mark.parametrize("n", [2, 4])
def test_changing_tables_and_plain_calls_interleave(cards, n):
    """Grouped calls whose tables change from call to call, between plain
    all-reduces: the sequence numbers and acknowledgements keep every
    call's slots apart, and every result stays bit-equal."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", KFT_RING_TIMEOUT_S="60")
    rc, out, results = ring_check.launch(n, [sys.executable, "-c", CHANGING_TABLES], env=env,
                                         timeout=600, tag="TABLES ")
    assert rc == 0, out[-8000:]
    assert sorted(results) == list(range(n)), out[-8000:]
    for r, res in results.items():
        assert all(res["ok"]) and len(res["ok"]) > 20, (r, res)
