"""The all-gather-matmul (B9) and matmul-reduce-scatter (B10) kernels on
cards, against their stacked plain versions.

Marked `cuda`; without a card every test skips (the check runs in a
fixture).  Run them on a machine with H100s with

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_fused_matmul_cuda.py

Each test starts n ranks through `python -m kungfu_tpu_torch.run`, each
running `kungfu_tpu_torch.tools.fused_check`: every rank rebuilds every
rank's operands from the seed, runs both kernels in bf16 at an MLP's
shapes and in f32 at 24 x (n*40) x 72 and 24 x 40 x 72 (nothing tiles),
and compares its result with its row of the stacked plain version:
integer-valued operands bit for bit, random ones within the normwise limit
of `utils.compare`; the planted faults (a shard consumed twice, a partial
dropped) must be rejected.  The ranks share one card (a gloo group; their
kernels take turns on it) or have a card each (`-k own_cards`: an NCCL
group, 4 cards, the flagship FSDP step's MLP shapes, with the times of
the kernels, the plain versions and the unfused NCCL arm).  A peer that
skips a call makes its neighbour's kernel give up within its bounded wait
and the wrapper raise, naming the kind and the hop.  Beside them: bf16
shapes at the edges of the tiles and of the copy engine's alignment
(`--cases`), calls at changing shapes in turn (slots reused through the
sequence numbers and acknowledgements), and the product body alone
(`mm_product`) against the f32 product.
"""
from __future__ import annotations

import os
import sys
import textwrap

import pytest
import torch

from kungfu_tpu_torch.tools import ring_check

pytestmark = pytest.mark.cuda

MLP = "1536,768,1024"  # tokens, d_model, d_ff: d_model divides over 2, 3 and 4 ranks


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU build")
    from kungfu_tpu_torch.ops import _build

    _build.build_all()  # once, before the ranks start
    return torch.cuda.device_count()


def _run(n: int, visible: str, mlp: str, cases: str = ""):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible, KFT_RING_TIMEOUT_S="60")
    rc, out, results = ring_check.launch(
        n, [sys.executable, "-m", "kungfu_tpu_torch.tools.fused_check", "--mlp", mlp,
            "--faults", "--cases", cases], env=env, timeout=900, tag="FUSED_CHECK ")
    assert rc == 0, out[-8000:]
    assert sorted(results) == list(range(n)), out[-8000:]
    extra = [c.split(":")[0] for c in cases.split(",") if c]
    for res in results.values():
        assert res["ok_all"], res["ok"]
        assert "b9 bfloat16 rand rejects a shard consumed twice" in res["ok"]
        assert "b10 float32 int rejects a partial dropped" in res["ok"]
        # two payloads of two dtypes each and of every extra case, before the timed calls
        assert res["launches"]["all_gather_matmul"] == 4 + 2 * extra.count("b9"), res["launches"]
        assert res["launches"]["matmul_reduce_scatter"] == 4 + 2 * extra.count("b10"), \
            res["launches"]
    return results


@pytest.mark.parametrize("n", [2, 3, 4])
def test_fused_ranks_share_one_card(cards, n):
    results = _run(n, "0", MLP)
    assert {res["backend"] for res in results.values()} == {"gloo"}


def _edge_cases(n: int) -> str:
    """bf16 shapes at the edges of the kernels' tiles and of the copy
    engine's alignment, as fused_check --cases: N = 75 (rows not whole 16
    bytes: the wrapper pads them); shards ks = 40 and 37 (below one 64-deep
    k-step, not a multiple of 8) and 104 (over one, not a multiple of 64);
    B9 with M = 24 and 1 (below one 128-row tile); B10 chunks of mc = 24 / n
    and 1 rows (below one 64-row tile); B10 at mc = 512 by N = 4096 (256
    tiles a hop over at most 132 blocks: two waves), B9 at M = 640 by N =
    2304 (45 tiles: fewer than the SMs) and at 4096 by 4096 (512 tiles: four
    waves)."""
    return ",".join([f"b9:24x{40 * n}x75", f"b9:1x{37 * n}x75", f"b9:640x{104 * n}x2304",
                     f"b9:4096x{64 * n}x4096", "b10:24x40x75", f"b10:{n}x37x75",
                     f"b10:{512 * n}x104x4096"])


@pytest.mark.parametrize("n", [2, 3, 4])
def test_fused_edge_shapes_share_one_card(cards, n):
    _run(n, "0", "256,48,64", _edge_cases(n))


def test_fused_on_own_cards(cards):
    if cards < 4:
        pytest.skip("needs 4 cards")
    results = _run(4, "0,1,2,3", "4096,1024,4096")
    assert {res["backend"] for res in results.values()} == {"nccl"}
    for r, res in sorted(results.items()):
        for kind, t in res["timing"].items():
            print(f"rank {r} {res['card']}: {kind} {t['shapes']} {t['ms']:.3f} ms, plain "
                  f"{t.get('plain_ms')}, NCCL unfused {t['library_ms']:.3f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']})")


SKIPPING_PEER = textwrap.dedent("""
    import json, time
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import peer_memory

    distributed.init_distributed(device="cuda")
    x = torch.ones(256, 512, dtype=torch.bfloat16, device="cuda")
    w = torch.ones(256, 384, dtype=torch.bfloat16, device="cuda")
    FM.all_gather_matmul(x, w)  # every rank: the workspace is made and mapped
    peer_memory.check_all()
    if dist.get_rank() == 0:  # rank 1 skips the second call
        t0 = time.monotonic()
        try:
            FM.all_gather_matmul(x, w)
            peer_memory.check_all()
            out = {"raised": False}
        except peer_memory.RingError as e:
            out = {"raised": True, "seconds": time.monotonic() - t0, "message": str(e)}
        print("SKIPPED " + json.dumps(out), flush=True)
    dist.barrier()
    distributed.shutdown_distributed()
""")


def test_a_peer_that_skips_a_call_makes_its_neighbour_raise(cards):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", KFT_RING_TIMEOUT_S="3")
    rc, out, results = ring_check.launch(2, [sys.executable, "-c", SKIPPING_PEER], env=env,
                                         timeout=300, tag="SKIPPED ")
    assert rc == 0, out[-8000:]
    got = results[0]
    assert got["raised"], out[-8000:]
    assert 3 <= got["seconds"] < 30
    assert "rank 0/2" in got["message"] and "gave up after 3 s" in got["message"]
    assert "all-gather-matmul data of hop 0" in got["message"], got["message"]


CHANGING_SHAPES = textwrap.dedent("""
    import json
    import torch
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import peer_memory
    from kungfu_tpu_torch.tools import fused_check

    n = distributed.init_distributed(device="cuda")
    d = torch.distributed.get_rank()
    shapes = [("b9", (256, 64 * n, 512)), ("b10", (128 * n, 96, 256)), ("b9", (40, 8 * n, 24)),
              ("b10", (8 * n, 1000, 72)), ("b9", (300, 200 * n, 1000)), ("b10", (64 * n, 64, 64))]
    ok = []
    for rnd in range(2):  # every shape twice, each call a new sequence number
        for i, (kind, s) in enumerate(shapes):
            xs, ws = fused_check.operands(kind, n, s, torch.bfloat16, 100 * rnd + i, True, "cuda")
            got = fused_check.fused(kind, xs[d], ws[d])
            ok.append(torch.equal(got, fused_check.plain(kind, xs, ws)[d]))
    peer_memory.check_all()
    print("CHANGING " + json.dumps({"ok": ok, "launches": [FM.AG_MATMUL.launches,
                                                            FM.MATMUL_RS.launches]}), flush=True)
    distributed.shutdown_distributed()
""")


@pytest.mark.parametrize("n", [2, 4])
def test_repeated_calls_with_changing_shapes(cards, n):
    """Calls of B9 and B10 in turn at changing shapes (and so changing grids
    and slot sizes) reuse the workspace's slots through the sequence numbers
    and acknowledgements; every result equals the stacked plain version bit
    for bit (integer operands)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", KFT_RING_TIMEOUT_S="60")
    rc, out, results = ring_check.launch(n, [sys.executable, "-c", CHANGING_SHAPES], env=env,
                                         timeout=600, tag="CHANGING ")
    assert rc == 0, out[-8000:]
    assert sorted(results) == list(range(n)), out[-8000:]
    for res in results.values():
        assert res["ok"] == [True] * 12, res
        assert res["launches"] == [6, 6], res


@pytest.mark.parametrize("kind", ["b9", "b10"])
@pytest.mark.parametrize("shape", [(4096, 256, 4096), (256, 4096, 4096), (1, 8, 8), (24, 40, 75),
                                   (200, 37, 300), (129, 1000, 257), (64, 64, 128)])
def test_product_entry_matches_torch_matmul(cards, kind, shape):
    """B9's and B10's product body alone (`mm_product`, no peers) against
    the f32 product: integer operands with f32 out bit for bit, normal ones
    with bf16 out within the bf16 limit, at the per-hop shapes of the FSDP
    MLP, at shapes below one tile and at unaligned ones."""
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.tools import fused_time

    m, k, nn = shape
    res = fused_time.check(kind, m, k, nn, 7, torch.device("cuda"))
    assert res["ok"], res
    x, w = fused_time.operands(m, k, nn, 9, False, torch.device("cuda"))
    launched = FM.MM_PRODUCT.launches
    assert FM.mm_product(x, w, kind, torch.float32).shape == (m, nn)
    assert FM.MM_PRODUCT.launches == launched + 1
