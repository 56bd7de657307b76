"""The ring kernels (reduce-scatter B5, all-gather B6) on cards, against
their stacked plain versions, bit for bit.

Marked `cuda`; without a card every test skips (the check runs in a
fixture).  Run them on a machine with H100s with

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_ring_cuda.py

Each test starts n ranks through `python -m kungfu_tpu_torch.run`, each
running `kungfu_tpu_torch.tools.ring_check`: every rank rebuilds every
rank's input from the seed, runs ring_reduce_scatter, ring_all_gather and
ring_all_reduce (sum and mean) through the kernels and compares its result
with the stacked plain version, with no tolerance.  The cases are f32 and
bf16 of ragged sizes (not multiples of n * 1024, rows not multiples of 4
at n = 3), and the planted faults (a chunk misrouted, a hop left out) must
be rejected.  Ranks share one card (a gloo group; their kernels take turns
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

CASES = "f32:1000003,bf16:4099,f32:8388608,bf16:3000001"
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
            if case["size"] <= ring_check.FAULT_CASE_MAX:
                assert {"rejects chunk misrouted", "rejects hop left out"} <= set(case["ok"])
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


def test_times_against_nccl(cards):
    """The kernels at the flagship's gradient size, f32, on four cards."""
    if cards < 4:
        pytest.skip("needs 4 cards")
    results = _run(4, "0,1,2,3", f"f32:{FLAGSHIP_GRAD}", "--iters", "5")
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


def test_a_missing_peer_raises_instead_of_hanging(cards):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", KFT_RING_TIMEOUT_S="3")
    rc, out, results = ring_check.launch(2, [sys.executable, "-c", STUCK_PEER], env=env,
                                         timeout=300, tag="STUCK ")
    assert rc == 0, out[-8000:]
    got = results[0]
    assert got["raised"], out[-8000:]
    assert 3 <= got["seconds"] < 30
    assert "rank 0/2" in got["message"] and "gave up after 3 s" in got["message"]
