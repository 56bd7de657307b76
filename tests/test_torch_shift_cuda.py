"""The ring shift kernel (B11) on cards, against its stacked plain
version, bit for bit.

Marked `cuda`; without a card every test skips (the check runs in a
fixture).  Run them on a machine with H100s with

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_shift_cuda.py

Each test starts n ranks through `python -m kungfu_tpu_torch.run`, each
running `kungfu_tpu_torch.tools.shift_check`: every rank rebuilds every
rank's payloads from the seed, shifts a K/V pair (one launch) at +1 and
-1 and an odd byte count at +1 and +2, and compares its result with
`torch.roll` over the ranks' payloads, with no tolerance; then the same
shifts interleaved, without a sync, with the ring kernels B5-B8 on
payloads of other sizes, each held against its stacked plain version; and
the planted faults (a pair shifted the wrong way, a 16-byte vector
corrupted) must be rejected.  The ranks share one card (a gloo group;
their kernels take turns on it) or have a card each (an NCCL group, needs
n cards).  A peer that skips a shift makes its neighbour's kernel give up
within its bounded wait and the wrapper raise, naming the source and
destination ranks.
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

KV = "2,2048,16,64"  # K and V of one ring-attention hop of the flagship at 8192 over 4 ranks


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the shift kernel has no CPU build")
    from kungfu_tpu_torch.ops import _build

    _build.build_all()  # once, before the ranks start
    return torch.cuda.device_count()


def _run(n: int, visible: str):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible, KFT_RING_TIMEOUT_S="60")
    rc, out, results = ring_check.launch(
        n, [sys.executable, "-m", "kungfu_tpu_torch.tools.shift_check", "--kv", KV,
            "--interleave", "--faults"], env=env, timeout=900, tag="SHIFT_CHECK ")
    assert rc == 0, out[-8000:]
    assert sorted(results) == list(range(n)), out[-8000:]
    for res in results.values():
        assert res["ok_all"], json.dumps(res["ok"])
        assert "interleaved fused_ring_all_reduce" in res["ok"]
        assert "kv+1 rejects a 16-byte vector corrupted" in res["ok"]
        # kv+1, kv-1, odd+1 (and odd+2 for n > 2), three interleaved shifts...
        assert res["launches"]["ring_shift"] >= 5, res["launches"]
        # ...and every ring kernel at least once between them
        assert all(res["launches"][k] > 0 for k in (
            "ring_reduce_scatter", "ring_all_gather", "ring_fused_reduce_scatter",
            "ring_fused_all_gather")), res["launches"]
    return results


@pytest.mark.parametrize("n", [2, 3, 4])
def test_shift_ranks_share_one_card(cards, n):
    results = _run(n, "0")
    assert {res["backend"] for res in results.values()} == {"gloo"}


def test_shift_on_own_cards(cards):
    if cards < 4:
        pytest.skip("needs 4 cards")
    results = _run(4, "0,1,2,3")
    assert {res["backend"] for res in results.values()} == {"nccl"}
    for r, res in sorted(results.items()):
        t = res["timing"]
        print(f"rank {r} {res['card']}: B11 {t['ms']:.3f} ms, NCCL batch_isend_irecv "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_note']})")


SKIPPING_PEER = textwrap.dedent("""
    import json, time
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import peer_memory

    distributed.init_distributed(device="cuda")
    k = torch.ones(2, 2048, 16, 64, dtype=torch.bfloat16, device="cuda")
    FM.ring_shift_pair(k, k, None, 1)  # every rank: the workspace is made and mapped
    peer_memory.check_all()
    if dist.get_rank() == 0:  # rank 1 skips the second shift
        t0 = time.monotonic()
        try:
            FM.ring_shift_pair(k, k, None, 1)
            peer_memory.check_all()
            out = {"raised": False}
        except peer_memory.RingError as e:
            out = {"raised": True, "seconds": time.monotonic() - t0, "message": str(e)}
        print("SKIPPED " + json.dumps(out), flush=True)
    dist.barrier()
    distributed.shutdown_distributed()
""")


def test_a_peer_that_skips_a_shift_makes_its_neighbour_raise(cards):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0", KFT_RING_TIMEOUT_S="3")
    rc, out, results = ring_check.launch(2, [sys.executable, "-c", SKIPPING_PEER], env=env,
                                         timeout=300, tag="SKIPPED ")
    assert rc == 0, out[-8000:]
    got = results[0]
    assert got["raised"], out[-8000:]
    assert 3 <= got["seconds"] < 30
    assert "rank 0/2" in got["message"] and "gave up after 3 s" in got["message"]
    assert "shift data of shift 1" in got["message"], got["message"]
    assert "source rank 1, destination rank 1" in got["message"], got["message"]
