"""The port's recovery ladder (kungfu_tpu_torch.resilience) against the JAX
package's, on the CPU.

* `PeerList.ring_buddies` against the JAX assignment: one host, several
  hosts (host-disjoint), unbalanced hosts, every size a resize passes
  through, and n = 1;
* the snapshot blob: a model's and AdamW's state in bf16 and f32 round
  trip with every dtype and bit, counters included; garbage, foreign and
  torn blobs read as a miss; `BuddySnapshots` ships to its buddy's blob
  store and fetches it back, journals a ship to a dead buddy and keeps its
  own copy, and `KFT_BUDDY` switches the tier;
* `climb` with fakes gives the rung, source, step, offset, demotions and
  durability of `kungfu_tpu.resilience.climb` in every case of
  tests/unit/test_resilience.py::TestLadder;
* the checkpoint faults on the port's checkpoints: `crash_in_save` leaves a
  torn step and `corrupt_ckpt` a corrupt one, and `restore_latest_verified`
  demotes each onto the verified step before it; both drills of `python
  -m kungfu_tpu_torch.chaos --ckpt-drill` pass.
"""
from __future__ import annotations

import os
import types

import numpy as np
import pytest
import torch

from _torch_reference import jax_reference
from kungfu_tpu_torch.chaos import inject
from kungfu_tpu_torch.chaos import __main__ as cli
from kungfu_tpu_torch.checkpoint import CheckpointManager
from kungfu_tpu_torch.monitor import journal as J
from kungfu_tpu_torch.plan import PeerID, PeerList
from kungfu_tpu_torch.resilience import (BuddySnapshots, buddy_enabled, climb, pack_snapshot,
                                         unpack_snapshot)


@pytest.fixture(scope="module")
def jr():
    with jax_reference():
        from kungfu_tpu.plan import PeerID as JPeerID, PeerList as JPeerList
        from kungfu_tpu.resilience import ladder as jladder

        yield types.SimpleNamespace(PeerID=JPeerID, PeerList=JPeerList, ladder=jladder)


def _peers(cls_id, cls_list, *hosts):
    counts = {}
    out = []
    for h in hosts:
        counts[h] = counts.get(h, 0) + 1
        out.append(cls_id(h, 10000 + counts[h]))
    return cls_list(out)


# -- the buddy assignment ------------------------------------------------------------------

LAYOUTS = [("a", "a", "a"), ("a", "a", "b", "b"), ("a", "a", "a", "b"), ("a", "b", "b", "b", "b"),
           ("a",), ("a", "b"), ("a", "b", "c", "a", "b", "c"), ("a", "a")]


@pytest.mark.parametrize("hosts", LAYOUTS)
def test_ring_buddies_match_jax(jr, hosts):
    ours = _peers(PeerID, PeerList, *hosts).ring_buddies()
    assert ours == _peers(jr.PeerID, jr.PeerList, *hosts).ring_buddies()
    n = len(hosts)
    for r, b in enumerate(ours):
        assert b == -1 if n == 1 else (0 <= b < n and b != r)
        if len(set(hosts)) > 1:
            assert hosts[b] != hosts[r]


def test_ring_buddies_across_resizes_match_jax(jr):
    full = ("a", "a", "b", "b", "c", "c")
    for size in range(1, len(full) + 1):
        ours = PeerList(_peers(PeerID, PeerList, *full)[:size])
        theirs = jr.PeerList(_peers(jr.PeerID, jr.PeerList, *full)[:size])
        assert ours.ring_buddies() == theirs.ring_buddies() == ours.ring_buddies()


# -- the snapshot blob ---------------------------------------------------------------------

def _trained(dtype):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.LayerNorm(5)).to(dtype)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    model(torch.randn(3, 6, dtype=dtype)).square().mean().backward()
    opt.step()
    return model, opt


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_snapshot_round_trips_every_bit(dtype):
    model, opt = _trained(dtype)
    params, opt_sd = dict(model.state_dict()), opt.state_dict()
    blob = pack_snapshot(7, 224, {"params": params, "opt": opt_sd, "extra": np.arange(5)}, 1, 3)
    assert blob.dtype == np.uint8 and blob.ndim == 1
    got = unpack_snapshot(blob)
    assert (got["step"], got["offset"], got["origin_rank"], got["cluster_version"]) == \
        (7, 224, 1, 3)
    for k, v in params.items():
        g = got["state"]["params"][k]
        assert g.dtype == v.dtype and torch.equal(g.view(torch.uint8), v.view(torch.uint8))
    for i, st in opt_sd["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"]["opt"]["state"][i][k], v)
    assert got["state"]["opt"]["param_groups"] == opt_sd["param_groups"]
    np.testing.assert_array_equal(got["state"]["extra"], np.arange(5))
    fresh = torch.optim.AdamW(model.parameters(), lr=1e-2)
    fresh.load_state_dict(got["state"]["opt"])  # a usable optimizer state


def test_garbage_blob_is_a_miss():
    assert unpack_snapshot(np.zeros(16, np.uint8)) is None
    assert unpack_snapshot(np.frombuffer(b"not a snapshot", np.uint8)) is None
    blob = pack_snapshot(1, 2, {"params": {"w": torch.ones(1000)}, "opt": {}}, 0, 0)
    assert unpack_snapshot(blob[:200]) is None  # torn: shorter than its header says
    assert unpack_snapshot(blob) is not None


def test_buddy_ships_fetches_and_journals_a_miss(tmp_path, monkeypatch):
    from kungfu_tpu_torch.store import StoreClient, StoreServer, store_port
    from _torch_ranks import MAX_WORKER_PORT, _free_port_range
    from kungfu_tpu_torch.store import STORE_PORT_OFFSET

    base = _free_port_range(2, MAX_WORKER_PORT, (STORE_PORT_OFFSET,))
    peers = PeerList([PeerID("127.0.0.1", base), PeerID("127.0.0.1", base + 1)])
    client = StoreClient(retries=2, retry_interval=0.05)

    def fake_peer(rank):
        return types.SimpleNamespace(
            rank=rank, self_id=peers[rank], cluster_version=4, _store_server=None,
            config=types.SimpleNamespace(peers=peers),
            request=lambda r, name, wait, timeout: client.request(peers[r], name, wait=wait,
                                                                   timeout=timeout))

    jpath = str(tmp_path / "j.jsonl")
    monkeypatch.setenv(J.JOURNAL_FILE_ENV, jpath)
    J._reset_for_tests()
    model, opt = _trained(torch.bfloat16)
    buddy = BuddySnapshots(fake_peer(0), ship_timeout_s=2.0)
    assert (buddy.buddies, buddy.buddy_rank, buddy.cross_host) == ([1, 0], 1, False)
    buddy.update(3, 96, dict(model.state_dict()), opt.state_dict())  # no store: a miss
    assert buddy.latest()["step"] == 3 and buddy.ships[-1][3] is False
    assert [e["event"] for e in J.read_journal(jpath)] == ["buddy_ship_failed"]
    srv = StoreServer(port=store_port(peers[1].port)).start()
    try:
        buddy.update(4, 128, dict(model.state_dict()), opt.state_dict())
        assert buddy.ships[-1][3] is True
        ward = BuddySnapshots(fake_peer(1))
        ward.peer._store_server = srv
        assert ward.held_wards() == [str(peers[0])]
        got = buddy.fetch(timeout_s=5.0)
        assert (got["step"], got["offset"], got["origin_rank"]) == (4, 128, 0)
        for k, v in model.state_dict().items():
            assert torch.equal(got["state"]["params"][k], v)
    finally:
        srv.close()
        buddy.close()
        client.close()
        J._reset_for_tests()
    for off in ("0", "false", "off", "no", "OFF"):
        monkeypatch.setenv("KFT_BUDDY", off)
        assert not buddy_enabled()
    monkeypatch.setenv("KFT_BUDDY", "1")
    assert buddy_enabled()


# -- the ladder ------------------------------------------------------------------------------

class _FakeBuddy:
    buddy_rank = 1

    def __init__(self, own=None, fetched=None):
        self._own, self._fetched = own, fetched

    def latest(self):
        return self._own

    def fetch(self, timeout_s=10.0):
        return self._fetched


class _FakeCkpt:
    def __init__(self, result=None):
        self._result = result

    def restore_latest_verified(self, like=None):
        return self._result


def _snap(step, offset, scale):
    return {"step": step, "offset": offset,
            "state": {"params": {"w": np.full((2,), scale, np.float32)}, "opt": ()}}


def _boom():
    raise ValueError("Gloo allreduce failed: Connection closed by peer")


DISK = ({"params": "P", "opt": "O"}, {"step": 3, "trained_samples": 96}, 3,
        [{"candidate": "step:5", "reason": "checksum mismatch"}])
LADDER_CASES = {
    "live_wins_when_readable": (lambda: ("P", "O"), _FakeBuddy(), None, False),
    "poisoned_live_falls_to_self": (_boom, _FakeBuddy(own=_snap(6, 192, 1.0)), None, False),
    "missing_self_falls_to_peer_fetch": (_boom, _FakeBuddy(fetched=_snap(4, 128, 2.0)), None,
                                         False),
    "empty_ram_tier_falls_to_verified_disk": (_boom, _FakeBuddy(), _FakeCkpt(DISK), False),
    "exhausted_ladder_returns_none": (_boom, _FakeBuddy(), _FakeCkpt(None), False),
    "exhausted_ladder_without_ckpt": (_boom, _FakeBuddy(), None, False),
    "kft_buddy_0_skips_the_ram_tier": (lambda: ("P", "O"), _FakeBuddy(own=_snap(6, 192, 1.0)),
                                       _FakeCkpt((DISK[0], DISK[1], 3, [])), True),
    "no_buddy_goes_to_disk": (lambda: ("P", "O"), None, _FakeCkpt(DISK), False),
}


def _outcome(out):
    if out is None:
        return None
    return (out.rung, out.source, out.step, out.offset, out.already_durable,
            [(d["candidate"], d["reason"]) for d in out.demotions])


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_ladder_matches_jax(jr, case, monkeypatch):
    live, buddy, ckpt, off = LADDER_CASES[case]
    if off:
        monkeypatch.setenv("KFT_BUDDY", "0")
    else:
        monkeypatch.delenv("KFT_BUDDY", raising=False)
    ours = _outcome(climb(live, buddy, ckpt, 9, 288))
    theirs = _outcome(jr.ladder.climb(live, buddy, ckpt, 9, 288))
    assert ours == theirs
    if case == "live_wins_when_readable":
        assert ours == ("buddy", "live", 9, 288, False, [])
    if case == "empty_ram_tier_falls_to_verified_disk":
        assert ours[:5] == ("disk", "step:3", 3, 96, True)
        assert [d[0] for d in ours[5]] == ["live", "self", "peer:1", "step:5"]


# -- the checkpoint faults on the port's checkpoints -----------------------------------------

def _state(v):
    return {"params": {"w": torch.full((300,), float(v)), "b": torch.arange(7)},
            "opt": {"m": torch.full((300,), float(v), dtype=torch.bfloat16)}}


class _Killed(Exception):
    """Stands in for the crash_in_save fault's os._exit in the writer."""


def test_crash_in_save_leaves_a_torn_step_that_is_demoted(tmp_path, monkeypatch):
    monkeypatch.setenv("KFT_FAULT_PLAN", "crash_in_save@step=3:rank=0")
    inject._reset_save_faults_for_tests()
    killed = []

    def exit_(code):
        killed.append(code)
        raise _Killed()

    monkeypatch.setattr(inject, "_crash_exit", exit_)
    try:
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        for s in (1, 2, 3):
            mgr.save(s, _state(s), meta={"step": s, "trained_samples": 32 * s})
        mgr.close()
    finally:
        inject._reset_save_faults_for_tests()
    assert killed == [43]
    assert sorted(int(d) for d in os.listdir(tmp_path) if d.isdigit()) == [1, 2, 3]
    got = CheckpointManager(str(tmp_path), is_primary=False).restore_latest_verified()
    assert got[2] == 2 and got[1]["trained_samples"] == 64
    assert [(d["candidate"], "manifest missing" in d["reason"]) for d in got[3]] == \
        [("step:3", True)]
    assert torch.equal(got[0]["params"]["w"], torch.full((300,), 2.0))


@pytest.mark.parametrize("kind", ["corrupt", "crash_in_save"])
def test_ckpt_drill(kind, capsys):
    assert cli.run_ckpt_drill(kind, timeout_s=120) == 0
    assert f"CKPT DRILL OK ({kind})" in capsys.readouterr().out
