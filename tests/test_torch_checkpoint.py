"""The port's checkpoint manager and integrity manifests against the JAX
package's.

* `resilience.manifest`: the port's manifest of a tree of f32, int32 and
  bf16 leaves (torch tensors) equals the JAX package's of the same leaves
  (jax arrays, bf16 as ml_dtypes' bfloat16) under the same paths, `t_wall`
  aside, byte for byte as JSON; each package's `verify_manifest` accepts
  the other's, and a flipped byte is flagged by both; `structure_hash`
  and the flatten order (dicts by sorted key, sequences by index) are the
  JAX package's;
* `checkpoint.CheckpointManager`: the seven cases of
  tests/unit/test_checkpoint.py on the port's own step format, then
  `restore_latest_verified` over a torn step (no manifest), a corrupt one
  (a flipped byte in a leaf file) and a good one, a failed write
  journaled and never raised, and `release` / `set_primary` with a save
  queued.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from _torch_reference import jax_reference
from kungfu_tpu_torch import checkpoint as CK
from kungfu_tpu_torch.monitor import journal as J
from kungfu_tpu_torch.resilience import manifest as M


@pytest.fixture(scope="module")
def jm():
    with jax_reference():
        from kungfu_tpu.resilience import manifest

        yield manifest


def _leaves(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "count": np.asarray(rng.integers(0, 100, (5,)), np.int32),
        "h": rng.standard_normal((3, 2)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "step": np.asarray(7, np.int32),
    }


def _trees(seed: int = 0):
    """(the port's tree of tensors, the JAX package's of the same leaves)."""
    a = _leaves(seed)

    def torch_of(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())

    ours = {"params": {"w": torch_of(a["w"]), "h": torch_of(a["h"])},
            "opt": [torch_of(a["count"]), {"step": torch_of(a["step"])}]}
    theirs = {"params": {"w": jnp.asarray(a["w"]), "h": jnp.asarray(a["h"])},
              "opt": [jnp.asarray(a["count"]), {"step": jnp.asarray(a["step"])}]}
    return ours, theirs


def _json(m) -> str:
    return json.dumps({k: v for k, v in m.items() if k != "t_wall"}, sort_keys=True)


def test_manifest_equals_jax(jm):
    ours, theirs = _trees()
    meta = {"trained_samples": 64, "step": 3}
    mine = M.build_manifest(3, ours, meta=meta, cluster_version=2)
    ref = jm.build_manifest(3, theirs, meta=meta, cluster_version=2)
    assert _json(mine) == _json(ref)
    assert [r["path"] for r in mine["leaves"]] == ["opt/0", "opt/1/step", "params/h", "params/w"]
    assert {r["path"]: r["dtype"] for r in mine["leaves"]}["params/h"] == "<V2"
    assert M.structure_hash(ours) == jm.structure_hash(theirs)


def test_manifests_verify_across_packages(jm, tmp_path):
    ours, theirs = _trees()
    mine = M.build_manifest(5, ours)
    ref = jm.build_manifest(5, theirs)
    assert M.verify_manifest(ref, ours) == [] and jm.verify_manifest(mine, theirs) == []
    # written by one package, read back by the other
    (tmp_path / "5").mkdir()
    M.write_manifest(str(tmp_path), mine)
    assert jm.read_manifest(str(tmp_path), 5) == mine
    # one flipped byte is flagged by both, naming the leaf
    flipped = ours["params"]["w"].clone()
    flipped.view(torch.uint8).view(-1)[5] ^= 0x40
    bad_ours = {**ours, "params": {**ours["params"], "w": flipped}}
    bad_theirs = {**theirs, "params": {**theirs["params"], "w": jnp.asarray(flipped.numpy())}}
    for problems in (M.verify_manifest(ref, bad_ours), jm.verify_manifest(mine, bad_theirs)):
        assert len(problems) == 1 and "params/w checksum mismatch" in problems[0]


def test_manifest_flags_drift_and_missing_leaves(jm):
    ours, theirs = _trees()
    mine = M.build_manifest(1, ours)
    short = {"params": ours["params"], "opt": [ours["opt"][0]]}
    cast = {**ours, "params": {**ours["params"], "w": ours["params"]["w"].double()}}
    for tree in (short, cast):
        got = M.verify_manifest(mine, tree)
        want = jm.verify_manifest(jm.build_manifest(1, theirs), {
            "params": theirs["params"], "opt": [theirs["opt"][0]]} if tree is short else {
            **theirs, "params": {**theirs["params"], "w": np.asarray(theirs["params"]["w"],
                                                                     np.float64)}})
        assert got == want and got


def test_flatten_order_and_scalars_match_jax(jm):
    """Python scalars are leaves and None an empty subtree, as in a JAX
    pytree; a namedtuple's path entries are its field names."""
    import collections

    NT = collections.namedtuple("NT", "b a")
    tree = {"z": 1.5, "a": [True, None, 3], "n": NT(b=torch.tensor([1.0]), a=2)}
    jtree = {"z": 1.5, "a": [True, None, 3], "n": NT(b=np.asarray([1.0], np.float32), a=2)}
    assert _json(M.build_manifest(0, tree)) == _json(jm.build_manifest(0, jtree))


# -- the checkpoint manager: tests/unit/test_checkpoint.py's cases ------------------------


def _state(scale: float):
    params = {"w": torch.full((4, 3), scale), "b": torch.zeros(3)}
    opt = torch.optim.SGD([torch.nn.Parameter(params["w"].clone())], lr=0.1, momentum=0.9)
    return {"params": params, "opt": opt.state_dict(), "step": torch.tensor(7, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(0, _state(2.5), meta={"trained_samples": 1024, "cluster_size": 8})
    mgr.wait()
    got, meta = mgr.restore(like=_state(0.0))
    torch.testing.assert_close(got["params"]["w"], torch.full((4, 3), 2.5))
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32
    assert got["opt"]["param_groups"] == _state(0.0)["opt"]["param_groups"]
    assert meta == {"trained_samples": 1024, "cluster_size": 8}
    mgr.close()


def test_latest_and_retention(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for s in (0, 1, 2, 3):
        assert mgr.save(s, _state(float(s)), meta={"s": s})
    mgr.wait()
    assert mgr.latest_step() == 3
    assert mgr.all_steps() == [2, 3]  # retention pruned 0 and 1
    got, meta = mgr.restore(step=2, like=_state(0.0))
    torch.testing.assert_close(got["params"]["w"], torch.full((4, 3), 2.0))
    assert meta == {"s": 2}
    mgr.close()


def test_restore_without_template(tmp_path):
    """Also a wrapper's own state: a namedtuple comes back as its class."""
    from kungfu_tpu_torch.optimizers.sync import CompressedGradState

    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"))
    wrapper = CompressedGradState(ef=[torch.arange(3.0)], generator={
        "generator": torch.arange(4, dtype=torch.uint8), "device": "cpu"})
    mgr.save(5, {**_state(1.0), "wrapper": wrapper}, meta={})
    mgr.wait()
    got, _ = mgr.restore()
    torch.testing.assert_close(got["params"]["b"], torch.zeros(3))
    assert type(got["wrapper"]) is CompressedGradState
    assert got["wrapper"].generator["device"] == "cpu"
    torch.testing.assert_close(got["wrapper"].ef[0], torch.arange(3.0))
    mgr.close()


def test_non_primary_save_is_noop(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"), is_primary=False)
    assert not mgr.save(0, _state(1.0))
    assert mgr.latest_step() is None
    mgr.close()


def test_restore_empty_raises(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr.close()


def test_save_interval_skips(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=10)
    assert mgr.save(0, _state(0.0))
    assert not mgr.save(3, _state(0.0))  # within the interval: skipped
    assert mgr.save(10, _state(1.0))
    mgr.wait()
    assert mgr.all_steps() == [0, 10]
    mgr.close()


def test_writes_property(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path / "a"), is_primary=True)
    assert mgr.writes
    mgr2 = CK.CheckpointManager(str(tmp_path / "b"), is_primary=False)
    assert not mgr2.writes
    assert mgr2.save(1, {"x": 1}) is False
    mgr.close()
    mgr2.close()


# -- integrity: the restore ladder's disk rungs ----------------------------------------------


@pytest.fixture
def journal(tmp_path, monkeypatch):
    monkeypatch.setenv("KFT_JOURNAL_DIR", str(tmp_path / "journal"))
    J._reset_for_tests()
    yield lambda: [e for p in (tmp_path / "journal").glob("*.jsonl")
                   for e in J.read_journal(str(p))]
    J._reset_for_tests()


def _flip(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x01]))


def test_restore_latest_verified_demotes_torn_and_corrupt(tmp_path, journal):
    d = str(tmp_path / "ckpt")
    mgr = CK.CheckpointManager(d, max_to_keep=5)
    for s in (1, 2, 3):
        assert mgr.save(s, _state(float(s)), meta={"step": s})
    mgr.wait()
    assert mgr.verified_steps() == [1, 2, 3]
    os.remove(M.manifest_path(d, 3))  # torn: arrays without their commit record
    _flip(os.path.join(d, "2", CK.STATE_DIR, "0.bin"))  # corrupt
    assert mgr.verified_steps() == [1, 2]
    state, meta, step, demotions = mgr.restore_latest_verified()
    assert step == 1 and meta == {"step": 1}
    torch.testing.assert_close(state["params"]["w"], torch.full((4, 3), 1.0))
    assert [x["candidate"] for x in demotions] == ["step:3", "step:2"]
    assert "torn" in demotions[0]["reason"] and "checksum" in demotions[1]["reason"]
    with pytest.raises(M.CheckpointIntegrityError, match="params/w checksum mismatch"):
        mgr.restore(step=2)
    events = [e for e in journal() if e["event"] == "checkpoint_demoted"]
    assert [e["step"] for e in events] == [3, 2]
    _flip(os.path.join(d, "1", CK.STATE_DIR, "1.bin"))
    assert mgr.restore_latest_verified() is None  # nothing verifies: no unverified bytes
    mgr.close()


def test_failed_write_is_journaled_not_raised(tmp_path, journal):
    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(1, {"bad": object()})  # the writer cannot encode it
    assert mgr.wait() is False
    assert mgr.all_steps() == [] and mgr.save(2, _state(1.0)) and mgr.wait()
    assert mgr.all_steps() == [2]
    failed = [e for e in journal() if e["event"] == "checkpoint_save_failed"]
    assert [e["step"] for e in failed] == [1] and "TypeError" in failed[0]["error"]
    mgr.close()


def test_release_and_set_primary_with_a_save_queued(tmp_path, monkeypatch):
    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"))
    gate = threading.Event()
    write = CK.CheckpointManager._write_step

    def slow_write(self, step, host_state, meta):
        gate.wait(10)
        write(self, step, host_state, meta)

    monkeypatch.setattr(CK.CheckpointManager, "_write_step", slow_write)
    state = _state(3.0)
    assert mgr.save(4, state)
    state["params"]["w"].fill_(-1.0)  # save() took a host copy: training may go on
    assert mgr.wait(deadline_s=0.2) is False  # still in flight
    assert mgr.all_steps() == []
    threading.Timer(0.2, gate.set).start()
    mgr.release()  # flushes the queued save, then stops writing
    assert not mgr.writes and mgr.all_steps() == [4] and mgr.verified_steps() == [4]
    got, _ = mgr.restore(4)
    torch.testing.assert_close(got["params"]["w"], torch.full((4, 3), 3.0))
    assert not mgr.save(5, _state(1.0))
    mgr.set_primary(True)  # the new rank 0 takes over writing
    assert mgr.writes and mgr.save(5, _state(1.0)) and mgr.wait()
    mgr.set_primary(False)
    assert not mgr.writes and mgr.latest_step() == 5
