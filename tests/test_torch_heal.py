"""The port's self-healing path against the JAX package's, on the CPU.

* `_suspected_peer_failure` on the JAX package's cases gives its answers;
  a `peer_memory.RingError` is a suspected failure by its type (the JAX
  test reads text markers, which a ring kernel's timeout does not carry);
* the healer (`WatchRunner(heal=True)`), scripted as
  tests/unit/test_chaos.py scripts the JAX one, with fake processes and
  each package's own config server: the shrink that keeps the head, the
  skip of a peer already gone, the restart budget and its backoff (the
  jitter fixed), the regrow, the stalest frozen worker with its amnesty,
  the slow-but-alive judgment (journaled `worker_slow`) and no judgment
  without a heartbeat timeout: the same documents, events and decisions
  as the JAX WatchRunner's;
* `RemoteHostJudge` on a scripted table of runner heartbeats and suspect
  reports: the JAX judge's actions and journal, sweep by sweep;
* the "live" rung on in-place state: a step whose gradient reduction
  fails hands over exactly the parameters and optimizer state from
  before it; a compressed reduction that wrote its error-feedback
  residuals is demoted to the rolling snapshot;
* drills (`python -m kungfu_tpu_torch.chaos`, on ports of their own):
  `crash@step=7:rank=2` at np 3 heals to 2 from the buddy rung; a crash
  with `-restart-budget 1` heals to 2 and regrows to 3; the command line
  holds `--expect-rung buddy`;
* the heal replay (tests/_elastic_replay.py): under KFT_BUDDY=0 with
  checkpoints every 4 steps, `crash@step=7:rank=2` at np 3 rolls the port
  back to the disk step 4, and the survivors' final loss and `w` equal
  the JAX package's run from that step at their size, to rtol 1e-6 (the
  JAX package's own heal does not complete under jax 0.9.0: its
  coordination service ends the survivors, ROADMAP "Differences kept on
  purpose"); with the buddy tier on, the port takes the live state.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from _torch_drills import drill, ports
from _torch_ranks import MAX_WORKER_PORT, REPO, _free_port_range
from _torch_reference import jax_reference
from kungfu_tpu_torch.elastic import trainer as ET
from kungfu_tpu_torch.monitor import journal as J
from kungfu_tpu_torch.ops.peer_memory import RingError
from kungfu_tpu_torch.store import STORE_PORT_OFFSET


@pytest.fixture(scope="module")
def jk():
    with jax_reference():
        from kungfu_tpu import plan as jplan
        from kungfu_tpu.elastic import config_client as jcc
        from kungfu_tpu.elastic import config_server as jcs
        from kungfu_tpu.elastic import trainer as jtrainer
        from kungfu_tpu.monitor import journal as jjournal
        from kungfu_tpu.run import job as jjob
        from kungfu_tpu.run import launcher as jlauncher

        yield types.SimpleNamespace(plan=jplan, cc=jcc, cs=jcs, trainer=jtrainer,
                                    journal=jjournal, job=jjob, launcher=jlauncher)


def _port_pkg():
    from kungfu_tpu_torch import plan
    from kungfu_tpu_torch.elastic import config_client as cc
    from kungfu_tpu_torch.elastic import config_server as cs
    from kungfu_tpu_torch.run import job, launcher

    return types.SimpleNamespace(plan=plan, cc=cc, cs=cs, trainer=ET, journal=J, job=job,
                                 launcher=launcher)


# -- the suspected-failure test --------------------------------------------------------------

CASES = [TimeoutError("no consensus"), ConnectionResetError(104, "reset"),
         ValueError("Gloo all-reduce failed: Connection closed by peer"),
         RuntimeError("UNAVAILABLE: heartbeat timeout"), ValueError("shapes do not match"),
         KeyError("params"), RuntimeError("[pair.cc:553] Connection closed by peer"),
         RuntimeError("Socket Timeout"), RuntimeError("CUDA error: out of memory"),
         TypeError("gloo"), OSError("broken pipe")]


def test_suspected_peer_failure_matches_jax(jk):
    for e in CASES:
        assert ET._suspected_peer_failure(e) == jk.trainer._suspected_peer_failure(e), e
    ring = RingError("rank 1/4: ring kernel gave up after 30 s waiting for the reduce-scatter "
                     "data of hop 0, block 3, call 7")
    assert ET._suspected_peer_failure(ring) and not jk.trainer._suspected_peer_failure(ring)


# -- the healer ------------------------------------------------------------------------------

class _FakePopen:
    def __init__(self):
        self.returncode = None

    def poll(self):
        return self.returncode


def _fake_runner(hb_path):
    return types.SimpleNamespace(popen=_FakePopen(),
                                 proc=types.SimpleNamespace(env={"KFT_HEARTBEAT_FILE": hb_path}))


def _cluster(pkg, n):
    return pkg.plan.Cluster.from_hostlist(pkg.plan.HostList.parse(f"127.0.0.1:{n}"), n)


class _Healer:
    """One package's config server (n workers) and WatchRunner(heal=True)."""

    def __init__(self, pkg, n, **kw):
        self.pkg = pkg
        self.srv = pkg.cs.ConfigServer(port=0, init=_cluster(pkg, n)).start()
        self.client = pkg.cc.ConfigClient(self.srv.url)
        job = pkg.job.Job(prog=sys.executable, args=[], strategy=pkg.plan.Strategy.AUTO)
        self.runner = pkg.launcher.WatchRunner(job, "127.0.0.1", self.client, heal=True, **kw)
        self.workers = tuple(_cluster(pkg, n).workers)

    def doc(self):
        cluster, version = self.client.get_cluster()
        return cluster.to_json(), version

    def close(self):
        self.srv.stop()


def _both(jk, n, script, **kw):
    """`script(healer)` against each package; their results."""
    out = {}
    for name, pkg in (("port", _port_pkg()), ("jax", jk)):
        h = _Healer(pkg, n, **kw)
        try:
            out[name] = script(h)
        finally:
            h.close()
    return out


def test_heal_dead_shrinks_prefix_preserving_as_jax(jk):
    def script(h):
        victim = h.workers[1]
        h.runner._heal_dead(victim, rc=41)
        return h.doc(), h.runner.heal_events, {str(p): n for p, n in h.runner._restarts.items()}

    got = _both(jk, 3, script)
    assert got["port"] == got["jax"]
    (doc, version), events, _ = got["port"]
    assert version == 1 and len(doc["workers"]) == 2
    assert events == [{"peer": "127.0.0.1:10001", "rc": 41, "old_size": 3, "new_size": 2,
                       "version": 1}]


def test_heal_skips_already_absent_peer_as_jax(jk):
    def script(h):
        victim = h.workers[2]
        cl, v = h.client.get_cluster()
        h.client.put_cluster(h.pkg.plan.Cluster(
            runners=cl.runners, workers=h.pkg.plan.PeerList(p for p in cl.workers if p != victim)),
            version=v)
        h.runner._heal_dead(victim, rc=0)
        return h.doc(), h.runner.heal_events

    got = _both(jk, 3, script)
    assert got["port"] == got["jax"] and got["port"][0][1] == 1 and got["port"][1] == []


def test_restart_budget_and_backoff_as_jax(jk, monkeypatch):
    def script(h):
        monkeypatch.setattr(h.pkg.launcher.random, "random", lambda: 0.5)
        peer = h.workers[1]
        delays = []
        for _ in range(3):
            h.runner._schedule_restart(peer)
            due = h.runner._regrow_at.pop(peer, None)
            delays.append(None if due is None else round(due - time.monotonic(), 1))
        return delays, h.runner._restarts[peer]

    got = _both(jk, 3, script, restart_budget=2, restart_backoff_s=0.5)
    assert got["port"] == got["jax"] == ([0.5, 1.0, None], 2)


def test_regrow_re_adds_peer_as_jax(jk):
    def script(h):
        victim = h.workers[1]
        h.runner._heal_dead(victim, rc=41)
        shrunk = h.doc()
        h.runner._regrow_at[victim] = time.monotonic() - 1  # due now
        h.runner._process_regrows()
        return shrunk, h.doc(), dict(h.runner._regrow_at)

    got = _both(jk, 3, script, restart_budget=1)
    assert got["port"] == got["jax"]
    (_, v1), (doc, v2), pending = got["port"]
    assert (v1, v2, pending) == (1, 2, {})
    assert doc["workers"][-1] == {"host": "127.0.0.1", "port": 10001}


def test_stalest_worker_and_amnesty_as_jax(jk, tmp_path):
    def script(h):
        d = tmp_path / h.pkg.__name__ if hasattr(h.pkg, "__name__") else tmp_path / str(id(h))
        os.makedirs(d, exist_ok=True)
        fresh, stale = str(d / "a"), str(d / "b")
        for p in (fresh, stale):
            open(p, "w").close()
        old = time.time() - 60
        os.utime(stale, (old, old))
        h.runner.current = {h.workers[0]: _fake_runner(fresh), h.workers[1]: _fake_runner(stale)}
        first = h.runner._stalest_worker()  # the first stale sighting: not yet hung
        seen = h.workers[1] in h.runner._stale_seen
        h.runner._stale_seen[h.workers[1]] = (os.path.getmtime(stale), time.monotonic() - 6.0)
        got = h.runner._stalest_worker()
        h.runner._hb_amnesty_until = time.monotonic() + 60
        return first, seen, got and str(got[1]), h.runner._stalest_worker()

    got = _both(jk, 2, script, heartbeat_timeout_s=5.0)
    assert got["port"] == got["jax"] == (None, True, "127.0.0.1:10001", None)


def test_slow_but_alive_worker_not_killed_as_jax(jk, tmp_path, monkeypatch):
    def script(h):
        jpath = str(tmp_path / f"j-{id(h)}.jsonl")
        monkeypatch.setenv(J.JOURNAL_FILE_ENV, jpath)
        h.pkg.journal._reset_for_tests()
        hb = str(tmp_path / f"hb-{id(h)}")
        open(hb, "w").close()
        old = time.time() - 8
        os.utime(hb, (old, old))
        h.runner.current = {h.workers[0]: _fake_runner(hb)}
        calls = [h.runner._stalest_worker()]
        old = time.time() - 7  # it moved, still past the timeout
        os.utime(hb, (old, old))
        calls += [h.runner._stalest_worker(), h.runner._stalest_worker()]
        os.utime(hb, None)
        calls.append(h.runner._stalest_worker())
        events = [e["event"] for e in h.pkg.journal.read_journal(jpath)]
        h.pkg.journal._reset_for_tests()
        return calls, events, h.workers[0] in h.runner._stale_seen

    got = _both(jk, 2, script, heartbeat_timeout_s=5.0)
    assert got["port"] == got["jax"] == ([None] * 4, ["worker_slow"], False)


def test_no_heartbeat_timeout_means_no_staleness_judgment(jk):
    got = _both(jk, 2, lambda h: h.runner._stalest_worker())
    assert got["port"] is got["jax"] is None


def test_remote_host_judge_matches_jax(jk):
    """Sweeps over a scripted table: a host that never beat, one that went
    silent then dies, a heartbeat that returns, a partition (suspects with
    every heartbeat fresh) and its reconvene nudge, and the clearing."""
    def run(pkg):
        journaled = []
        judge = pkg.launcher.RemoteHostJudge(
            "h0", suspicion_s=4.0, stale_after_s=3.0, reconvene_interval_s=5.0,
            journal=lambda ev, **kw: journaled.append((ev, sorted(kw.items()))))
        cl = pkg.plan.Cluster(
            runners=pkg.plan.PeerList([pkg.plan.PeerID(h, 38080) for h in ("h0", "h1", "h2")]),
            workers=pkg.plan.PeerList([pkg.plan.PeerID(h, 10000 + i) for h in ("h0", "h1", "h2")
                                       for i in range(2)]))
        table = [  # now, {host: its heartbeat's server time}, {suspect key: (version, t)}
            (100.0, {"h1": 99.5}, {}),                  # h2 never beat
            (102.0, {"h1": 101.8}, {}),
            (106.0, {"h1": 105.9, "h2": 105.5}, {}),    # h2 arrives
            (110.0, {"h1": 109.9, "h2": 105.5}, {}),    # h2 silent 4.5 s: suspected
            (112.0, {"h1": 111.9, "h2": 111.8}, {}),    # back: cleared
            (120.0, {"h1": 119.9, "h2": 111.8}, {}),    # silent again
            (125.0, {"h1": 124.9, "h2": 111.8}, {}),    # dead past the window
            (130.0, {"h1": 129.9, "h2": 129.9}, {"suspect/h1:10000": (3, 120.0)}),
            (136.0, {"h1": 135.9, "h2": 135.9}, {"suspect/h1:10000": (3, 120.0)}),
            (142.0, {"h1": 141.9, "h2": 141.9}, {"suspect/h1:10000": (2, 120.0)}),
            (150.0, {"h1": 149.9, "h2": 149.9}, {}),
        ]
        out = []
        for now, beats, sus in table:
            hb = {f"runner-hb/{h}": {"t_server": t} for h, t in beats.items()}
            suspects = {k: {"t_server": t, "value": {"cluster_version": v}}
                        for k, (v, t) in sus.items()}
            out.append(judge.assess(cl, hb, suspects, now, version=3))
        return out, journaled

    ours, theirs = run(_port_pkg()), run(jk)
    assert ours == theirs
    actions = ours[0]
    assert actions[6]["shrink"] == ["h2"] and any(a["partition"] for a in actions)
    assert any(a["reconvene"] for a in actions) and not actions[-1]["partition"]


def test_healer_options_reach_the_runner():
    from kungfu_tpu_torch.run import job as tjob
    from kungfu_tpu_torch.run import launcher as tl

    j = tjob.Job(prog="x", args=[], strategy=_port_pkg().plan.Strategy.AUTO, heal=True,
                 heartbeat_dir="/hb")
    peer = _port_pkg().plan.PeerID("127.0.0.1", 10000)
    env = j.new_proc(peer, -1, _cluster(_port_pkg(), 1), 0).env
    assert (env["KFT_HEAL"], env["KFT_HEARTBEAT_FILE"]) == ("1", "/hb/hb-127.0.0.1-10000")
    for k, v in (("KFT_INIT_TIMEOUT_S", "45"), ("KFT_MAX_MISSING_HEARTBEATS", "100"),
                 ("KFT_STALL_DEADLINE_S", "120"), ("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")):
        assert env[k] == os.environ.get(k, v)
    r = tl.WatchRunner(j, "127.0.0.1", None, heal=True, restart_budget=2,
                       heartbeat_timeout_s=3.0, suspicion_s=0.0)
    assert (r.suspicion_s, r._judge.suspicion_s, r._judge.stale_after_s) == (6.0, 6.0, 3.0)


# -- the live rung on in-place state ------------------------------------------------------------

def _trainer(compression=None):
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.train import DataParallelTrainer

    torch.manual_seed(0)
    model = torch.nn.Linear(8, 4)
    tx = synchronous_sgd(lambda ps: torch.optim.AdamW(ps, lr=0.1), compression=compression)
    trainer = DataParallelTrainer(lambda m, b: m(b).square().mean(), tx, device="cpu")
    return trainer, trainer.init(model)


def _copy(sd):
    return ET._to_host(sd)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _failing_reduction(monkeypatch, sync, compressed):
    """A group of two whose reduction's ring gives up, in this process."""
    monkeypatch.setattr(sync, "_world", lambda group: 2)

    def reduce(*a, **k):
        raise RingError("ring kernel gave up after 30 s waiting for the reduce-scatter data")

    if compressed:
        real = sync._compressed_reducer
        monkeypatch.setattr(sync, "_compressed_reducer",
                            lambda g, i, c: (reduce, real(g, i, c)[1]))
    else:
        monkeypatch.setattr(sync, "_mean_reducer", lambda g, i, op="mean": reduce)


@pytest.mark.parametrize("compressed", [False, True])
def test_live_rung_hands_over_the_state_before_the_failed_step(monkeypatch, compressed):
    from kungfu_tpu_torch.optimizers import sync
    from kungfu_tpu_torch.resilience import ladder

    trainer, state = _trainer("int8" if compressed else None)
    batch = torch.randn(16, 8)
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
        ET._mark_live(state.opt_state)
    before = (_copy(dict(state.params.state_dict())), _copy(state.opt_state.state_dict()))
    _failing_reduction(monkeypatch, sync, compressed)
    with pytest.raises(RingError) as failed:
        trainer.train_step(state, batch)
    assert ET._suspected_peer_failure(failed.value)
    snap = {"step": 1, "offset": 16, "state": {"params": before[0], "opt": before[1]}}
    buddy = types.SimpleNamespace(buddy_rank=1, latest=lambda: snap, fetch=lambda: None)
    out = ladder.climb(lambda: ET._live_state(state), buddy, None, 2, 32)
    if compressed:
        with pytest.raises(RuntimeError, match="compressed reduction"):
            ET._live_state(state)
        assert (out.rung, out.source, out.step) == ("buddy", "self", 1)
        assert [d["candidate"] for d in out.demotions] == ["live"]
        # the reduction wrote g + e into the residuals before it failed
        assert not _equal(_copy(state.opt_state.state_dict()["state"]), before[1]["state"])
    else:
        assert (out.rung, out.source, out.step, out.offset) == ("buddy", "live", 2, 32)
        assert _equal(_copy(out.params), before[0]) and _equal(_copy(out.opt), before[1])


def test_live_rung_demoted_after_the_update(monkeypatch):
    """A failure after the optimizer stepped (the loss mean) leaves the
    state past the step's start: the live rung is demoted."""
    trainer, state = _trainer()
    batch = torch.randn(16, 8)
    state, _ = trainer.train_step(state, batch)
    ET._mark_live(state.opt_state)
    monkeypatch.setattr(type(trainer), "_mean", lambda self, x: (_ for _ in ()).throw(
        RuntimeError("Connection closed by peer")))
    with pytest.raises(RuntimeError):
        trainer.train_step(state, batch)
    with pytest.raises(RuntimeError, match="the optimizer stepped"):
        ET._live_state(state)
    ET._mark_live(state.opt_state)
    assert ET._live_state(state)[0].keys() == state.params.state_dict().keys()


def test_live_rung_demoted_when_a_pull_fails_partway(monkeypatch):
    """Pair averaging mixes the pulled model into the parameters chunk by
    chunk before its inner step: a pull whose second chunk fails leaves the
    parameters torn, so the ladder demotes the live rung to the snapshot."""
    from kungfu_tpu_torch.optimizers import gossip, pair_averaging
    from kungfu_tpu_torch.resilience import ladder
    from kungfu_tpu_torch.train import DataParallelTrainer

    torch.manual_seed(0)
    tx = pair_averaging(lambda ps: torch.optim.SGD(ps, lr=0.1), shifts=(1,))
    trainer = DataParallelTrainer(lambda m, b: m(b).square().mean(), tx, device="cpu",
                                  per_replica_params=True)
    state = trainer.init(torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Linear(8, 4)))
    batch = torch.randn(16, 8)
    state, _ = trainer.train_step(state, batch)  # a group of one: no pull
    ET._mark_live(state.opt_state)
    before = (_copy(dict(state.params.state_dict())), _copy(state.opt_state.state_dict()))
    shifts = []

    def shift_wire(sent, group, shift):  # the partner's model is this one's + 1
        shifts.append(shift)
        if len(shifts) > 1:
            raise RingError("ring kernel gave up after 30 s waiting for the shift's data")
        return [(b.view(torch.float32) + 1).view(torch.uint8) for b in sent]

    monkeypatch.setattr(gossip, "_world", lambda group: 2)
    monkeypatch.setattr(gossip, "CHUNK_BYTES", 1)  # a chunk a leaf
    monkeypatch.setattr(gossip, "shift_wire", shift_wire)
    monkeypatch.setattr(gossip.PairAveragingOptimizer, "select", lambda self: 1)
    with pytest.raises(RingError) as failed:
        trainer.train_step(state, batch)
    assert ET._suspected_peer_failure(failed.value) and len(shifts) == 2
    assert not _equal(_copy(dict(state.params.state_dict())), before[0])  # the first leaf mixed
    with pytest.raises(RuntimeError, match="PairAveragingOptimizer.step began"):
        ET._live_state(state)
    snap = {"step": 1, "offset": 16, "state": {"params": before[0], "opt": before[1]}}
    buddy = types.SimpleNamespace(buddy_rank=1, latest=lambda: snap, fetch=lambda: None)
    out = ladder.climb(lambda: ET._live_state(state), buddy, None, 2, 32)
    assert (out.rung, out.source, out.step) == ("buddy", "self", 1)
    assert [d["candidate"] for d in out.demotions] == ["live"]
    assert _equal(_copy(out.params), before[0]) and _equal(_copy(out.opt), before[1])


# -- the drills ----------------------------------------------------------------------------------

def test_crash_drill_heals_from_the_buddy_rung():
    s = drill("crash@step=7:rank=2", 3, "127.0.0.13")
    assert s["returncode"] == 0, s["output"][-3000:]
    assert [(e["rc"], e["old_size"], e["new_size"]) for e in s["runner_heal_events"]] == \
        [(41, 3, 2)]
    assert len(s["results"]) == 2
    for res in s["results"]:
        assert res["trained"] >= 1536 and res["final_size"] == 2 and res["heals"] == 1
        assert np.isfinite(res["loss"])
    ev = s["heal_events"][0]
    assert (ev["recovery_rung"], ev["recovery_source"], ev["old_size"], ev["new_size"]) == \
        ("buddy", "live", 3, 2)
    assert {"detect_s", "teardown_s", "re_rendezvous_s", "resync_s", "state_source_s",
            "first_step_s"} <= set(ev["phases"]) and ev["mttr_s"] > 0


def test_crash_with_a_restart_budget_regrows():
    s = drill("crash@step=5:rank=1;slow@step=0:rank=0:ms=150", 3, "127.0.0.14",
              total_samples=4096, restart_budget=1)
    assert s["returncode"] == 0, s["output"][-3000:]
    assert [(e["rc"], e["old_size"], e["new_size"]) for e in s["runner_heal_events"]] == \
        [(41, 3, 2)]
    assert "RESTART: re-grew 127.0.0.14:" in s["output"], s["output"][-3000:]
    assert len(s["results"]) == 3 and all(r["final_size"] == 3 and r["trained"] >= 4096
                                          for r in s["results"])
    assert sorted(r["heals"] for r in s["results"]) == [0, 1, 1]  # the joiner never healed
    assert len({r["loss"] for r in s["results"]}) == 1


def test_chaos_cli_expects_the_buddy_rung(monkeypatch, capsys):
    from kungfu_tpu_torch.chaos import __main__ as cli

    real = cli.run_drill
    monkeypatch.setattr(cli, "run_drill", lambda plan, np_, total, timeout, **kw: real(
        plan, np_, total, timeout, **kw, **ports(np_, "127.0.0.15")))
    assert cli.main(["--expect-rung", "buddy"]) == 0
    assert "CHAOS DRILL OK: healed 3 -> 2 workers, rung=buddy/live" in capsys.readouterr().out


# -- the heal replay against the JAX package -----------------------------------------------------

REPLAY = os.path.join(REPO, "tests", "_elastic_replay.py")


def _replay(pkg, host, np_, worker_args, env=(), flags=(), total=1536):
    base = _free_port_range(np_ + 1, MAX_WORKER_PORT, (STORE_PORT_OFFSET,))
    e = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **dict(env))
    e.pop("XLA_FLAGS", None)
    e.pop("JAX_PLATFORMS", None)
    return subprocess.Popen(
        [sys.executable, REPLAY, "launch", pkg, str(base), "-np", str(np_), "-H",
         f"{host}:{np_ + 1}", "-self", host, "-platform", "cpu", *flags, "--",
         sys.executable, REPLAY, "worker", pkg, "--total-samples", str(total), *worker_args],
        cwd=REPO, env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _results(p, timeout=240):
    out, _ = p.communicate(timeout=timeout)
    assert p.returncode == 0, out[-4000:]
    return [json.loads(line.split("REPLAY: ", 1)[1]) for line in out.splitlines()
            if "REPLAY: " in line], out


def test_heal_replay_rolls_back_to_the_jax_disk_step(tmp_path):
    """KFT_BUDDY=0, checkpoints every 4 steps, crash at step 7 on rank 2 of
    3: the port rolls back to disk step 4 and trains to the end on 2 ranks;
    the JAX package's reference is its run to step 4 on 3 ranks (saved),
    then from that step on 2 ranks."""
    heal = ["-w", "-heal", "-port", "0"]
    ours = _replay("torch", "127.0.0.16", 3, ["--checkpoint-dir", str(tmp_path / "torch"),
                                                "--checkpoint-every", "4"],
                   env={"KFT_FAULT_PLAN": "crash@step=7:rank=2", "KFT_BUDDY": "0"}, flags=heal)
    jax_dir = ["--checkpoint-dir", str(tmp_path / "jax"), "--checkpoint-every", "4"]
    first = _replay("jax", "127.0.0.17", 3, jax_dir, total=384)
    try:
        head, _ = _results(first)
        assert [r["trained"] for r in head] == [384] * 3
        rest, _ = _results(_replay("jax", "127.0.0.17", 2, jax_dir))
        port, out = _results(ours)
    finally:
        for p in (ours, first):
            if p.poll() is None:
                p.kill()
    assert len(port) == 2 and len(rest) == 2, out[-3000:]
    assert "rung=disk source=step:4" in out, out[-3000:]
    theirs = rest[0]
    for r in port:
        assert (r["trained"], r["final_size"], r["heals"], r["sources"]) == \
            (theirs["trained"], 2, 1, [["disk", "step:4"]])
        np.testing.assert_allclose(r["loss"], theirs["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["w"], theirs["w"], rtol=1e-6)


def test_heal_replay_takes_the_live_state(tmp_path):
    """With the buddy tier on the port's heal hands over the live state (the
    JAX package's takes its rolling snapshot: its failed step's buffers are
    poisoned), so its survivors end as a run that never lost a step would
    at their size: equal to each other, finite."""
    p = _replay("torch", "127.0.0.18", 3, ["--checkpoint-dir", str(tmp_path / "t"),
                                           "--checkpoint-every", "4"],
                env={"KFT_FAULT_PLAN": "crash@step=7:rank=2"}, flags=["-w", "-heal", "-port", "0"])
    res, out = _results(p)
    assert len(res) == 2 and all(r["sources"] == [["buddy", "live"]] for r in res), out[-3000:]
    assert res[0]["loss"] == res[1]["loss"] and res[0]["w"] == res[1]["w"]
    assert np.isfinite(res[0]["loss"]) and res[0]["trained"] >= 1536
