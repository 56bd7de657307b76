"""The port's chaos harness (kungfu_tpu_torch.chaos) against the JAX
package's, on the CPU.

* the fault-plan grammar: every kind on a corpus of valid plans parses to
  the JAX package's faults field for field, with the same groupings, and
  every malformed plan of tests/unit/test_chaos.py and
  tests/unit/test_resilience.py (and more) is refused with the same
  message;
* the worker injector: a scripted walk over steps and launch ranks fires
  the same exits and sleeps as the JAX ChaosInjector (os._exit and the
  sleep patched), journals the same events; `corrupt_ckpt` re-arms until a
  finalized step exists, then corrupts it so that the restore ladder
  demotes it; the serving hooks raise naming ROADMAP A.2;
* `maybe_crash_in_save` and `ServerChaos` (an injected clock) give the JAX
  package's answers for the same calls; the config server under a flap
  plan answers the same codes as the JAX server to the same requests, and
  a client's retries ride the window out;
* `python -m kungfu_tpu_torch.chaos`: the flap drill is ridden out without
  a heal, a hang is caught by the heartbeat and healed, the coordinator
  drill (`--coordinator-drill --replicas 3` as the CLI runs it, and one of
  5 replicas with elections of a few tenths of a second) holds every
  invariant of its docstring, and every drill flag that is not ported
  raises naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_drills import drill
from _torch_ranks import REPO
from _torch_reference import jax_reference
from kungfu_tpu_torch import chaos
from kungfu_tpu_torch.chaos import inject, plan as tplan
from kungfu_tpu_torch.chaos import __main__ as cli
from kungfu_tpu_torch.monitor import journal as J


@pytest.fixture(scope="module")
def jc():
    with jax_reference():
        from kungfu_tpu.chaos import inject as jinject
        from kungfu_tpu.chaos import plan as jplan
        from kungfu_tpu.elastic import config_server as jcs
        from kungfu_tpu.monitor import journal as jjournal
        from kungfu_tpu.plan import Cluster as JCluster, HostList as JHostList

        yield types.SimpleNamespace(plan=jplan, inject=jinject, cs=jcs, journal=jjournal,
                                    Cluster=JCluster, HostList=JHostList)


# -- the grammar -------------------------------------------------------------------------

SPECS = [
    "crash@step=7:rank=2;hang@step=12:rank=1;flap@config_server=3s",
    "crash@step=1:rank=0:code=77",
    "flap@config_server=250ms", "flap@config_server=2:after=9",
    "hang@step=1:rank=0:secs=1.5s", "hang@step=3:rank=2",
    "slow@step=5:rank=1:ms=20:steps=3", "slow@step=5:rank=1:ms=20",
    "corrupt_ckpt@step=25:rank=0:ckpt_step=20", "corrupt_ckpt@step=5:rank=1",
    "crash_in_save@step=20:rank=0", "crash_in_save@step=20:rank=0;crash@step=9:rank=1",
    "crash_serve@tokens=100:rank=1", "crash_serve@tokens=50:tier=decode:code=7",
    "slow_serve@phase=kv_ship:ms=200:rank=0:secs=3:after=2:start_after=1",
    "burst@tenant=bursty:rps=20:secs=3", "burst@tenant=a:rps=1.5:start_after=2s",
    "partition@step=4:hosts=h1,h2|h3:heal_after=5s",
    "degrade_link@host=h2:latency_ms=120:loss_pct=1:rate_mbit=2:step=3:duration=4",
    "kill_host@host=h2:step=9;kill_coordinator@step=4", "kill_coordinator@step=5:replica=2",
    "", "  ;  ",
]
BAD = [
    # tests/unit/test_chaos.py
    "boom@step=1:rank=0", "crash@step=1", "crash@rank=0", "crash@step=1:rank=0:code=0",
    "crash@step=1:rank=0:zork=3", "slow@step=1:rank=0", "flap@after=3", "crash",
    "flap@config_server=xyz", "kill_coordinator@replica=1", "kill_coordinator@step=1:rank=0",
    # tests/unit/test_resilience.py
    "corrupt_ckpt@step=5", "crash_in_save@step=5:rank=0:code=0",
    "corrupt_ckpt@step=5:rank=0:zork=1",
    # and the rest of the grammar's refusals
    "crash_serve@rank=1", "crash_serve@tokens=5:rank=1:code=0", "crash_serve@tokens=5:tier=x",
    "crash_serve@tokens=5:rank=-1", "slow_serve@ms=5", "slow_serve@phase=nap:ms=5",
    "slow_serve@phase=decode:ms=5:tier=x", "burst@tenant=a", "burst@tenant=a:rps=0",
    "partition@step=1", "partition@hosts=a|a", "partition@hosts=a", "degrade_link@step=1",
    "degrade_link@host=h", "kill_host@step=1", "crash@step=x:rank=0", "hang@step=1:rank=0:secs=z",
    "crash@step", "crash@step=1:rank=0;boom@x=1",
]


def _groups(p):
    return {name: [dataclasses.asdict(f) for f in getattr(p, name)()] for name in (
        "worker_faults", "save_faults", "serve_faults", "serve_phase_faults", "burst_faults",
        "flap_faults", "network_faults")}


@pytest.mark.parametrize("spec", SPECS)
def test_plan_matches_jax(jc, spec):
    ours, theirs = tplan.parse_fault_plan(spec), jc.plan.parse_fault_plan(spec)
    assert [dataclasses.asdict(f) for f in ours.faults] == \
        [dataclasses.asdict(f) for f in theirs.faults]
    assert _groups(ours) == _groups(theirs) and bool(ours) == bool(theirs)
    assert [f.matches(s, r) for f in ours.faults for s in range(30) for r in range(3)] == \
        [f.matches(s, r) for f in theirs.faults for s in range(30) for r in range(3)]
    env = {tplan.FAULT_PLAN_ENV: spec}
    assert tplan.plan_from_env(env) == ours and jc.plan.FAULT_PLAN_ENV == tplan.FAULT_PLAN_ENV


@pytest.mark.parametrize("bad", BAD)
def test_malformed_plan_refused_as_jax(jc, bad):
    with pytest.raises(ValueError) as ours:
        tplan.parse_fault_plan(bad)
    with pytest.raises(ValueError) as theirs:
        jc.plan.parse_fault_plan(bad)
    assert str(ours.value) == str(theirs.value)


# -- the injectors -----------------------------------------------------------------------

WALKS = [
    "crash@step=3:rank=1:code=55", "hang@step=2:rank=0:secs=4", "hang@step=2:rank=1",
    "slow@step=1:rank=0:ms=30:steps=2", "slow@step=2:rank=0:ms=40:steps=3",
    "slow@step=5:rank=2:ms=10;crash@step=7:rank=2;hang@step=4:rank=1:secs=2",
]


class _Hang(Exception):
    """Stands in for the hang's endless sleep."""


def _walk(mod, spec, journal_path):
    """A scripted walk of on_step; (exits, sleeps, journal events)."""
    exits, sleeps = [], []

    def sleep(s):
        sleeps.append(s)
        if s >= 3600:
            raise _Hang()

    inj = mod.inject.ChaosInjector(mod.plan.parse_fault_plan(spec), exit_fn=exits.append,
                                   sleep_fn=sleep)
    for step in range(10):
        for rank in range(3):
            try:
                inj.on_step(step, rank)
            except _Hang:
                pass
    events = [{k: v for k, v in e.items() if k not in ("t_wall", "t_job", "rank",
                                                        "cluster_version")}
              for e in mod.journal.read_journal(journal_path)]
    return exits, sleeps, events


@pytest.mark.parametrize("spec", WALKS)
def test_injector_walk_matches_jax(jc, spec, tmp_path, monkeypatch):
    got = {}
    for name, mod in (("port", types.SimpleNamespace(inject=inject, plan=tplan, journal=J)),
                      ("jax", jc)):
        path = str(tmp_path / f"{name}.jsonl")
        monkeypatch.setenv(J.JOURNAL_FILE_ENV, path)
        mod.journal._reset_for_tests()
        got[name] = _walk(mod, spec, path)
        mod.journal._reset_for_tests()
    assert got["port"] == got["jax"]
    assert got["port"][0] or got["port"][1]  # every walk fires something


def test_injector_from_env_and_serving_hooks(monkeypatch):
    monkeypatch.delenv(tplan.FAULT_PLAN_ENV, raising=False)
    assert chaos.injector_from_env() is None and chaos.server_chaos_from_env() is None
    monkeypatch.setenv(tplan.FAULT_PLAN_ENV, "flap@config_server=1s")
    assert chaos.injector_from_env() is None and chaos.server_chaos_from_env() is not None
    monkeypatch.setenv(tplan.FAULT_PLAN_ENV, "crash_serve@tokens=5:rank=0")
    inj = chaos.injector_from_env()
    for call in (lambda: inj.on_serve_tokens(9, 0), lambda: inj.on_serve_phase("decode", 0)):
        with pytest.raises(NotImplementedError, match="ROADMAP A.2"):
            call()
    monkeypatch.setenv(tplan.FAULT_PLAN_ENV, "crash@step=1")
    with pytest.raises(ValueError):
        chaos.injector_from_env()


def test_crash_in_save_hook_matches_jax(jc, monkeypatch):
    monkeypatch.setenv(tplan.FAULT_PLAN_ENV, "crash_in_save@step=20:rank=1:code=55")
    got = {}
    for name, mod in (("port", inject), ("jax", jc.inject)):
        mod._reset_save_faults_for_tests()
        exits = []
        monkeypatch.setattr(mod, "_crash_exit", exits.append)
        try:
            mod.maybe_crash_in_save(20)  # launch rank 0: no match
            mod.set_launch_rank(1)
            mod.maybe_crash_in_save(10)  # another checkpoint step
            mod.maybe_crash_in_save(20)
            mod.maybe_crash_in_save(20)  # one-shot
        finally:
            mod._reset_save_faults_for_tests()
        got[name] = exits
    assert got["port"] == got["jax"] == [55]


def test_server_chaos_window_matches_jax(jc):
    answers = {}
    for name, mod in (("port", (inject, tplan)), ("jax", (jc.inject, jc.plan))):
        now = [100.0]
        sc = mod[0].ServerChaos(mod[1].parse_fault_plan(
            "flap@config_server=3s:after=2;flap@config_server=1s:after=6"), clock=lambda: now[0])
        seq = []
        for dt in (0, 0, 0, 2.9, 0.2, 0, 0, 0, 0.5, 0.6, 100):
            now[0] += dt
            seq.append(sc.should_503())
        answers[name] = seq
    assert answers["port"] == answers["jax"]
    assert answers["port"][:5] == [False, False, True, True, False]


def test_corrupt_ckpt_rearms_then_is_demoted(tmp_path):
    from kungfu_tpu_torch.checkpoint import CheckpointManager

    assert inject._corrupt_checkpoint("") is None
    assert inject._corrupt_checkpoint(str(tmp_path)) is None  # no steps yet
    os.makedirs(tmp_path / ".tmp-20-1" / "state")  # the writer's unfinalized step
    assert inject._corrupt_checkpoint(str(tmp_path)) is None
    inj = chaos.ChaosInjector(tplan.parse_fault_plan("corrupt_ckpt@step=3:rank=0:ckpt_step=2"))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = {"params": {"w": torch.arange(64, dtype=torch.float32)},
             "opt": {"m": torch.ones(8, dtype=torch.bfloat16)}}
    mgr.save(1, state, meta={"step": 1})
    inj.on_step(3, 0, ckpt_dir=str(tmp_path))  # step 2 does not exist yet: re-armed
    state["params"]["w"] += 1
    mgr.save(2, state, meta={"step": 2})
    inj.on_step(2, 0, ckpt_dir=str(tmp_path))  # before its step: nothing
    assert mgr.restore_latest_verified()[2] == 2
    inj.on_step(4, 0, ckpt_dir=str(tmp_path))
    inj.on_step(5, 0, ckpt_dir=str(tmp_path))  # fired once
    got = mgr.restore_latest_verified()
    assert got[2] == 1 and got[3][0]["candidate"] == "step:2"
    assert "checksum mismatch" in got[3][0]["reason"]
    assert torch.equal(got[0]["params"]["w"], torch.arange(64, dtype=torch.float32))
    mgr.close()


def _codes(url: str, n: int):
    codes = []
    for _ in range(n):
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                codes.append(r.status)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
    return codes


def test_config_server_flap_matches_jax(jc):
    """The same requests to each package's server under one flap plan give
    the same codes: the document plane answers 503 in the window, /health
    and the KV plane answer inside it; a client's retries ride it out."""
    from kungfu_tpu_torch.elastic.config_client import ConfigClient
    from kungfu_tpu_torch.elastic.config_server import ConfigServer
    from kungfu_tpu_torch.plan import Cluster, HostList

    seen = {}
    for name, (cs, plan, cl) in {
            "port": (ConfigServer, tplan, Cluster.from_hostlist(HostList.parse("127.0.0.1:2"), 2)),
            "jax": (jc.cs.ConfigServer, jc.plan,
                    jc.Cluster.from_hostlist(jc.HostList.parse("127.0.0.1:2"), 2))}.items():
        mod = inject if name == "port" else jc.inject
        srv = cs(port=0, init=cl, chaos=mod.ServerChaos(
            plan.parse_fault_plan("flap@config_server=2s:after=2"))).start()
        try:
            base = srv.url.rsplit("/", 1)[0]
            codes = _codes(srv.url, 3)
            codes += _codes(base + "/config/health", 1) + _codes(base + "/config/kv?prefix=", 1)
            codes += _codes(srv.url, 1)
            time.sleep(2.1)
            codes += _codes(srv.url, 2)
            seen[name] = codes
        finally:
            srv.stop()
    assert seen["port"] == seen["jax"] == [200, 200, 503, 200, 200, 503, 200, 200]
    srv = ConfigServer(port=0, init=Cluster.from_hostlist(HostList.parse("127.0.0.1:2"), 2),
                       chaos=inject.ServerChaos(tplan.parse_fault_plan(
                           "flap@config_server=1s:after=1"))).start()
    try:
        client = ConfigClient(srv.url, retries=6, backoff_s=0.2, retry_deadline_s=5.0)
        assert client.get_cluster()[1] == 0
        got = client.get_cluster()  # opens the window: retried through it
        assert got is not None and got[0].size() == 2
    finally:
        srv.stop()


# -- the drills ----------------------------------------------------------------------------

def test_flap_drill_is_ridden_out_without_a_resize():
    s = drill("flap@config_server=3s:after=8", 2, "127.0.0.11", total_samples=1024)
    assert s["returncode"] == 0, s["output"][-3000:]
    assert not s["runner_heal_events"], s["output"][-3000:]
    assert len(s["results"]) == 2
    for res in s["results"]:
        assert res["trained"] >= 1024 and res["final_size"] == 2 and res["heals"] == 0
        assert res["resizes"] == 0 and np.isfinite(res["loss"])


def test_hang_drill_is_caught_by_the_heartbeat():
    # the heartbeat timeout leaves room for a worker's start-up (imports, the
    # group) on a loaded machine: the file is touched from the first step on
    s = drill("hang@step=9:rank=1", 3, "127.0.0.12", heartbeat_timeout=10.0)
    assert s["returncode"] == 0, s["output"][-3000:]
    assert [(e["old_size"], e["new_size"]) for e in s["runner_heal_events"]] == [(3, 2)]
    assert "heartbeat stale" in s["output"], s["output"][-3000:]
    assert len(s["results"]) == 2 and all(r["trained"] >= 1536 for r in s["results"])
    assert s["heal_events"] and s["heal_events"][0]["mttr_s"] > 0


@pytest.mark.parametrize("flag", sorted(cli.UNPORTED))
def test_unported_drill_flag_raises(flag):
    opts, item = cli.UNPORTED[flag]
    if opts.get("action") == "store_true":
        args = [flag]
    else:
        args = [flag, (opts.get("choices") or ["1"])[0]]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        cli.main(args)


def test_json_is_the_coordinator_drills_only():
    with pytest.raises(NotImplementedError, match="ROADMAP A.2"):
        cli.main(["--json", "out.json"])


FIVE_REPLICAS_DRILL = textwrap.dedent("""
    import json
    from kungfu_tpu_torch.chaos.controlplane import run_coordinator_drill

    print("SUMMARY " + json.dumps(run_coordinator_drill(replicas=5, timeout_s=60)))
""")


@pytest.mark.parametrize("how", ["cli", "five-replicas"])
def test_coordinator_drill(tmp_path, how):
    """The drill through a leader SIGKILL and a leader SIGSTOP: no dropped
    request, each thread's versions monotonic, no version won twice, the
    final version at least v0 + the commits, the commit gap bounded,
    commits after both failovers, three elections and a respawn
    journaled, every replica converged (its `failures` list empty)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("KFT_JOURNAL_DIR", None)
    if how == "cli":
        cmd = [sys.executable, "-m", "kungfu_tpu_torch.chaos", "--coordinator-drill",
               "--replicas", "3", "--json", str(tmp_path / "drill.json")]
    else:
        cmd = [sys.executable, "-c", FIVE_REPLICAS_DRILL]
        env.update(KFT_RAFT_ELECT_S="0.3", KFT_RAFT_HB_S="0.08")
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    out = r.stdout + r.stderr
    if how == "cli":
        assert r.returncode == 0 and "COORDINATOR DRILL OK" in r.stdout, out[-3000:]
        summary = json.loads((tmp_path / "drill.json").read_text())
    else:
        summary = json.loads(r.stdout.split("SUMMARY ", 1)[1].splitlines()[0])
    assert summary["ok"] and not summary["failures"], summary
    assert summary["replicas"] == (3 if how == "cli" else 5)
    assert [k["mode"] for k in summary["kills"]] == ["SIGKILL", "SIGSTOP"]
    assert summary["cas_commits"] > 0 and summary["kv_commits"] > 0
    assert summary["final_version"] >= summary["v0"] + summary["cas_commits"]
    assert summary["respawns"] >= 1 and summary["journal_counts"]["replica_respawned"] >= 1
    assert summary["journal_counts"]["leader_elected"] >= 3
