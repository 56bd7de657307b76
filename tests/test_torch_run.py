"""The port's launcher, `python -m kungfu_tpu_torch.run`, on the CPU.

Workers see the KFT_* env block that the JAX package's `worker_env`
writes for the same cluster; a failing worker stops the others and sets
the launcher's exit code; a flag of the JAX CLI that is not ported raises.
The watch-mode flags (-w, -timeout, -config-server,
-builtin-config-server, -port, -config-replicas) each take effect, and a
resize rides a leader kill under -config-replicas 3.  The workers here start
no process group, so no test binds a worker port; an embedded config
server listens on a free port.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from _torch_reference import jax_reference
from kungfu_tpu_torch import env as tenv
from kungfu_tpu_torch.plan import Cluster, HostList, PeerID, PeerList, Strategy
from kungfu_tpu_torch.run import __main__ as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHOW_ENV = ("import json, os; print('ENV ' + json.dumps("
            "{k: v for k, v in os.environ.items() if k.startswith('KFT_')}))")


@pytest.fixture(scope="module")
def jax_pkg():
    with jax_reference():
        from kungfu_tpu import env, plan

        yield env, plan


def _launch(*args: str, timeout: float = 60, **env):
    e = dict(os.environ, PYTHONPATH=REPO, **env)
    return subprocess.run([sys.executable, "-m", "kungfu_tpu_torch.run", *args], cwd=REPO,
                          env=e, capture_output=True, text=True, timeout=timeout)


def _jax_env(jax_pkg, hosts: str, np: int, strategy: str):
    jenv, jplan = jax_pkg
    cluster = jplan.Cluster.from_hostlist(jplan.HostList.parse(hosts), np)
    return {str(w): jenv.worker_env(self_id=w, cluster=cluster, version=0,
                                    strategy=jplan.Strategy.parse(strategy))
            for w in cluster.workers}


@pytest.mark.parametrize("strategy", ["AUTO", "PALLAS_RING"])
def test_workers_see_the_jax_env_block(jax_pkg, monkeypatch, tmp_path, strategy):
    monkeypatch.setenv("KFT_CONFIG_LOG_LEVEL", "debug")  # the tuning tier is forwarded
    out = _launch("-np", "2", "-strategy", strategy, "-logdir", str(tmp_path),
                  sys.executable, "-c", SHOW_ENV)
    assert out.returncode == 0, out.stdout + out.stderr
    seen = {}
    for line in out.stdout.splitlines():
        prefix, _, rest = line.partition(" ")
        if rest.startswith("ENV "):
            seen[prefix] = json.loads(rest[4:])
    want = _jax_env(jax_pkg, "127.0.0.1:2", 2, strategy)
    assert sorted(seen) == ["[0]", "[1]"]
    # the contract's keys and the tuning tier; other KFT_* of the caller's
    # environment reach the workers as the rest of it does
    contract = set(tenv.ALL_WORKER_ENVS) | {tenv.CONFIG_URLS}
    by_self = {env["KFT_SELF_SPEC"]: {k: v for k, v in env.items()
                                      if k in contract or k.startswith(tenv.CONFIG_PREFIX)}
               for env in seen.values()}
    assert by_self == want
    assert {env["KFT_ALLREDUCE_STRATEGY"] for env in seen.values()} == {strategy}
    assert all(env["KFT_CONFIG_LOG_LEVEL"] == "debug" for env in seen.values())
    # -logdir keeps each worker's output
    assert sorted(os.listdir(tmp_path)) == ["worker-0.log", "worker-1.log"]
    assert "ENV " in (tmp_path / "worker-1.log").read_text()


def test_card_slots_are_opt_in(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    show = "import os; print('CARDS', os.environ.get('CUDA_VISIBLE_DEVICES', 'all'))"
    for args, want in ((["-chips-per-host", "2"], {"0", "1"}), ([], {"all"})):
        out = _launch(*args, "-np", "2", sys.executable, "-c", show)
        assert out.returncode == 0, out.stdout + out.stderr
        assert {line.split()[-1] for line in out.stdout.splitlines() if " CARDS " in line} == want


@pytest.mark.parametrize("hosts,np,parent,server", [
    ("127.0.0.1:4", 4, None, ""),
    ("10.0.0.1:2,10.0.0.2:2", 3, "10.0.0.2:38080", "http://cfg:9100"),
    ("a:1,b:3:pub-b", 4, None, "http://a:1,http://b:1"),
])
def test_worker_env_matches_jax(jax_pkg, hosts, np, parent, server):
    jenv, jplan = jax_pkg
    jcluster = jplan.Cluster.from_hostlist(jplan.HostList.parse(hosts), np)
    cluster = Cluster.from_hostlist(HostList.parse(hosts), np)
    assert [str(w) for w in cluster.workers] == [str(w) for w in jcluster.workers]
    assert [str(r) for r in cluster.runners] == [str(r) for r in jcluster.runners]
    for w, jw in zip(cluster.workers, jcluster.workers):
        got = tenv.worker_env(w, cluster, 7, Strategy.RING,
                              PeerID.parse(parent) if parent else None, server)
        want = jenv.worker_env(jw, jcluster, 7, jplan.Strategy.RING,
                               jplan.PeerID.parse(parent) if parent else None, server)
        assert got == want
        # and the worker reads back the cluster the launcher wrote
        cfg = tenv.parse_config_from_env(got)
        assert cfg.self_id == w and cfg.peers == cluster.workers


def test_failing_worker_stops_the_others():
    worker = ("import os, sys, time\n"
              "if os.environ['KFT_SELF_SPEC'].endswith(':10000'):\n"
              "    time.sleep(0.5); sys.exit(3)\n"
              "time.sleep(60)\n")
    t0 = time.monotonic()
    out = _launch("-np", "3", sys.executable, "-c", worker)
    assert out.returncode == 3, out.stdout + out.stderr
    assert time.monotonic() - t0 < 30  # the sleepers were stopped, not waited for


def test_keep_lets_the_others_finish(tmp_path):
    worker = ("import os, pathlib, sys, time\n"
              "me = os.environ['KFT_SELF_SPEC'].rsplit(':', 1)[1]\n"
              "if me == '10000':\n"
              "    sys.exit(5)\n"
              f"time.sleep(1); pathlib.Path({str(tmp_path)!r}, me).write_text('done')\n")
    out = _launch("-k", "-np", "2", sys.executable, "-c", worker)
    assert out.returncode == 5, out.stdout + out.stderr
    assert (tmp_path / "10001").read_text() == "done"


@pytest.mark.parametrize("flag", sorted(cli.UNPORTED))
def test_unported_flag_raises(flag):
    opts, _, item, *ported = cli.UNPORTED[flag]
    assert item == "A.8"  # telemetry (-config-replicas, A.5c, is ported)
    # a value past the one that is ported, where one is
    args = [flag] if opts.get("action") == "store_true" else [flag, str((ported or [0])[0] + 1)]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        cli.main([*args, "-np", "1", sys.executable, "-c", "pass"])


@pytest.mark.parametrize("flag,value,kw", [
    ("-heal", None, {"heal": True}),
    ("-restart-budget", "3", {"restart_budget": 3}),
    ("-heartbeat-timeout", "7.5", {"heartbeat_timeout_s": 7.5}),
    ("-suspicion-timeout", "12", {"suspicion_s": 12.0}),
])
def test_healer_flag_reaches_watch_runner(monkeypatch, flag, value, kw):
    """Each flag of the healer takes effect as in the JAX CLI: it reaches
    WatchRunner (and -heal implies -w, arms the workers' recovery, and with
    -heartbeat-timeout gives each worker a heartbeat file)."""
    seen = {}

    class Runner:
        heal_events = [{"peer": "127.0.0.1:10000", "rc": 41}]

        def __init__(self, job, self_host, client, **kwargs):
            seen.update(kwargs, job=job)

        def run(self, initial=None, timeout_s=0.0):
            return 0

    monkeypatch.setattr(cli, "WatchRunner", Runner)
    heal = [] if flag == "-heal" else ["-heal"]
    rc = cli.main([*heal, flag, *([value] if value else []), "-config-server",
                   "http://127.0.0.1:9/config", "-np", "1", sys.executable, "-c", "pass"])
    assert rc == 0 and {k: seen[k] for k in kw} == kw and seen["heal"] is True
    assert seen["job"].heal is True
    assert bool(seen["job"].heartbeat_dir) == (flag == "-heartbeat-timeout")
    if seen["job"].heartbeat_dir:
        os.rmdir(seen["job"].heartbeat_dir)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# a worker that reads the config service it was handed: its URL, version, size
SHOW_CONFIG = ("import json, os, urllib.request; url = os.environ['KFT_CONFIG_SERVER']; "
               "doc = json.load(urllib.request.urlopen(url)); print('CONFIG ' + json.dumps("
               "[url, doc['version'], len(doc['cluster']['workers'])]))")


def _config_seen(out) -> list:
    assert out.returncode == 0, out.stdout + out.stderr
    return [json.loads(line.split("CONFIG ", 1)[1]) for line in out.stdout.splitlines()
            if "CONFIG " in line]


SHOW_URLS = ("import json, os; from kungfu_tpu_torch.elastic.config_client import ConfigClient; "
             "urls = os.environ['KFT_CONFIG_URLS']; got = ConfigClient(urls).get_cluster(); "
             "print('CONFIG ' + json.dumps([urls, got[1], got[0].size()]))")


@pytest.mark.parametrize("flag", ["-w", "-timeout", "-config-server",
                                  "-builtin-config-server", "-port", "-config-replicas"])
def test_watch_flag_takes_effect(flag):
    """Each flag the watch mode ported does what it does in the JAX CLI."""
    port = _free_port()
    if flag == "-config-replicas":  # an ensemble: each worker gets every replica's URL
        seen = _config_seen(_launch("-w", "-config-replicas", "3", "-np", "2", sys.executable,
                                    "-c", SHOW_URLS))
        assert len(seen) == 2 and seen[0] == seen[1] and seen[0][1:] == [0, 2]
        assert len(seen[0][0].split(",")) == 3
        with pytest.raises(SystemExit):  # its replicas take free ports, not -port's
            cli.main(["-w", "-config-replicas", "3", "-port", str(port), "-np", "1",
                      sys.executable, "-c", "pass"])
        with pytest.raises(SystemExit):
            cli.main(["-w", "-config-replicas", "0", "-np", "1", sys.executable, "-c", "pass"])
    elif flag == "-w":  # watch mode without a URL embeds a config server
        seen = _config_seen(_launch("-w", "-np", "2", "-port", str(port), sys.executable, "-c",
                                    SHOW_CONFIG))
        assert seen == [[f"http://127.0.0.1:{port}/config", 0, 2]] * 2
    elif flag == "-timeout":  # the watch stops a job that outlives it: exit 124
        t0 = time.monotonic()
        out = _launch("-w", "-timeout", "2", "-port", str(port), "-np", "1", sys.executable,
                      "-c", "import time; time.sleep(60)")
        assert out.returncode == 124 and time.monotonic() - t0 < 40, out.stderr[-2000:]
        with pytest.raises(SystemExit):  # it bounds watch mode only
            cli.main(["-timeout", "2", "-np", "1", sys.executable, "-c", "pass"])
    elif flag == "-config-server":  # an external service: the workers get its URL
        from kungfu_tpu_torch.elastic import ConfigServer

        cluster = Cluster.from_hostlist(HostList.parse("127.0.0.1:1"), 1)
        srv = ConfigServer(port=port, init=cluster).start()
        try:
            seen = _config_seen(_launch("-w", "-config-server", srv.url, "-np", "1",
                                        sys.executable, "-c", SHOW_CONFIG))
        finally:
            srv.stop()
        assert seen == [[srv.url, 0, 1]]
    elif flag == "-builtin-config-server":  # embedded in a static launch too
        seen = _config_seen(_launch("-builtin-config-server", "-port", str(port), "-np", "2",
                                    sys.executable, "-c", SHOW_CONFIG))
        assert seen == [[f"http://127.0.0.1:{port}/config", 0, 2]] * 2
    else:  # -port: the embedded server's port, refused where nothing is embedded
        seen = _config_seen(_launch("-w", "-port", str(port), "-np", "1", sys.executable, "-c",
                                    SHOW_CONFIG))
        assert seen[0][0] == f"http://127.0.0.1:{port}/config"
        with pytest.raises(SystemExit):
            cli.main(["-port", str(port), "-np", "1", sys.executable, "-c", "pass"])


def test_watch_failed_worker_stops_the_job(tmp_path):
    worker = ("import os, sys, time\n"
              "if os.environ['KFT_SELF_SPEC'].endswith(':10000'):\n"
              "    time.sleep(0.5); sys.exit(3)\n"
              "time.sleep(60)\n")
    t0 = time.monotonic()
    out = _launch("-w", "-port", str(_free_port()), "-np", "2", sys.executable, "-c", worker)
    assert out.returncode == 3 and time.monotonic() - t0 < 45, out.stdout + out.stderr
    keep = _launch("-w", "-k", "-port", str(_free_port()), "-np", "2", sys.executable, "-c",
                   worker.replace("time.sleep(60)", "time.sleep(1)"))
    assert keep.returncode == 0, keep.stdout + keep.stderr  # the failure is kept out


def test_watch_runner_idle_host_and_healer_refusals(monkeypatch):
    """A host the document shrank to no workers waits for the config
    server to go away, then exits 0; the healer's options, once refused,
    now arm it."""
    from kungfu_tpu_torch.run.job import Job
    from kungfu_tpu_torch.run.launcher import WatchRunner

    elsewhere = Cluster.from_hostlist(HostList.parse("10.0.0.9:2"), 2)
    answers = iter([(elsewhere, 1)])
    client = type("Client", (), {"poll_cluster": lambda self: next(answers, None)})()
    job = Job(prog=sys.executable, args=["-c", "pass"], strategy=Strategy.AUTO)
    runner = WatchRunner(job, "127.0.0.1", client, poll_s=0.01)
    monkeypatch.setattr(WatchRunner, "IDLE_EXIT_S", 0.2)
    assert runner.run() == 0 and runner.version == 1 and not runner.current
    healer = WatchRunner(job, "127.0.0.1", client, heal=True, restart_budget=2,
                         heartbeat_timeout_s=5.0)
    assert (healer.heal, healer.restart_budget, healer.heartbeat_timeout_s) == (True, 2, 5.0)
    assert healer._judge is not None and healer.suspicion_s == 10.0
    assert WatchRunner(job, "127.0.0.1", client)._judge is None


def test_serve_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        cli.main(["-serve", "-np", "1"])


@pytest.mark.parametrize("argv,flags,prog", [
    (["-np", "2", "python", "-c", "pass"], ["-np", "2"], ["python", "-c", "pass"]),
    (["-k", "-q", "-np", "2", "--", "-x", "-np"], ["-k", "-q", "-np", "2"], ["-x", "-np"]),
    (["python", "train.py", "-k"], [], ["python", "train.py", "-k"]),
])
def test_worker_command_is_never_parsed_as_flags(argv, flags, prog):
    ap = argparse.ArgumentParser()
    ap.add_argument("-np", type=int)
    ap.add_argument("-k", action="store_true")
    ap.add_argument("-q", action="store_true")
    ap.add_argument("-chips-per-host", type=int)
    assert cli._split(argv, ap) == (flags, prog)


def test_launcher_needs_a_worker_command():
    with pytest.raises(SystemExit):
        cli.main(["-np", "2"])


def test_peer_list_is_host_major():
    assert HostList.parse("a:2,b:1").gen_peer_list(3) == PeerList(
        [PeerID("a", 10000), PeerID("a", 10001), PeerID("b", 10000)])
    with pytest.raises(ValueError):
        HostList.parse("a:1").gen_peer_list(2)


def _replicas(launcher_pid: int) -> dict:
    """{port: pid} of the config-server replicas the launcher spawned
    (read from /proc: each child's command line)."""
    out = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().decode().split("\0")
        except (OSError, ValueError, IndexError):
            continue
        if ppid == launcher_pid and "kungfu_tpu_torch.elastic.config_server" in argv:
            out[int(argv[argv.index("-port") + 1])] = int(pid)
    return out


def test_config_replicas_resize_through_a_leader_kill(tmp_path):
    """`-w -config-replicas 3`: the workers get the ensemble's URL list
    (KFT_CONFIG_URLS) and the fake trainer resizes 2 -> 3 -> 2 while the
    test SIGKILLs the leader after the grow; the shrink lands through the
    next leader, the killed replica is respawned at its port, and the
    elections and the respawn are journaled."""
    import signal

    from _torch_drills import LAUNCHER
    from _torch_ranks import MAX_WORKER_PORT, _free_port_range
    from kungfu_tpu_torch.elastic.config_client import ConfigClient
    from kungfu_tpu_torch.monitor.journal import read_journal_segments
    from kungfu_tpu_torch.store import STORE_PORT_OFFSET

    host, jdir = "127.0.0.21", tmp_path / "journal"
    base = _free_port_range(2, MAX_WORKER_PORT, (STORE_PORT_OFFSET,))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", KFT_JOURNAL_DIR=str(jdir),
               KFT_FAULT_PLAN="slow@step=0:rank=0:ms=300:steps=100")
    p = subprocess.Popen(
        [sys.executable, "-c", LAUNCHER, str(base), "-w", "-np", "2", "-H", f"{host}:4",
         "-self", host, "-platform", "cpu", "-config-replicas", "3", "-timeout", "200", "--",
         sys.executable, "-m", "kungfu_tpu_torch.testing.fake_adaptive_trainer", "--schedule",
         "2:8,3:8,2:100", "--total-samples", "2048", "--check-every", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        while len(_replicas(p.pid)) < 3 and time.monotonic() < deadline:
            time.sleep(0.1)
        pids = _replicas(p.pid)
        assert len(pids) == 3, pids
        urls = [f"http://127.0.0.1:{port}/config" for port in sorted(pids)]
        client = ConfigClient(",".join(urls), retries=20, retry_deadline_s=30.0)
        while (client.get_health() or {}).get("version", 0) < 1:  # the grow to 3 landed
            assert time.monotonic() < deadline and p.poll() is None
            time.sleep(0.05)
        statuses = [_status(u) for u in urls]
        at = next(i for i, st in enumerate(statuses) if st and st["role"] == "leader")
        lead, epoch0, victim = statuses[at]["replica"], statuses[at]["epoch"], sorted(pids)[at]
        os.kill(pids[victim], signal.SIGKILL)
        new = None
        while new is None and time.monotonic() < deadline:
            sts = [_status(u) for u in urls]
            new = next((st for st in sts if st and st["role"] == "leader"
                        and st["epoch"] > epoch0), None)
            time.sleep(0.05)
        assert new is not None and new["replica"] != lead
        while _replicas(p.pid).get(victim) in (None, pids[victim]):  # respawned at its port
            assert time.monotonic() < deadline and p.poll() is None
            time.sleep(0.1)
        out, _ = p.communicate(timeout=200)
    finally:
        if p.poll() is None:  # a failed check: the launcher, then its replicas
            left = _replicas(p.pid)
            p.kill()
            p.communicate()
            for pid in left.values():
                os.kill(pid, signal.SIGKILL)
    assert p.returncode == 0, out[-4000:]
    results = [line for line in out.splitlines() if "RESULT:" in line]
    assert len(results) == 2 and out.count("DETACHED:") == 1, out[-4000:]
    for line in results:
        assert "resizes=2 " in line and "trained=2048 " in line and "final_size=2 " in line
    events = [e for f in sorted(jdir.glob("journal-*.jsonl"))
              for e in read_journal_segments(str(f))]
    epochs = {e["leader_epoch"] for e in events if e["event"] == "leader_elected"}
    assert len(epochs) >= 2 and max(epochs) >= new["epoch"], sorted(epochs)
    assert [e["replica"] for e in events if e["event"] == "replica_respawned"] == [lead]
    assert not _replicas(p.pid)  # the ensemble went with the launcher


def _status(url: str):
    try:
        with urllib.request.urlopen(url.rsplit("/", 1)[0] + "/raft/status", timeout=1) as r:
            return json.loads(r.read().decode())
    except OSError:
        return None
