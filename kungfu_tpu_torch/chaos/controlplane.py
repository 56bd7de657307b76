"""The coordinator-failover drill: the replicated control plane under
fire (counterpart of kungfu_tpu.chaos.controlplane).

`python -m kungfu_tpu_torch.chaos --coordinator-drill` stands up a
3-replica config-server ensemble (elastic/ensemble.py) and sends it the
repo's CAS traffic (a healer-style size flipper, two autoscaler impostors
racing it, a reconvene nudger and a KV heartbeat writer, each through the
comma-list failover ConfigClient), then:

  phase 1  SIGKILLs the leader mid-traffic (the supervisor respawns it; the
           replica rejoins from the new leader's snapshot), and
  phase 2  SIGSTOPs the next leader, the partitioned coordinator (a live
           process that has silently lost its lease), waits for the
           election, then SIGCONTs it and requires the deposed leader to
           step down rather than serve from stale state.

A write that a majority holds but that was answered "unavailable" may
still commit under the new leader (a phantom commit), so the invariants
are inequalities and uniqueness, never exact equality:

  - zero dropped requests (no client call fails past its retry budget);
  - each thread's observed versions are monotonic (the stale-epoch check);
  - the expect_versions of the conditional PUTs reported committed are
    distinct (two winners on one version would be a lost update);
  - final_version >= v0 + reported commits (phantoms only push it up);
  - commits resume after each failover, the gap between consecutive
    commits under GAP_BOUND_S;
  - `leader_elected` (boot and both failovers) and `replica_respawned`
    journaled, and every live replica converges to the leader's log
    before the drill ends.
"""
from __future__ import annotations

import glob
import logging
import os
import random
import shutil
import tempfile
import threading
import time
from typing import List, Optional

#: client budget: generous enough to ride out an election (~1-2 s) plus a
#: SIGSTOP'd endpoint eating one full connect timeout per rotation
_CLIENT_KW = dict(timeout_s=2.0, retries=10, backoff_s=0.05,
                  backoff_max_s=0.5, retry_deadline_s=20.0)

#: the commit-gap bound: the client retry budget plus scheduling slack —
#: a gap past this means requests were effectively dropped
GAP_BOUND_S = 25.0


class _Traffic:
    """One client thread's ledger."""

    def __init__(self, name: str, client, stop: threading.Event):
        self.name = name
        self.client = client
        self.stop = stop
        self.commits: List[tuple] = []   # (t_mono, expect_version) when ok
        self.versions: List[int] = []    # observed document versions, in order
        self.cas_losses = 0
        self.kv_ok = 0
        self.drops: List[str] = []       # must stay empty
        self.thread: Optional[threading.Thread] = None

    def start(self, fn) -> "_Traffic":
        self.thread = threading.Thread(target=fn, args=(self,), daemon=True,
                                       name=f"drill-{self.name}")
        self.thread.start()
        return self


def _cas_flipper(tr: _Traffic, lo: int = 3, hi: int = 4) -> None:
    """Healer/autoscaler shape: read (cluster, version), resize, CAS it
    back conditional on the version just read."""
    while not tr.stop.is_set():
        try:
            got = tr.client.get_cluster()
            if got is not None:
                c, v = got
                tr.versions.append(v)
                target = hi if c.size() <= lo else lo
                if tr.client.put_cluster(c.resize(target), version=v):
                    tr.commits.append((time.monotonic(), v))
                else:
                    tr.cas_losses += 1
        except OSError as e:
            tr.drops.append(f"{tr.name}: {type(e).__name__}: {e}")
        tr.stop.wait(0.05)


def _reconvener(tr: _Traffic) -> None:
    """Partition-heal nudge shape: bump the version without moving the
    document (conditional, so a racing resize wins)."""
    while not tr.stop.is_set():
        try:
            got = tr.client.get_cluster()
            if got is not None:
                c, v = got
                tr.versions.append(v)
                if tr.client.reconvene_cluster(c, v):
                    tr.commits.append((time.monotonic(), v))
                else:
                    tr.cas_losses += 1
        except OSError as e:
            tr.drops.append(f"{tr.name}: {type(e).__name__}: {e}")
        tr.stop.wait(0.15)


def _kv_heartbeat(tr: _Traffic) -> None:
    """Runner-heartbeat shape on the KV plane; a False from kv_put means
    the retry budget was exhausted — that IS a dropped request here."""
    n = 0
    while not tr.stop.is_set():
        n += 1
        try:
            if tr.client.kv_put(f"drill/hb/{tr.name}", {"n": n}):
                tr.kv_ok += 1
            else:
                tr.drops.append(f"{tr.name}: kv_put #{n} gave up")
            got = tr.client.kv_get(f"drill/hb/{tr.name}")
            if got is not None and got["value"]["n"] > n:
                tr.drops.append(f"{tr.name}: kv read from the future")
        except OSError as e:
            tr.drops.append(f"{tr.name}: {type(e).__name__}: {e}")
        tr.stop.wait(0.1)


def _journal_events(journal_dir: str) -> list:
    from ..monitor.journal import read_journal_segments

    events = []
    for p in sorted(glob.glob(os.path.join(journal_dir, "journal-*.jsonl"))):
        events.extend(read_journal_segments(p))
    return events


def run_coordinator_drill(replicas: int = 3, timeout_s: float = 300.0,
                          seed: int = 1234) -> dict:
    """Run the coordinator-failover drill; returns the summary dict.  The
    supervisor's journal events land in this process's journal, so the
    drill runs in a process of its own (the CLI's)."""
    from ..elastic.ensemble import ConfigEnsemble
    from ..plan import Cluster, HostList

    # CAS-storm losses are the drill's business, not WARNING-worthy noise
    logging.getLogger("kungfu.elastic").setLevel(logging.ERROR)

    random.seed(seed)  # the client's backoff jitter draws from this
    t_start = time.monotonic()
    failures: List[str] = []
    tmp = tempfile.mkdtemp(prefix="kft-coord-drill-")
    jdir = os.path.join(tmp, "journal")
    os.makedirs(jdir, exist_ok=True)
    old_jdir = os.environ.get("KFT_JOURNAL_DIR")
    os.environ["KFT_JOURNAL_DIR"] = jdir  # supervisor-side respawn events
    env = dict(os.environ, KFT_JOURNAL_DIR=jdir)

    init = Cluster.from_hostlist(HostList.parse("127.0.0.1:8"), 3)
    ens = ConfigEnsemble(replicas=replicas, init=init, env=env)
    stop = threading.Event()
    traffic: List[_Traffic] = []
    kills: List[dict] = []
    v0: Optional[int] = None
    t_kill = t_pause = float("inf")
    try:
        ens.start()
        probe = ens.client(**_CLIENT_KW)
        _, v0 = probe.wait_for_config(timeout_s=15.0)

        traffic = [
            _Traffic("healer", ens.client(**_CLIENT_KW), stop).start(_cas_flipper),
            _Traffic("scaler-a", ens.client(**_CLIENT_KW), stop).start(_cas_flipper),
            _Traffic("scaler-b", ens.client(**_CLIENT_KW), stop).start(_cas_flipper),
            _Traffic("reconvene", ens.client(**_CLIENT_KW), stop).start(_reconvener),
            _Traffic("kv-hb", ens.client(**_CLIENT_KW), stop).start(_kv_heartbeat),
        ]
        deadline = time.monotonic() + timeout_s

        # phase 1: SIGKILL the leader mid-traffic -------------------------
        time.sleep(2.0)
        led1 = ens.kill_leader()
        t_kill = time.monotonic()
        if led1 is None:
            failures.append("phase 1: no leader to kill")
        kills.append({"phase": 1, "replica": led1, "mode": "SIGKILL"})
        led2 = ens.leader(wait_s=min(20.0, deadline - time.monotonic()))
        if led2 is None:
            failures.append("phase 1: no new leader after the kill")
        time.sleep(3.0)  # traffic through the new leader; victim respawns

        # phase 2: SIGSTOP the leader (partitioned coordinator) -----------
        st_before = ens.raft_status(led2) if led2 is not None else None
        epoch_before = int(st_before["epoch"]) if st_before else 0
        t_pause = time.monotonic()
        if led2 is not None:
            ens.pause_replica(led2)
        kills.append({"phase": 2, "replica": led2, "mode": "SIGSTOP"})
        led3, t_stop_deadline = None, time.monotonic() + 20.0
        while time.monotonic() < min(t_stop_deadline, deadline):
            cand = ens.leader()
            if cand is not None and cand != led2:
                st = ens.raft_status(cand)
                if st and int(st.get("epoch", 0)) > epoch_before:
                    led3 = cand
                    break
            time.sleep(0.1)
        if led3 is None:
            failures.append("phase 2: no election past the paused leader")
        if led2 is not None:
            ens.resume_replica(led2)
        stepped = False
        t_res_deadline = time.monotonic() + 15.0
        while time.monotonic() < min(t_res_deadline, deadline):
            st = ens.raft_status(led2) if led2 is not None else None
            if st is not None and (st.get("role") != "leader"
                                   or int(st.get("epoch", 0)) > epoch_before):
                stepped = True
                break
            time.sleep(0.1)
        if not stepped:
            failures.append(f"phase 2: resumed replica {led2} still claims "
                            f"leadership of its stale epoch {epoch_before}")
        time.sleep(3.0)  # commits must resume post-failover
    except Exception as e:  # noqa: BLE001 — the drill must report, not die
        failures.append(f"drill harness error: {type(e).__name__}: {e}")
    finally:
        stop.set()
        for tr in traffic:
            if tr.thread is not None:
                tr.thread.join(timeout=30)

        # convergence: every live replica reaches the leader's commit
        converged = False
        conv_deadline = time.monotonic() + 15.0
        while time.monotonic() < conv_deadline:
            sts = [s for s in ens.statuses() if s is not None]
            if len(sts) == replicas:
                head = max(int(s.get("log_index", 0)) for s in sts)
                if all(int(s.get("commit", 0)) == head for s in sts):
                    converged = True
                    break
            time.sleep(0.2)

        final_version = None
        try:
            final = ens.client(**_CLIENT_KW).get_cluster()
            if final is not None:
                final_version = final[1]
        except OSError:
            pass
        ens.stop()
        if old_jdir is None:
            os.environ.pop("KFT_JOURNAL_DIR", None)
        else:
            os.environ["KFT_JOURNAL_DIR"] = old_jdir

    if not converged:
        failures.append("replicas did not converge to one committed log")

    # -- the ledger ------------------------------------------------------
    for tr in traffic:
        for d in tr.drops:
            failures.append(f"dropped request: {d}")
        if tr.versions != sorted(tr.versions):
            failures.append(f"{tr.name}: observed versions went backwards "
                            "(a stale-leader read was believed)")
    cas_commits = [c for tr in traffic for c in tr.commits
                   if tr.name != "kv-hb"]
    expect_versions = [v for _, v in cas_commits]
    dupes = sorted({v for v in expect_versions
                    if expect_versions.count(v) > 1})
    if dupes:
        failures.append(f"lost update: versions {dupes} were each won by "
                        "more than one reported-committed conditional PUT")
    if not cas_commits:
        failures.append("no conditional PUT ever committed")
    if final_version is None or v0 is None:
        failures.append("no final document readable after the drill")
    elif final_version < v0 + len(cas_commits):
        failures.append(
            f"final version {final_version} < v0 {v0} + {len(cas_commits)} "
            "reported commits: a reported-committed write never applied")

    times = sorted(t for tr in traffic for t, _ in tr.commits)
    max_gap = max((b - a for a, b in zip(times, times[1:])), default=None)
    if max_gap is None or max_gap > GAP_BOUND_S:
        failures.append(f"commit gap {max_gap}s exceeds the {GAP_BOUND_S}s "
                        "unavailability bound")
    if not any(t > t_kill for t in times):
        failures.append("no commit after the phase-1 leader kill")
    if not any(t > t_pause for t in times):
        failures.append("no commit after the phase-2 leader partition")

    events = _journal_events(jdir)
    shutil.rmtree(tmp, ignore_errors=True)
    by_kind: dict = {}
    for e in events:
        by_kind.setdefault(e.get("event", "?"), []).append(e)
    elections = by_kind.get("leader_elected", [])
    distinct_epochs = len({e.get("leader_epoch") for e in elections})
    if distinct_epochs < 3:
        failures.append(f"expected >=3 leader_elected epochs journaled "
                        f"(boot + two failovers), saw {distinct_epochs}")
    if not by_kind.get("replica_respawned"):
        failures.append("killed replica was never respawned (no "
                        "replica_respawned journal event)")

    total_commits = sum(len(tr.commits) for tr in traffic)
    return {
        "ok": not failures,
        "failures": failures,
        "replicas": replicas,
        "kills": kills,
        "v0": v0,
        "final_version": final_version,
        "cas_commits": len(cas_commits),
        "cas_losses": sum(tr.cas_losses for tr in traffic),
        "kv_commits": sum(tr.kv_ok for tr in traffic),
        "total_commits": total_commits,
        "max_commit_gap_s": round(max_gap, 2) if max_gap is not None else None,
        "respawns": ens.respawns,
        "elections_journaled": len(elections),
        "journal_counts": {k: len(v) for k, v in sorted(by_kind.items())},
        "wall_s": round(time.monotonic() - t_start, 1),
    }
