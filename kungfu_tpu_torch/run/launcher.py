"""Process supervisor (counterpart of kungfu_tpu.run.launcher).

Static mode (`simple_run`): start every local worker, prefix its output
with its rank, wait for all, and on the first failure stop the rest
(unless keep) and return that worker's exit code.

Watch mode (`WatchRunner`, reference runner/watch.go:42-135): poll the
elastic config service and, as its document's version advances, stop
the local workers it removed and start the ones it added (the reference
pushes Stage updates over its TCP control channel; polling the config
server is the JAX package's HTTP-only redesign: workers PUT, runners
GET).  With heal=True it is the JAX package's self-healing supervisor: a
worker's unplanned death (a non-zero exit, or a heartbeat frozen past
`heartbeat_timeout_s`) removes it from the document by a conditional PUT
that keeps the survivors' order, the survivors pick the shrunk document
up through run_elastic's recovery path, and each worker gets
`restart_budget` restarts after an exponential backoff, regrown into the
document as a joiner.  Remote hosts are judged by their runners'
heartbeats (`RemoteHostJudge`: a partition is not a death).
"""
from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..monitor.journal import journal_event
from ..plan import Cluster, PeerID, PeerList
from ..utils import get_logger
from .job import ChipPool, Job, Proc

log = get_logger("kungfu.run")

_COLORS = [36, 32, 33, 35, 34, 31]  # cyan green yellow magenta blue red


class RemoteHostJudge:
    """Partition-vs-death judgment for REMOTE hosts (counterpart of the JAX
    package's, the same state machine).

    The local healer only sees local worker exits; a whole host lost to
    `kill_host` leaves no launcher behind to heal it, and a network
    partition makes every cross-partition peer *look* dead from inside the
    data plane.  The distinguishing signal is the runner heartbeat each
    launcher writes to the config server's KV plane (`runner-hb/<host>`,
    stamped with the SERVER's receive time — no cross-host clock compare):
    the control plane rides a different network than the data plane in real
    pods, so a partitioned-but-alive host keeps beating while a dead one
    goes silent.

      host stale      heartbeat missing/old past `stale_after_s` — journal
                      `host_suspected`, start the suspicion clock.  A
                      heartbeat that returns mid-window journals
                      `host_suspect_cleared` and NO shrink happens.
      host dead       stale continuously for `suspicion_s` — the LEADER
                      (first runner-doc host with a fresh heartbeat)
                      CAS-shrinks ALL of that host's workers out in one
                      conditional PUT: exactly one shrink per real host
                      death, by construction (losers of the CAS re-read
                      and find the host already gone).
      partition       workers report suspected-dead peers (`suspect/<peer>`
                      KV entries, written on entering recovery) while every
                      runner heartbeat stays fresh — journal
                      `partition_suspected`, never shrink, and have the
                      leader nudge a `reconvene` version bump every
                      `reconvene_interval_s` so the waiting workers
                      re-rendezvous (at unchanged membership) as soon as
                      the partition heals.

    Pure state machine — HTTP and process control stay in WatchRunner, so
    the judgment is unit-testable with synthetic tables.
    """

    def __init__(self, self_host: str, suspicion_s: float = 10.0,
                 stale_after_s: float = 3.0, reconvene_interval_s: float = 0.0,
                 journal=journal_event):
        self.self_host = self_host
        self.suspicion_s = float(suspicion_s)
        self.stale_after_s = float(stale_after_s)
        self.reconvene_interval_s = float(reconvene_interval_s) or max(
            2.0 * self.suspicion_s, 5.0
        )
        self.journal = journal
        self._suspected_since: Dict[str, float] = {}
        self._journaled: set = set()
        self.partition_active = False
        self._last_reconvene = -1e18

    def clear(self, host: str) -> None:
        """Forget a host's suspicion (after its shrink, or when it left the
        document)."""
        self._suspected_since.pop(host, None)
        self._journaled.discard(host)

    def assess(self, cluster: Cluster, hb: Dict[str, dict],
               suspects: Dict[str, dict], now: float,
               version: Optional[int] = None) -> Dict[str, object]:
        """One judgment sweep.

        Args:
          cluster: the current document.
          hb: `runner-hb/` KV entries ({key: {"t_server": float, ...}}).
          suspects: `suspect/` KV entries (worker recovery reports).
          now: the SERVER's clock from the same kv_list response.
          version: the current document version — suspects filed against an
            OLDER version are explained by the membership change that
            followed them (their filers are re-rendezvousing, not
            partitioned) and carry no partition evidence.

        Returns {"leader": bool, "shrink": [host, ...], "partition": bool,
        "reconvene": bool, "stale": {host: age_or_None}}.
        """
        worker_hosts = cluster.workers.hosts()
        runner_hosts = [r.host for r in cluster.runners]

        def age_of(host: str):
            if host == self.self_host:
                return 0.0  # we are alive by construction
            e = hb.get(f"runner-hb/{host}")
            return None if e is None else max(0.0, now - float(e.get("t_server", 0.0)))

        fresh = {h for h in runner_hosts
                 if (lambda a: a is not None and a <= self.stale_after_s)(age_of(h))}
        fresh.add(self.self_host)
        leader_host = next((h for h in runner_hosts if h in fresh), self.self_host)
        leader = leader_host == self.self_host

        stale: Dict[str, object] = {}
        shrink = []
        for host in worker_hosts:
            if host == self.self_host:
                continue
            age = age_of(host)
            if host in fresh:
                if host in self._suspected_since:
                    self._suspected_since.pop(host)
                    if host in self._journaled:
                        self._journaled.discard(host)
                        log.info("host %s heartbeat returned; suspicion "
                                 "cleared", host)
                        self.journal("host_suspect_cleared", host=host)
                continue
            stale[host] = None if age is None else round(age, 2)
            since = self._suspected_since.get(host)
            # a host that NEVER beat gets a doubled window and a quiet
            # clock: launcher boot staggering at fleet start must neither
            # read as death nor spam the journal; a host that beat and
            # went silent is suspected (journaled) immediately
            window = self.suspicion_s * (2.0 if age is None else 1.0)
            if since is None:
                self._suspected_since[host] = now
            if host not in self._journaled and (
                    age is not None
                    or now - self._suspected_since[host] >= window / 2.0):
                self._journaled.add(host)
                log.warning("host %s heartbeat %s; suspecting (window %.1fs)",
                            host, "missing" if age is None else f"stale {age:.1f}s",
                            window)
                self.journal("host_suspected", host=host,
                             age_s=stale[host], window_s=window)
            if since is not None and now - since >= window:
                shrink.append(host)
        # drop suspicion state for hosts that left the document entirely
        for host in list(self._suspected_since):
            if host not in worker_hosts:
                self._suspected_since.pop(host)
                self._journaled.discard(host)

        # partition: recovery reports with every runner heartbeat fresh.
        # Any stale host explains the suspects as a (suspected) death
        # instead, so the two judgments never fire together.  The evidence
        # must also be OLDER than the staleness threshold: right after a
        # host dies its heartbeat is still fresh for up to stale_after_s,
        # and declaring a partition in that gap would reconvene a document
        # that still contains the dead host (guaranteed failed rendezvous).
        def _is_evidence(entry: dict) -> bool:
            if version is not None:
                try:
                    filed_at = int((entry.get("value") or {}).get(
                        "cluster_version", -1))
                except (TypeError, ValueError):
                    filed_at = -1
                if filed_at < version:
                    return False  # a membership change already answered it
            return True

        live_suspects = sorted(
            k.split("/", 1)[1] for k, v in suspects.items()
            if k.startswith("suspect/") and _is_evidence(v)
        )
        evidence_aged = any(
            now - float(v.get("t_server", now)) >= self.stale_after_s + 1.0
            for k, v in suspects.items()
            if k.startswith("suspect/") and _is_evidence(v)
        )
        partition = bool(live_suspects) and evidence_aged and not stale
        if partition and not self.partition_active:
            log.warning("partition suspected: %d worker(s) report dead peers "
                        "but every runner heartbeat is fresh — NOT shrinking",
                        len(live_suspects))
            self.journal("partition_suspected", suspects=live_suspects,
                         hosts=worker_hosts)
        elif self.partition_active and not live_suspects:
            self.journal("partition_cleared", hosts=worker_hosts)
        self.partition_active = partition

        reconvene = False
        if partition and leader and (
                now - self._last_reconvene >= self.reconvene_interval_s):
            self._last_reconvene = now
            reconvene = True
        return {"leader": leader, "shrink": shrink, "partition": partition,
                "reconvene": reconvene, "stale": stale}


def install_signal_trap() -> None:
    """Turn SIGTERM into KeyboardInterrupt, so a launcher that is killed
    stops its workers instead of orphaning them.  No-op off the main
    thread."""

    def _raise(signum, frame):  # noqa: ARG001
        signal.signal(signal.SIGTERM, signal.SIG_IGN)  # one-shot
        raise KeyboardInterrupt(f"signal {signum}")

    try:
        signal.signal(signal.SIGTERM, _raise)
    except ValueError:  # not the main thread
        pass


class ProcRunner:
    """One worker subprocess with its output pumped through a rank prefix."""

    def __init__(self, proc: Proc, logdir: str = "", quiet: bool = False):
        self.proc = proc
        self.logdir = logdir
        self.quiet = quiet
        self.popen: Optional[subprocess.Popen] = None
        self._pump: Optional[threading.Thread] = None

    def start(self) -> None:
        self.popen = subprocess.Popen(self.proc.args, env=self.proc.env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, bufsize=1)
        logfile = None
        if self.logdir:
            os.makedirs(self.logdir, exist_ok=True)
            logfile = open(os.path.join(self.logdir, f"worker-{self.proc.name}.log"), "w")
        name = self.proc.name
        color = _COLORS[int(name) % len(_COLORS)] if name.isdigit() else 37
        prefix = f"\x1b[{color}m[{name}]\x1b[0m " if sys.stdout.isatty() else f"[{name}] "

        def pump():
            for line in self.popen.stdout:
                if logfile:
                    logfile.write(line)
                    logfile.flush()
                if not self.quiet:
                    sys.stdout.write(prefix + line)
                    sys.stdout.flush()
            if logfile:
                logfile.close()

        self._pump = threading.Thread(target=pump, daemon=True)
        self._pump.start()

    def wait(self) -> int:
        rc = self.popen.wait()
        if self._pump:
            self._pump.join(timeout=5)
        return rc

    def terminate(self, grace_s: float = 5.0) -> None:
        if self.popen and self.popen.poll() is None:
            self.popen.terminate()
            try:
                self.popen.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                self.popen.kill()
                self.popen.wait()


def simple_run(job: Job, cluster: Cluster, self_host: str, version: int = 0,
               logdir: str = "", quiet: bool = False, keep: bool = False) -> int:
    """Spawn this host's workers and wait; the first non-zero exit code is
    returned, and unless `keep` the other workers are stopped at once."""
    local = [p for p in cluster.workers if p.host == self_host]
    pool = ChipPool(job.cards_per_host) if job.cards_per_host else None
    runners: List[ProcRunner] = []
    failed = 0
    try:
        # spawn inside the protected region: a SIGTERM mid-startup still
        # stops the workers already running
        for peer in local:
            chip = pool.get() if pool else -1
            r = ProcRunner(job.new_proc(peer, chip if chip is not None else -1, cluster, version),
                           logdir=logdir, quiet=quiet)
            r.start()
            runners.append(r)
        log.info("spawned %d/%d workers on %s", len(local), cluster.size(), self_host)
        pending = list(runners)
        while pending:
            for r in list(pending):
                rc = r.popen.poll()
                if rc is None:
                    continue
                r.wait()  # joins the output pump: keep the tail lines
                pending.remove(r)
                if rc != 0:
                    failed = failed or rc
                    log.error("worker %s exited with %d", r.proc.name, rc)
                    if not keep:
                        for other in pending:
                            other.terminate()
                        pending = []
                        break
            time.sleep(0.05)
    except KeyboardInterrupt:
        for r in runners:
            r.terminate()
        return 130
    return failed




class WatchRunner:
    """Watch mode: reconcile this host's workers against the config
    service's cluster document as its version advances; with heal=True, the
    self-healing supervisor (see the module docstring)."""

    IDLE_EXIT_S = 60.0  # a host shrunk to no workers waits this long for a gone server
    # a removed worker leaves its group (a collective teardown: a card sync
    # and the ring workspaces' barriers) and exits by itself; SIGTERM only
    # asks, and the kill waits this long for it
    KILL_GRACE_S = 30.0

    def __init__(self, job: Job, self_host: str, client, logdir: str = "", quiet: bool = False,
                 keep: bool = False, poll_s: float = 0.5, heal: bool = False,
                 restart_budget: int = 0, heartbeat_timeout_s: float = 0.0,
                 restart_backoff_s: float = 2.0, suspicion_s: float = 0.0,
                 runner_hb_interval_s: float = 1.0):
        self.job = job
        self.self_host = self_host
        self.client = client
        self.logdir = logdir
        self.quiet = quiet
        self.keep = keep
        self.poll_s = poll_s
        self.heal = heal
        self.restart_budget = restart_budget
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.restart_backoff_s = restart_backoff_s
        # remote-host judgment, armed in heal mode: the suspicion window
        # defaults off the heartbeat timeout, so a whole-host loss is judged
        # on the same timescale as a hung worker
        self.suspicion_s = suspicion_s or (
            2.0 * heartbeat_timeout_s if heartbeat_timeout_s > 0 else 10.0)
        self.runner_hb_interval_s = runner_hb_interval_s
        self._judge = RemoteHostJudge(
            self_host, suspicion_s=self.suspicion_s,
            stale_after_s=max(3.0 * runner_hb_interval_s, 3.0)) if heal else None
        self._last_hb_put = -1e18
        self._last_hosts: Optional[set] = None
        self.current: Dict[PeerID, ProcRunner] = {}
        self.pool: Optional[ChipPool] = ChipPool(job.cards_per_host) if job.cards_per_host else None
        self.version = -1
        self.heal_events: List[dict] = []
        self._chip_of: Dict[PeerID, int] = {}
        self._last_want = -1  # local workers wanted at the last reconcile
        self._idle_since: Optional[float] = None
        self._restarts: Dict[PeerID, int] = {}  # restarts used per peer
        self._regrow_at: Dict[PeerID, float] = {}  # scheduled regrow times
        self._last_rc = 0
        self._healed_to_zero = False
        self._hb_amnesty_until = 0.0  # no staleness kills before this time
        # graded stall judgment: peer -> (mtime when first seen past the
        # timeout, monotonic time of that sight); a stale but advancing
        # heartbeat is slow-but-alive, not hung
        self._stale_seen: Dict[PeerID, tuple] = {}
        self._slow_journaled_at: Dict[PeerID, float] = {}

    def _spawn(self, peer: PeerID, cluster: Cluster, version: int) -> None:
        chip = self.pool.get() if self.pool else -1
        chip = chip if chip is not None else -1
        proc = self.job.new_proc(peer, chip, cluster, version)
        hb = proc.env.get("KFT_HEARTBEAT_FILE")
        if hb:
            # pre-touch: a worker that wedges before its first step still
            # gets the whole heartbeat timeout, measured from its spawn
            os.makedirs(os.path.dirname(hb), exist_ok=True)
            with open(hb, "w"):
                pass
        r = ProcRunner(proc, logdir=self.logdir, quiet=self.quiet)
        r.start()
        self.current[peer] = r
        self._chip_of[peer] = chip
        log.info("[v%d] + worker %s", version, peer)

    def _kill(self, peer: PeerID) -> None:
        r = self.current.pop(peer, None)
        self._stale_seen.pop(peer, None)
        self._slow_journaled_at.pop(peer, None)
        if r is not None:
            r.terminate(grace_s=self.KILL_GRACE_S)
            if self.pool:
                self.pool.put(self._chip_of.pop(peer, -1))
            log.info("- worker %s", peer)

    def reconcile(self, cluster: Cluster, version: int) -> None:
        """Stop the local workers the document removed, start the ones it
        added (watch.go:64-83)."""
        want = {p for p in cluster.workers if p.host == self.self_host}
        have = set(self.current)
        for peer in sorted(have - want):
            self._kill(peer)
        for peer in sorted(want - have):
            self._spawn(peer, cluster, version)
        if self.heal:
            # a host this runner's judge suspected left the document: its
            # epoch's flows are torn, so a rank blocked two ring hops away
            # on a healthy socket errors out now instead of at its stall
            # deadline (a host that left with a fresh heartbeat detached on
            # purpose, and its epoch tears down gracefully)
            new_hosts = {p.host for p in cluster.workers}
            old_hosts = self._last_hosts or set()
            vanished = old_hosts - new_hosts - {self.self_host}
            if any(h in self._judge._suspected_since for h in vanished):
                root_port = cluster.workers[0].port if cluster.workers else 10000
                for host in sorted((old_hosts | new_hosts) - {self.self_host}):
                    self._kill_stale_flows(host, root_port=root_port)
            self._last_hosts = new_hosts
        self.version = version
        self._last_want = len(want)
        if cluster.size() > 0:
            self._healed_to_zero = False  # an operator's or a regrow's PUT revived the job

    def _stalest_worker(self):
        """(age, peer, runner) of the most stale frozen worker, or None.

        A hung rank wedges its peers too (they block in the collective
        waiting for it), but their stall watchdogs keep their heartbeat
        files fresh: only the wedged worker goes stale.  The judgment is
        graded: a heartbeat past the timeout whose mtime still advances
        between sweeps is slow-but-alive (journaled `worker_slow`, never
        killed); only one frozen at the same mtime for a further full
        timeout is hung, so a frozen worker dies at about twice the
        timeout.  One worker a sweep, the stalest first; then an amnesty
        window, so the survivors get a whole timeout to rejoin."""
        if not (self.heal and self.heartbeat_timeout_s > 0):
            return None
        if time.monotonic() < self._hb_amnesty_until:
            return None
        worst = None
        for peer, r in self.current.items():
            if r.popen is None or r.popen.poll() is not None:
                continue  # a finished process is the exit-code path's business
            hb = r.proc.env.get("KFT_HEARTBEAT_FILE")
            if not hb:
                continue
            try:
                mtime = os.path.getmtime(hb)
            except OSError:
                continue  # pre-touched at spawn; missing means already healed
            age = time.time() - mtime
            if age <= self.heartbeat_timeout_s:
                self._stale_seen.pop(peer, None)
                continue
            seen = self._stale_seen.get(peer)
            if seen is None or seen[0] != mtime:
                # stale, but it moved since the last judgment: slow-but-alive
                self._stale_seen[peer] = (mtime, time.monotonic())
                now = time.monotonic()
                if now - self._slow_journaled_at.get(peer, -1e9) > self.heartbeat_timeout_s:
                    self._slow_journaled_at[peer] = now
                    log.warning("worker %s heartbeat stale %.1fs but advancing: "
                                "slow-but-alive, not killing", peer, age)
                    journal_event("worker_slow", peer=str(peer), age_s=round(age, 1),
                                  timeout_s=self.heartbeat_timeout_s)
                continue
            if time.monotonic() - seen[1] < self.heartbeat_timeout_s:
                continue  # the same mtime, but not frozen long enough yet
            if worst is None or age > worst[0]:
                worst = (age, peer, r)
        return worst

    def _heal_dead(self, peer: PeerID, rc: int) -> None:
        """Remove a dead local worker from the cluster document, then
        schedule a budgeted restart.  The removal is a pure deletion, so
        the surviving head stays rank 0 (the reference's "new root must be
        an old worker" guard, peer.go:211-222); the PUT is conditional, so
        concurrent heals from other hosts re-read and re-derive."""
        journal_event("worker_failure", peer=str(peer), rc=rc)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            got = self.client.poll_cluster()
            if got is None:
                time.sleep(self.poll_s)
                continue
            cluster, version = got
            if cluster.workers.rank(peer) is None:
                # a planned detach (preemption's self-removal, an operator's
                # shrink) that raced the exit collection: nothing to heal
                log.info("worker %s already absent from v%d; no heal needed", peer, version)
                return
            shrunk = Cluster(runners=cluster.runners,
                             workers=PeerList(p for p in cluster.workers if p != peer))
            if not self.client.put_cluster(shrunk, version=version):
                continue  # lost the CAS race, or a flap: re-read and retry
            log.warning("HEAL: worker %s died (rc=%d); cluster %d -> %d workers (v%d -> v%d)",
                        peer, rc, cluster.size(), shrunk.size(), version, version + 1)
            self.heal_events.append({"peer": str(peer), "rc": rc, "old_size": cluster.size(),
                                     "new_size": shrunk.size(), "version": version + 1})
            journal_event("heal_shrink", peer=str(peer), rc=rc, old_size=cluster.size(),
                          new_size=shrunk.size(), cluster_version=version + 1)
            self._healed_to_zero = shrunk.size() == 0
            self._schedule_restart(peer)
            return
        log.error("heal of %s gave up: config server unreachable for 30s", peer)

    def _schedule_restart(self, peer: PeerID) -> None:
        used = self._restarts.get(peer, 0)
        if used >= self.restart_budget:
            if self.restart_budget:
                log.warning("restart budget exhausted for %s (%d used)", peer, used)
            return
        self._restarts[peer] = used + 1
        # exponential backoff with jitter: a transient crash gets a quick
        # retry, a crash loop backs off and burns the budget
        delay = min(self.restart_backoff_s * (2 ** used), 60.0)
        delay *= 0.8 + 0.4 * random.random()
        self._regrow_at[peer] = time.monotonic() + delay
        log.info("restart %d/%d of %s scheduled in %.1fs", used + 1, self.restart_budget,
                 peer, delay)

    def _remote_tick(self) -> None:
        """The runner heartbeat and the remote-host judgment, once every
        `runner_hb_interval_s`.  Every HTTP leg is best-effort: a
        control-plane brownout skips the sweep, never kills the launcher."""
        if self._judge is None:
            return
        kv_put = getattr(self.client, "kv_put", None)
        kv_list = getattr(self.client, "kv_list", None)
        if kv_put is None or kv_list is None:  # test doubles without the KV plane
            return
        now = time.monotonic()
        if now - self._last_hb_put < self.runner_hb_interval_s:
            return
        self._last_hb_put = now
        kv_put(f"runner-hb/{self.self_host}", {"pid": os.getpid()})
        got = self.client.poll_cluster()
        if got is None:
            return
        cluster, version = got
        if cluster.workers.host_count() <= 1:
            return  # nothing remote to judge
        hb = kv_list("runner-hb/")
        suspects = kv_list("suspect/")
        if hb is None or suspects is None:
            return
        actions = self._judge.assess(cluster, hb.get("entries", {}),
                                     suspects.get("entries", {}), float(hb.get("now", 0.0)),
                                     version=version)
        if actions["reconvene"]:
            reconvene = getattr(self.client, "reconvene_cluster", None)
            if reconvene is not None and reconvene(cluster, version):
                log.warning("reconvene: bumped document to v%d at unchanged membership "
                            "(partition-heal nudge)", version + 1)
                journal_event("reconvene", cluster_version=version + 1, size=cluster.size())
        if not actions["leader"]:
            return  # a non-leader never shrinks: exactly one CAS a host death
        for host in actions["shrink"]:
            self._shrink_host(host)

    def _shrink_host(self, host: str) -> None:
        """The leader's shrink of a dead host: all its workers (and its
        runner, which is gone with it) in one conditional PUT."""
        got = self.client.poll_cluster()
        if got is None:
            return
        cluster, version = got
        victims = [p for p in cluster.workers if p.host == host]
        if not victims:
            self._judge.clear(host)  # someone else healed it: stand down
            return
        shrunk = Cluster(runners=PeerList(r for r in cluster.runners if r.host != host),
                         workers=PeerList(p for p in cluster.workers if p.host != host))
        if not self.client.put_cluster(shrunk, version=version):
            return  # CAS lost: re-read on the next tick
        log.warning("HOST HEAL: %s silent past %.1fs suspicion; cluster %d -> %d workers "
                    "(v%d -> v%d, %d ranks removed at once)", host, self.suspicion_s,
                    cluster.size(), shrunk.size(), version, version + 1, len(victims))
        self.heal_events.append({"host": host, "workers": [str(p) for p in victims],
                                 "old_size": cluster.size(), "new_size": shrunk.size(),
                                 "version": version + 1})
        journal_event("host_heal_shrink", host=host, workers=[str(p) for p in victims],
                      old_size=cluster.size(), new_size=shrunk.size(),
                      cluster_version=version + 1)
        self._judge.clear(host)
        kv_delete = getattr(self.client, "kv_delete", None)
        if kv_delete is not None:
            for p in victims:
                kv_delete(f"suspect/{p}")  # the dead workers' reports are moot
        # the survivors now tear down and rejoin: restart their staleness clock
        self._hb_amnesty_until = time.monotonic() + max(self.heartbeat_timeout_s,
                                                        self.suspicion_s)

    @staticmethod
    def _kill_stale_flows(host: str, root_port: int = 10000) -> None:
        """RST this machine's data-plane TCP flows to `host` (`ss -K`), so a
        silent dead-host deadlock becomes a catchable connection abort; the
        version-fenced rendezvous window is exempt.  Best-effort: without
        `ss` (or a kernel without SOCK_DESTROY) it does nothing, and the
        stall deadline stays the backstop."""
        import shutil

        from ..peer import COORDINATOR_PORT_OFFSET, COORDINATOR_PORT_WINDOW

        if shutil.which("ss") is None:
            return
        lo = root_port + COORDINATOR_PORT_OFFSET
        hi = lo + COORDINATOR_PORT_WINDOW
        r = subprocess.run(
            ["ss", "-K", "dst", host,
             "(", "dport", "lt", f":{lo}", "or", "dport", "gt", f":{hi}", ")",
             "and",
             "(", "sport", "lt", f":{lo}", "or", "sport", "gt", f":{hi}", ")"],
            capture_output=True, text=True)
        log.warning("killed stale TCP flows to vanished-epoch host %s (rc=%d)", host,
                    r.returncode)
        journal_event("stale_flows_killed", host=host)

    def _process_regrows(self) -> None:
        now = time.monotonic()
        for peer, due in list(self._regrow_at.items()):
            if now < due:
                continue
            got = self.client.poll_cluster()
            if got is None:
                return  # an outage: retry on a later tick
            cluster, version = got
            if cluster.workers.rank(peer) is not None:
                del self._regrow_at[peer]  # someone already re-added it
                continue
            regrown = Cluster(runners=cluster.runners,
                              workers=PeerList(tuple(cluster.workers) + (peer,)))
            try:
                regrown.validate()
            except ValueError as e:  # its host left the runner set
                log.warning("cannot restart %s: %s", peer, e)
                del self._regrow_at[peer]
                continue
            if self.client.put_cluster(regrown, version=version):
                del self._regrow_at[peer]
                journal_event("worker_restart", peer=str(peer), size=regrown.size(),
                              cluster_version=version + 1)
                log.info("RESTART: re-grew %s into the cluster (%d workers at v%d)", peer,
                         regrown.size(), version + 1)
            # a CAS conflict leaves it scheduled: the next tick re-reads

    def run(self, initial: Optional[Cluster] = None, timeout_s: float = 0.0) -> int:
        """Supervise until every worker has exited (0), a worker fails (its
        exit code, unless keep or heal), the healer heals the job to no
        workers (the last failure's code), `timeout_s` passes (124) or the
        launcher is interrupted (130)."""
        t0 = time.monotonic()
        try:
            # the initial spawn inside the protected region: a SIGTERM during
            # start-up still stops the workers already running
            if initial is not None:
                self.reconcile(initial, 0)
            while True:
                got = self.client.poll_cluster()
                if got is not None and got[1] > self.version:
                    self.reconcile(*got)
                if self.heal and self._regrow_at:
                    self._process_regrows()
                self._remote_tick()
                # hang detection: kill at most the stalest wedged worker; its
                # exit joins the dead-process collection below
                stale = self._stalest_worker()
                if stale is not None:
                    age, speer, r = stale
                    log.error("worker %s heartbeat stale %.1fs > %.1fs; killing it", speer, age,
                              self.heartbeat_timeout_s)
                    journal_event("stall_kill", peer=str(speer), age_s=round(age, 1),
                                  timeout_s=self.heartbeat_timeout_s)
                    r.terminate(grace_s=0.5)
                    self._hb_amnesty_until = time.monotonic() + self.heartbeat_timeout_s
                for peer, r in list(self.current.items()):
                    rc = r.popen.poll() if r.popen else None
                    if rc is None:
                        continue
                    r.wait()  # joins the output pump: keep the tail lines
                    del self.current[peer]
                    if self.pool:
                        self.pool.put(self._chip_of.pop(peer, -1))
                    if rc != 0:
                        self._last_rc = rc
                        if self.heal:
                            self._heal_dead(peer, rc)
                            # the survivors now recover and rejoin: their
                            # heartbeats may pause, so everyone's staleness
                            # clock restarts
                            self._hb_amnesty_until = time.monotonic() + self.heartbeat_timeout_s
                        elif not self.keep:
                            log.error("worker %s failed (%d); stopping job", peer, rc)
                            self.shutdown()
                            return rc
                if self.heal and self._healed_to_zero and not self.current \
                        and not self._regrow_at:
                    # healed the whole job away, no restart pending: surface
                    # the last failure instead of idling forever
                    log.error("cluster healed to zero workers; job failed")
                    return self._last_rc or 1
                if not self.current and self.version >= 0:
                    if self._last_want > 0:
                        log.info("all workers exited")
                        return 0
                    # this host was shrunk to no workers: the job goes on
                    # elsewhere and a later version may regrow it; its end
                    # is the config server going away (the runner that
                    # embeds it stops it on exit)
                    if got is None:
                        if self._idle_since is None:
                            self._idle_since = time.monotonic()
                        elif time.monotonic() - self._idle_since >= self.IDLE_EXIT_S:
                            log.info("idle host: config server gone; exiting")
                            return 0
                    else:
                        self._idle_since = None
                if timeout_s and time.monotonic() - t0 > timeout_s:
                    log.error("watch timeout after %.0fs", timeout_s)
                    self.shutdown()
                    return 124
                time.sleep(self.poll_s)
        except KeyboardInterrupt:
            self.shutdown()
            return 130
        except Exception:
            self.shutdown()  # never leave workers orphaned
            raise

    def shutdown(self) -> None:
        for peer in list(self.current):
            self._kill(peer)
