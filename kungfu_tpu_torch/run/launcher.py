"""Process supervisor (counterpart of kungfu_tpu.run.launcher).

Static mode (`simple_run`): start every local worker, prefix its output
with its rank, wait for all, and on the first failure stop the rest
(unless keep) and return that worker's exit code.

Watch mode (`WatchRunner`, reference runner/watch.go:42-135): poll the
elastic config service and, as its document's version advances, stop
the local workers it removed and start the ones it added (the reference
pushes Stage updates over its TCP control channel; polling the config
server is the JAX package's HTTP-only redesign: workers PUT, runners
GET).  The self-healing supervisor of the JAX package (heal, restart
budgets, heartbeat and remote-host judgment) raises until it is ported
(ROADMAP A.5b).
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..plan import Cluster, PeerID
from ..utils import get_logger
from .job import ChipPool, Job, Proc

log = get_logger("kungfu.run")

_COLORS = [36, 32, 33, 35, 34, 31]  # cyan green yellow magenta blue red


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
    service's cluster document as its version advances."""

    IDLE_EXIT_S = 60.0  # a host shrunk to no workers waits this long for a gone server
    # a removed worker leaves its group (a collective teardown: a card sync
    # and the ring workspaces' barriers) and exits by itself; SIGTERM only
    # asks, and the kill waits this long for it
    KILL_GRACE_S = 30.0

    def __init__(self, job: Job, self_host: str, client, logdir: str = "", quiet: bool = False,
                 keep: bool = False, poll_s: float = 0.5, heal: bool = False,
                 restart_budget: int = 0, heartbeat_timeout_s: float = 0.0):
        if heal or restart_budget or heartbeat_timeout_s:
            raise NotImplementedError("WatchRunner's healer (heal, restart_budget, "
                                      "heartbeat_timeout_s) is not ported yet (ROADMAP A.5b)")
        self.job = job
        self.self_host = self_host
        self.client = client
        self.logdir = logdir
        self.quiet = quiet
        self.keep = keep
        self.poll_s = poll_s
        self.current: Dict[PeerID, ProcRunner] = {}
        self.pool: Optional[ChipPool] = ChipPool(job.cards_per_host) if job.cards_per_host else None
        self.version = -1
        self._chip_of: Dict[PeerID, int] = {}
        self._last_want = -1  # local workers wanted at the last reconcile
        self._idle_since: Optional[float] = None

    def _spawn(self, peer: PeerID, cluster: Cluster, version: int) -> None:
        chip = self.pool.get() if self.pool else -1
        chip = chip if chip is not None else -1
        r = ProcRunner(self.job.new_proc(peer, chip, cluster, version), logdir=self.logdir,
                       quiet=self.quiet)
        r.start()
        self.current[peer] = r
        self._chip_of[peer] = chip
        log.info("[v%d] + worker %s", version, peer)

    def _kill(self, peer: PeerID) -> None:
        r = self.current.pop(peer, None)
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
        self.version = version
        self._last_want = len(want)

    def run(self, initial: Optional[Cluster] = None, timeout_s: float = 0.0) -> int:
        """Supervise until every worker has exited (0), a worker fails (its
        exit code, unless keep), `timeout_s` passes (124) or the launcher
        is interrupted (130)."""
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
                for peer, r in list(self.current.items()):
                    rc = r.popen.poll() if r.popen else None
                    if rc is None:
                        continue
                    r.wait()  # joins the output pump: keep the tail lines
                    del self.current[peer]
                    if self.pool:
                        self.pool.put(self._chip_of.pop(peer, -1))
                    if rc != 0 and not self.keep:
                        log.error("worker %s failed (%d); stopping job", peer, rc)
                        self.shutdown()
                        return rc
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
