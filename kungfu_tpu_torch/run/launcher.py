"""Process supervisor, static mode (counterpart of kungfu_tpu.run.launcher
`ProcRunner` and `simple_run`): start every local worker, prefix its
output with its rank, wait for all, and on the first failure stop the
rest (unless keep) and return that worker's exit code.  Watch, heal and
elastic mode wait for the elastic slice (ROADMAP A4).
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional

from ..plan import Cluster
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
