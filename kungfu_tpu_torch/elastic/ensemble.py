"""The config-server ensemble's supervisor: spawn, watch and respawn N
replicas (counterpart of kungfu_tpu.elastic.ensemble).

The replication protocol lives in config_server.py; this module is the
process side of the replicated control plane:

  - it takes one port a replica and spawns each as
    `python -m kungfu_tpu_torch.elastic.config_server -replica-id I -peers
    ...`, every replica knowing the whole list from its start;
  - it supervises them: a dead replica is respawned with the same id and
    port (journal `replica_respawned`) and catches up from the leader's
    snapshot, as the launcher heals its workers;
  - `kill_replica`, `kill_leader`, `pause_replica` (SIGSTOP) and
    `resume_replica` are the drills' faults, `raft_status`, `statuses` and
    `leader` their observation.

Embedders (the launcher's `-config-replicas`, the drills) hand `urls_spec`
on, the comma form every ConfigClient takes through KFT_CONFIG_URLS, or
take `client()`, a failover client.  The JAX ensemble also sets the
monitor's gauges config_leader_epoch, config_replicas_up and
config_replication_lag; they wait for monitor/counters (ROADMAP A.8).
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import List, Optional

from ..plan import Cluster
from ..utils import get_logger

log = get_logger("kungfu.ensemble")

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_ports(n: int, host: str = "127.0.0.1") -> List[int]:
    """n distinct free TCP ports (bound, then closed: the small race with
    other processes is acceptable for test and drill ensembles)."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind((host, 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


class ConfigEnsemble:
    """N config-server replicas in processes of their own, respawned when
    they die."""

    def __init__(self, replicas: int = 3, host: str = "127.0.0.1",
                 init: Optional[Cluster] = None, ports: Optional[List[int]] = None,
                 respawn: bool = True, env: Optional[dict] = None):
        if replicas < 1:
            raise ValueError(f"need at least 1 replica, got {replicas}")
        self.host = host
        self.n = replicas
        self.ports = list(ports) if ports else free_ports(replicas, host)
        if len(self.ports) != replicas:
            raise ValueError(f"{len(self.ports)} ports for {replicas} replicas")
        self.urls = [f"http://{host}:{p}/config" for p in self.ports]
        self.respawn = respawn
        self._env = dict(os.environ if env is None else env)
        path = self._env.get("PYTHONPATH")
        self._env["PYTHONPATH"] = REPO + (os.pathsep + path if path else "")
        self._procs: List[Optional[subprocess.Popen]] = [None] * replicas
        self._no_respawn = set()  # replicas down on purpose
        self._init_path = ""
        if init is not None:
            fd, self._init_path = tempfile.mkstemp(prefix="kft-ensemble-", suffix=".json")
            with os.fdopen(fd, "w") as f:
                json.dump(init.to_json(), f)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.respawns = 0

    @property
    def urls_spec(self) -> str:
        """The comma form of KFT_CONFIG_URLS and ConfigClient."""
        return ",".join(self.urls)

    def client(self, **kw):
        from .config_client import ConfigClient

        return ConfigClient(self.urls_spec, **kw)

    # -- lifecycle ------------------------------------------------------------------

    def _spawn(self, replica: int) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "kungfu_tpu_torch.elastic.config_server",
               "-host", self.host, "-port", str(self.ports[replica]),
               "-replica-id", str(replica), "-peers", self.urls_spec]
        if self._init_path:
            cmd += ["-init", self._init_path]
        return subprocess.Popen(cmd, env=self._env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL, start_new_session=True)

    def start(self, wait_s: float = 15.0) -> "ConfigEnsemble":
        with self._lock:
            for i in range(self.n):
                self._procs[i] = self._spawn(i)
        if self.leader(wait_s=wait_s) is None:
            self.stop()
            raise RuntimeError(f"no leader elected within {wait_s}s")
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        log.info("config ensemble up: %s", self.urls_spec)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            procs = list(self._procs)
        for p in procs:
            if p is not None and p.poll() is None:
                os.kill(p.pid, signal.SIGCONT)  # a paused replica must see its SIGTERM
                p.terminate()
        for p in procs:
            if p is not None:
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        if self._init_path:
            try:
                os.unlink(self._init_path)
            except OSError:
                pass
            self._init_path = ""

    # -- the drills' faults ---------------------------------------------------------

    def kill_replica(self, replica: int, respawn: Optional[bool] = None) -> None:
        """SIGKILL one replica, as a host loss; the supervisor respawns it
        unless respawn=False."""
        with self._lock:
            if respawn is False:
                self._no_respawn.add(replica)
            elif respawn is True:
                self._no_respawn.discard(replica)
            p = self._procs[replica]
        if p is not None and p.poll() is None:
            p.kill()
        log.info("killed config replica %d", replica)

    def kill_leader(self, respawn: Optional[bool] = None) -> Optional[int]:
        """SIGKILL the leader; its replica id, or None without a leader."""
        led = self.leader(wait_s=5.0)
        if led is None:
            return None
        self.kill_replica(led, respawn=respawn)
        return led

    def pause_replica(self, replica: int) -> None:
        """SIGSTOP: the process lives but goes silent, the partitioned
        coordinator (its lease runs out; resumed, it must step down, never
        serve from stale state)."""
        with self._lock:
            p = self._procs[replica]
        if p is not None and p.poll() is None:
            os.kill(p.pid, signal.SIGSTOP)

    def resume_replica(self, replica: int) -> None:
        with self._lock:
            p = self._procs[replica]
        if p is not None and p.poll() is None:
            os.kill(p.pid, signal.SIGCONT)

    # -- observation ----------------------------------------------------------------

    def raft_status(self, replica: int, timeout_s: float = 1.0) -> Optional[dict]:
        root = self.urls[replica].rsplit("/", 1)[0]
        try:
            with urllib.request.urlopen(f"{root}/raft/status", timeout=timeout_s) as r:
                return json.loads(r.read().decode())
        except (OSError, ValueError):
            return None

    def statuses(self) -> List[Optional[dict]]:
        return [self.raft_status(i) for i in range(self.n)]

    def leader(self, wait_s: float = 0.0) -> Optional[int]:
        """The replica id of the highest-epoch replica that claims the
        lead, or None; with wait_s, polled until one does."""
        deadline = time.monotonic() + wait_s
        while True:
            best, best_epoch = None, -1
            for i, st in enumerate(self.statuses()):
                if (st is not None and st.get("role") == "leader"
                        and int(st.get("epoch", 0)) > best_epoch):
                    best, best_epoch = i, int(st.get("epoch", 0))
            if best is not None or time.monotonic() >= deadline:
                return best
            time.sleep(0.05)

    # -- supervision ----------------------------------------------------------------

    def _watch(self) -> None:
        from ..monitor.journal import journal_event

        while not self._stop.wait(0.2):
            with self._lock:
                procs = list(self._procs)
                skip = set(self._no_respawn)
            for i, p in enumerate(procs):
                if (p is None or p.poll() is not None) and self.respawn and i not in skip:
                    with self._lock:
                        if self._stop.is_set():
                            return
                        self._procs[i] = self._spawn(i)
                    self.respawns += 1
                    journal_event("replica_respawned", replica=i)
                    log.info("respawned config replica %d", i)
