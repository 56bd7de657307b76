"""Run a worker script on n gloo ranks of the port, brought up from the
KungFu env contract (KFT_SELF_SPEC, KFT_INIT_PEERS), for the CPU tests."""
from __future__ import annotations

import os
import random
import socket
import subprocess
import sys
from typing import Dict, Optional, Sequence

from kungfu_tpu_torch.peer import COORDINATOR_PORT_OFFSET, COORDINATOR_PORT_WINDOW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the highest worker port whose version-fenced rendezvous window
# (peer.coordinator_port) stays within 65535
MAX_WORKER_PORT = 65535 - COORDINATOR_PORT_OFFSET - COORDINATOR_PORT_WINDOW + 1


def _binds(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def _free_port_range(n: int, max_port: int, offsets: Sequence[int]) -> int:
    """A first worker port p <= max_port - n + 1 whose n ports p..p+n-1,
    and each of those plus every offset, bind now: below the ephemeral
    range (32768+) where the kernel does not hand them out by itself.
    Every worker port is at most MAX_WORKER_PORT, and its rendezvous
    port at cluster version 0 (+ COORDINATOR_PORT_OFFSET) binds too."""
    max_port = min(max_port, MAX_WORKER_PORT)
    offsets = (*offsets, COORDINATOR_PORT_OFFSET)
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(12000, min(max_port, 32000) - n)
        if all(_binds(port + r + off) for r in range(n) for off in (0, *offsets)):
            return port
    raise RuntimeError(f"no {n} free worker ports at or below {max_port}")


def start_ranks(worker: str, n: int, args: Sequence[str],
                max_port: Optional[int] = None, offsets: Sequence[int] = (),
                hosts: Optional[Sequence[str]] = None,
                env: Optional[Dict[str, str]] = None) -> list:
    """Start `worker` (Python source) on n ranks; each gets `args`.  The
    worker ports are at most `max_port` (default MAX_WORKER_PORT, where
    the version-fenced rendezvous port fits) and free, as is each of them
    plus every one of `offsets` (the blob store takes worker port +
    store.STORE_PORT_OFFSET, at most 65535) and plus the rendezvous
    offset.  `hosts` names each rank's
    host (loopback aliases such as 127.0.0.2 stand for other hosts; the
    default is 127.0.0.1 for all); `env` is added to each rank's."""
    port = _free_port_range(n, MAX_WORKER_PORT if max_port is None else max_port, offsets)
    hosts = list(hosts) if hosts is not None else ["127.0.0.1"] * n
    specs = [f"{hosts[r]}:{port + r}" for r in range(n)]
    peers = ",".join(specs)
    procs = []
    for r in range(n):
        env_r = dict(os.environ, KFT_SELF_SPEC=specs[r], KFT_INIT_PEERS=peers,
                     PYTHONPATH=REPO, OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen([sys.executable, "-c", worker, *map(str, args)],
                                      env=env_r, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def wait_ranks(procs, timeout: float = 120) -> Dict[int, str]:
    """Wait for every rank; fails with a rank's output if it failed."""
    outs = {}
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=timeout)
        assert p.returncode == 0, out
        outs[r] = out
    return outs
