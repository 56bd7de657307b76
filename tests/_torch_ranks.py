"""Run a worker script on n gloo ranks of the port, brought up from the
KungFu env contract (KFT_SELF_SPEC, KFT_INIT_PEERS), for the CPU tests."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Dict, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(worker: str, n: int, args: Sequence[str]) -> list:
    """Start `worker` (Python source) on n ranks; each gets `args`."""
    port = _free_port()
    peers = ",".join(f"127.0.0.1:{port + r}" for r in range(n))
    procs = []
    for r in range(n):
        env = dict(os.environ, KFT_SELF_SPEC=f"127.0.0.1:{port + r}", KFT_INIT_PEERS=peers,
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", worker, *map(str, args)],
                                      env=env, stdout=subprocess.PIPE,
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
