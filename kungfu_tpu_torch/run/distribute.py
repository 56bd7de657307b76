"""Multi-host launch helpers: parallel ssh exec + remote static jobs
(counterpart of kungfu_tpu.run.distribute, host code kept as its own copy).

Reference: srcs/go/cmd/kungfu-distribute (parallel ssh of one command on a
host list, kungfu-distribute.go:79-99) and kungfu-rrun (remote static KungFu
job via ssh, rrun.go:19-43; utils/runner/remote RemoteRunAll).  Run as::

    python -m kungfu_tpu_torch.run.distribute -H 10.0.0.1:8,10.0.0.2:8 -- hostname
    python -m kungfu_tpu_torch.run.distribute -rrun -np 16 -H 10.0.0.1:8,10.0.0.2:8 \
        -- python train.py

In rrun mode each host receives one launcher invocation with `-self <host>`,
so the per-host launchers spawn only their local workers against the shared
host list — the same decomposition the reference's remote runner uses.
"""
from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..plan import HostList
from ..utils import get_logger

log = get_logger("kungfu.distribute")

SSH = ("ssh", "-o", "BatchMode=yes", "-o", "StrictHostKeyChecking=no")


@dataclass
class HostResult:
    host: str
    returncode: int
    output: str = ""


@dataclass
class Distributor:
    """Parallel per-host command execution over ssh (or any injected
    transport — tests pass ``transport=("bash", "-c")`` style vectors)."""

    hosts: List[str]
    transport: Sequence[str] = SSH
    prefix_output: bool = True
    extra_env: Dict[str, str] = field(default_factory=dict)

    def _command_for(self, host: str, command: str) -> List[str]:
        # `export k=v;` prefixes (not bare assignments) so the command's own
        # expansions can see them, locally and on the remote shell alike
        env = "".join(
            f"export {k}={shlex.quote(v)}; "
            for k, v in sorted(self.extra_env.items())
        )
        if list(self.transport)[:1] == ["ssh"] or self.transport is SSH:
            return list(self.transport) + [host, env + command]
        # non-ssh transport (tests/local): host goes in env for inspection
        return list(self.transport) + [
            f"export KFT_DIST_HOST={shlex.quote(host)}; {env}{command}"
        ]

    def run(self, command: str, timeout: Optional[float] = None) -> List[HostResult]:
        results: List[HostResult] = [HostResult(h, -1) for h in self.hosts]

        def work(i: int, host: str) -> None:
            try:
                p = subprocess.run(
                    self._command_for(host, command),
                    capture_output=True, text=True, timeout=timeout,
                )
                results[i] = HostResult(host, p.returncode, p.stdout + p.stderr)
            except subprocess.TimeoutExpired as e:
                out = (e.stdout or b"").decode(errors="replace") if isinstance(
                    e.stdout, bytes) else (e.stdout or "")
                results[i] = HostResult(host, 124, out)
            if self.prefix_output:
                for line in results[i].output.splitlines():
                    print(f"[{host}] {line}", flush=True)

        threads = [
            threading.Thread(target=work, args=(i, h), daemon=True)
            for i, h in enumerate(self.hosts)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results


def rrun(hostlist: HostList, np: int, prog: Sequence[str],
         transport: Sequence[str] = SSH, strategy: str = "AUTO",
         python: str = "python3", timeout: Optional[float] = None,
         extra_env: Optional[Dict[str, str]] = None) -> List[HostResult]:
    """Static multi-host job: one launcher per host over ssh (kungfu-rrun),
    `python -m kungfu_tpu_torch.run` with -self that host."""
    hosts_str = ",".join(
        f"{h.host}:{h.slots}" + (f":{h.pub_addr}" if h.pub_addr != h.host else "")
        for h in hostlist
    )
    dist = Distributor(
        hosts=[h.host for h in hostlist],
        transport=transport,
        extra_env=dict(extra_env or {}),
    )
    def cmd_for(host: str) -> str:
        return (
            f"{python} -m kungfu_tpu_torch.run -np {np} -H {shlex.quote(hosts_str)} "
            f"-strategy {strategy} -self {host} -- "
            + " ".join(shlex.quote(a) for a in prog)
        )

    # all hosts CONCURRENTLY: each per-host launcher blocks until the whole
    # job finishes, and its workers rendezvous with the other hosts' workers
    # — sequential launches would deadlock the first host's barrier
    results: List[HostResult] = [HostResult(h, -1) for h in dist.hosts]

    def work(i: int, host: str) -> None:
        one = Distributor([host], transport=transport, extra_env=dist.extra_env,
                          prefix_output=dist.prefix_output)
        results[i] = one.run(cmd_for(host), timeout=timeout)[0]

    threads = [
        threading.Thread(target=work, args=(i, h), daemon=True)
        for i, h in enumerate(dist.hosts)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kungfu_tpu_torch.run.distribute")
    ap.add_argument("-H", dest="hosts", required=True,
                    help="host list ip:slots[:pub],...")
    ap.add_argument("-rrun", action="store_true",
                    help="launch a static kungfu_tpu_torch job instead of a raw command")
    ap.add_argument("-np", type=int, default=0, help="rrun: total workers")
    ap.add_argument("-strategy", default="AUTO")
    ap.add_argument("-python", default="python3", help="rrun: remote interpreter")
    ap.add_argument("-timeout", type=float, default=0.0)
    ap.add_argument("prog", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    prog = args.prog[1:] if args.prog[:1] == ["--"] else args.prog
    if not prog:
        ap.error("no command given after --")
    hl = HostList.parse(args.hosts)
    timeout = args.timeout or None

    if args.rrun:
        np = args.np or hl.cap()
        results = rrun(hl, np, prog, strategy=args.strategy,
                       python=args.python, timeout=timeout)
    else:
        dist = Distributor([h.host for h in hl])
        results = dist.run(" ".join(shlex.quote(a) for a in prog), timeout=timeout)

    failed = [r for r in results if r.returncode != 0]
    for r in failed:
        log.error("host %s exited %d", r.host, r.returncode)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
