"""The launcher CLI: `python -m kungfu_tpu_torch.run -np 4 python train.py`.

Static mode of the JAX package's CLI (kungfu_tpu/run/__main__.py), with
its flags: -np, -H, -self, -strategy, -k, -logdir, -q and -chips-per-host.
Each worker gets the KungFu env contract (`env.worker_env`) and picks its
own card (`distributed.placement`); -chips-per-host N instead gives each
worker one card slot of N through CUDA_VISIBLE_DEVICES, as the JAX CLI
does with TPU_VISIBLE_CHIPS.  Every other flag of the JAX CLI raises,
naming the ROADMAP item that will port it; none is ignored.
"""
from __future__ import annotations

import argparse
import socket
import sys
from typing import Dict, Optional, Sequence

from ..plan import Cluster, HostList, Strategy
from .job import Job
from .launcher import install_signal_trap, simple_run

# flag -> (argparse options, what it does in the JAX CLI)
UNPORTED: Dict[str, tuple] = {
    "-w": ({"action": "store_true"}, "watch (elastic) mode"),
    "-heal": ({"action": "store_true"}, "self-healing watch mode"),
    "-restart-budget": ({"type": int}, "restarts after a heal"),
    "-heartbeat-timeout": ({"type": float}, "the healer's worker heartbeat"),
    "-suspicion-timeout": ({"type": float}, "the healer's host suspicion window"),
    "-timeout": ({"type": float}, "the watch-mode timeout"),
    "-telemetry": ({"action": "store_true"}, "fleet telemetry"),
    "-telemetry-port": ({"type": int}, "the fleet telemetry port"),
    "-slo-file": ({}, "the fleet SLO rules"),
    "-slo-exit-code": ({"action": "store_true"}, "the SLO exit code"),
    "-config-server": ({}, "the elastic config server"),
    "-builtin-config-server": ({"action": "store_true"}, "an embedded config server"),
    "-port": ({"type": int}, "the embedded config server's port"),
    "-config-replicas": ({"type": int}, "a replicated config ensemble"),
    "-platform": ({}, "the workers' JAX platform (here each worker picks its device)"),
    "-devices-per-worker": ({"type": int}, "virtual CPU devices per worker"),
}


def infer_self_ip(hostlist: HostList) -> str:
    """Our address in the host list."""
    candidates = {h.host for h in hostlist}
    if "127.0.0.1" in candidates or "localhost" in candidates:
        return "127.0.0.1" if "127.0.0.1" in candidates else "localhost"
    names = {socket.gethostname(), socket.getfqdn()}
    try:
        names.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    for c in candidates:
        if c in names:
            return c
    return sorted(candidates)[0]


def _split(argv: Sequence[str], ap: argparse.ArgumentParser):
    """(launcher flags, worker command): the command starts at the first
    argument that is neither a launcher flag nor its value, or after "--".
    argparse never sees the command, so its flags (python -c ...) are never
    taken for the launcher's (-chips-per-host, ...)."""
    takes_value = {opt: a.nargs != 0 for a in ap._actions for opt in a.option_strings}
    i = 0
    while i < len(argv) and argv[i] in takes_value:
        i += 2 if takes_value[argv[i]] else 1
    if argv[i:i + 1] == ["--"]:
        return list(argv[:i]), list(argv[i + 1:])
    return list(argv[:i]), list(argv[i:])


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "-serve":
        raise NotImplementedError("-serve (the serving fleet) is not ported yet (ROADMAP A2)")
    ap = argparse.ArgumentParser("kungfu_tpu_torch.run",
                                 usage="%(prog)s [flags] [--] worker command ...",
                                 description="launch distributed kungfu_tpu_torch workers")
    ap.add_argument("-np", type=int, default=1, help="total number of workers")
    ap.add_argument("-H", dest="hosts", default="", help="host list ip:slots[:pub],...")
    ap.add_argument("-self", dest="self_host", default="", help="this host's address")
    ap.add_argument("-strategy", default="AUTO", help="allreduce strategy")
    ap.add_argument("-k", dest="keep", action="store_true", help="keep job on worker failure")
    ap.add_argument("-logdir", default="")
    ap.add_argument("-q", dest="quiet", action="store_true")
    ap.add_argument("-chips-per-host", dest="cards_per_host", type=int, default=0,
                    help="give each worker one of this many card slots (CUDA_VISIBLE_DEVICES)")
    for flag, (opts, _) in UNPORTED.items():
        ap.add_argument(flag, dest="unported_" + flag[1:].replace("-", "_"), default=None,
                        help=argparse.SUPPRESS, **opts)
    flags, prog = _split(argv, ap)
    args = ap.parse_args(flags)
    for flag, (_, what) in UNPORTED.items():
        if getattr(args, "unported_" + flag[1:].replace("-", "_")) not in (None, False):
            raise NotImplementedError(f"{flag} ({what}) is not ported yet (ROADMAP A4)")

    if not prog:
        ap.error("missing worker command")
    hosts = HostList.parse(args.hosts) if args.hosts else HostList.parse(f"127.0.0.1:{args.np}")
    cluster = Cluster.from_hostlist(hosts, args.np)
    job = Job(prog=prog[0], args=prog[1:], strategy=Strategy.parse(args.strategy),
              cards_per_host=args.cards_per_host)
    install_signal_trap()
    return simple_run(job, cluster, args.self_host or infer_self_ip(hosts),
                      logdir=args.logdir, quiet=args.quiet, keep=args.keep)


if __name__ == "__main__":
    sys.exit(main())
