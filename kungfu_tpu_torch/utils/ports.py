"""Binding a fixed port on a host whose ephemeral range covers it.

Some of the port's listeners take a port fixed by a rule every peer
computes: a blob store at worker port + 15000, the rendezvous at root port
+ 20000 + version, a respawned config replica at its old port.  Where the
host's ephemeral range starts low (one H100 machine's sockets took ports
as low as 4184), an outbound connection can hold such a port, and so can
the TIME_WAIT it leaves behind for 60 s when its side closes first (a
third of the config client's calls do).  Both block a bind, SO_REUSEADDR
or not.  They go away by themselves, so a bind that meets one waits for
it (KFT_PORT_WAIT_S, 75 s by default); a listener does not, so a bind
that meets one fails at once.  Either error names the holders, read from
/proc/net/tcp.
"""
import errno
import os
import socket
import time
from typing import Callable, List, Optional, TypeVar

from .log import get_logger

log = get_logger("kungfu.ports")

PORT_WAIT_ENV = "KFT_PORT_WAIT_S"
DEFAULT_PORT_WAIT_S = 75.0  # past TIME_WAIT's 60 s

_TCP_STATES = {"01": "ESTABLISHED", "02": "SYN_SENT", "03": "SYN_RECV", "04": "FIN_WAIT1",
               "05": "FIN_WAIT2", "06": "TIME_WAIT", "07": "CLOSE", "08": "CLOSE_WAIT",
               "09": "LAST_ACK", "0A": "LISTEN", "0B": "CLOSING"}

T = TypeVar("T")


def _ipv4(hex_addr: str) -> str:
    return socket.inet_ntoa(bytes.fromhex(hex_addr)[::-1])


def port_holders(port: int, host: str = "") -> List[dict]:
    """The TCP sockets on this host whose local port is `port` and whose
    address clashes with a bind to `host` ("" or 0.0.0.0: any address):
    {"state", "local", "remote"} each.  Empty where /proc/net/tcp cannot
    be read."""
    out = []
    for path, v4 in (("/proc/net/tcp", True), ("/proc/net/tcp6", False)):
        try:
            with open(path) as f:
                lines = f.readlines()[1:]
        except OSError:
            continue
        for line in lines:
            fields = line.split()
            (lip, lport), (rip, rport) = (a.split(":") for a in fields[1:3])
            if int(lport, 16) != port:
                continue
            if v4:
                lip, rip = _ipv4(lip), _ipv4(rip)
                if host not in ("", "0.0.0.0") and lip not in (host, "0.0.0.0"):
                    continue
            out.append({"state": _TCP_STATES.get(fields[3], fields[3]),
                        "local": f"{lip}:{int(lport, 16)}", "remote": f"{rip}:{int(rport, 16)}"})
    return out


def bind_when_free(bind: Callable[[], T], port: int, host: str = "", what: str = "a listener",
                   wait_s: Optional[float] = None) -> T:
    """bind() (which binds `host`:`port` and returns its server), again
    while it fails with EADDRINUSE and no listener holds the port, for up
    to `wait_s` seconds (KFT_PORT_WAIT_S, else 75)."""
    if wait_s is None:
        wait_s = float(os.environ.get(PORT_WAIT_ENV) or DEFAULT_PORT_WAIT_S)
    t0, warned = time.monotonic(), False
    while True:
        try:
            return bind()
        except OSError as e:
            if e.errno != errno.EADDRINUSE:
                raise
            holders = port_holders(port, host)
            listening = any(h["state"] == "LISTEN" for h in holders)
            waited = time.monotonic() - t0
            if listening or waited >= wait_s:
                raise OSError(errno.EADDRINUSE,
                              f"{what} cannot bind {host or '*'}:{port} "
                              f"({'a listener holds it' if listening else f'held after {waited:.1f} s'}"
                              f"; its sockets: {holders})") from e
            if not warned:
                log.warning("%s: port %d held by %s; waiting up to %.0f s for it", what, port,
                            holders, wait_s)
                warned = True
            time.sleep(0.25)


def wait_until_bindable(port: int, host: str = "", what: str = "a listener",
                        wait_s: Optional[float] = None) -> None:
    """Return once a SO_REUSEADDR socket could bind `host`:`port`, for a
    listener made by code that does not retry (torch's TCP store)."""

    def probe() -> None:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, port))

    bind_when_free(probe, port, host, what, wait_s)
