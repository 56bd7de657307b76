"""Peer / cluster topology data model (counterpart of kungfu_tpu.plan.peer).

What `env.Config` and the launcher need: a peer's identity, the ranked
peer list, the host list of `-H` and the cluster document.  Parsing,
formatting and the peer-list fill match the JAX package, so both read and
write the same KungFu env contract and produce the same digests.  The
elastic parts (resize, serving tiers, JSON round trips) wait for the
elastic slice.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Iterable, List, Optional

DEFAULT_RUNNER_PORT = 38080
DEFAULT_WORKER_PORT_BASE = 10000
DEFAULT_WORKER_PORT_LIMIT = 11000


@dataclass(frozen=True, order=True)
class PeerID:
    """Identity of one worker process: (host, port)."""

    host: str
    port: int

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"

    @classmethod
    def parse(cls, s: str) -> "PeerID":
        host, _, port = s.rpartition(":")
        if not host or not port:
            raise ValueError(f"invalid peer spec: {s!r}")
        return cls(host=host, port=int(port))

    def to_json(self) -> dict:
        return {"host": self.host, "port": self.port}


class PeerList(tuple):
    """Ordered, immutable list of PeerIDs. Rank == index."""

    def __new__(cls, peers: Iterable[PeerID] = ()):
        return super().__new__(cls, tuple(peers))

    def rank(self, p: PeerID) -> Optional[int]:
        try:
            return self.index(p)
        except ValueError:
            return None

    def local_rank(self, p: PeerID) -> Optional[int]:
        r = 0
        for q in self:
            if q == p:
                return r
            if q.host == p.host:
                r += 1
        return None

    def host_count(self) -> int:
        return len({p.host for p in self})

    def bytes(self) -> bytes:
        return ";".join(str(p) for p in self).encode()

    def digest(self) -> str:
        return hashlib.sha256(self.bytes()).hexdigest()[:16]

    def to_json(self) -> list:
        return [p.to_json() for p in self]

    def __repr__(self) -> str:
        return f"PeerList[{', '.join(str(p) for p in self)}]"


@dataclass(frozen=True)
class HostSpec:
    """One host entry of `-H`: "ip:slots[:pub_addr]"."""

    host: str
    slots: int
    pub_addr: str = ""

    def __post_init__(self):
        if self.slots < 0:
            raise ValueError(f"negative slots: {self.slots}")
        if not self.pub_addr:
            object.__setattr__(self, "pub_addr", self.host)

    @classmethod
    def parse(cls, s: str) -> "HostSpec":
        parts = s.split(":")
        if len(parts) == 1:
            return cls(host=parts[0], slots=1)
        if len(parts) == 2:
            return cls(host=parts[0], slots=int(parts[1]))
        if len(parts) == 3:
            return cls(host=parts[0], slots=int(parts[1]), pub_addr=parts[2])
        raise ValueError(f"invalid host spec: {s!r}")

    def __str__(self) -> str:
        if self.pub_addr != self.host:
            return f"{self.host}:{self.slots}:{self.pub_addr}"
        return f"{self.host}:{self.slots}"


class HostList(tuple):
    """Comma-separated host specs: "ip1:4,ip2:4"."""

    def __new__(cls, specs: Iterable[HostSpec] = ()):
        return super().__new__(cls, tuple(specs))

    @classmethod
    def parse(cls, s: str) -> "HostList":
        s = s.strip()
        if not s:
            return cls()
        return cls(HostSpec.parse(x) for x in s.split(",") if x)

    def cap(self) -> int:
        return sum(h.slots for h in self)

    def gen_peer_list(self, np: int, port_base: int = DEFAULT_WORKER_PORT_BASE,
                      port_limit: int = DEFAULT_WORKER_PORT_LIMIT) -> PeerList:
        """Host-major fill: host 0's slots first, then host 1's, ..."""
        if np > self.cap():
            raise ValueError(f"np={np} exceeds capacity {self.cap()}")
        peers: List[PeerID] = []
        for h in self:
            for i in range(h.slots):
                if len(peers) >= np:
                    return PeerList(peers)
                port = port_base + i
                if port >= port_limit:
                    raise ValueError("port range exhausted")
                peers.append(PeerID(h.host, port))
        return PeerList(peers)

    def gen_runner_list(self, port: int = DEFAULT_RUNNER_PORT) -> PeerList:
        return PeerList(PeerID(h.host, port) for h in self)

    def __str__(self) -> str:
        return ",".join(str(h) for h in self)


@dataclass
class Cluster:
    """The cluster document: runners (one per host) + ranked workers."""

    runners: PeerList
    workers: PeerList

    @classmethod
    def from_hostlist(cls, hl: HostList, np: int) -> "Cluster":
        c = cls(runners=hl.gen_runner_list(), workers=hl.gen_peer_list(np))
        c.validate()
        return c

    def validate(self) -> None:
        runner_hosts = {r.host for r in self.runners}
        for w in self.workers:
            if w.host not in runner_hosts:
                raise ValueError(f"worker {w} has no runner on its host")
        if len(set(self.workers)) != len(self.workers):
            raise ValueError("duplicate workers")
        if len(set(self.runners)) != len(self.runners):
            raise ValueError("duplicate runners")

    def size(self) -> int:
        return len(self.workers)

    def bytes(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True).encode()

    def digest(self) -> str:
        return hashlib.sha256(self.bytes()).hexdigest()[:16]

    def to_json(self) -> dict:
        return {"runners": self.runners.to_json(),
                "workers": self.workers.to_json()}
