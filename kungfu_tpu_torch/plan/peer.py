"""Peer / cluster topology data model (counterpart of kungfu_tpu.plan.peer).

Only what `env.Config` needs: a peer's identity, the ranked peer list and
the cluster document.  Parsing and formatting match the JAX package, so
both read the same KungFu env contract and produce the same digests.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Iterable, Optional


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


@dataclass
class Cluster:
    """The cluster document: runners (one per host) + ranked workers."""

    runners: PeerList
    workers: PeerList

    def bytes(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True).encode()

    def digest(self) -> str:
        return hashlib.sha256(self.bytes()).hexdigest()[:16]

    def to_json(self) -> dict:
        return {"runners": self.runners.to_json(),
                "workers": self.workers.to_json()}
