"""Peer / cluster topology data model (counterpart of kungfu_tpu.plan.peer).

What `env.Config` and the launcher need: a peer's identity, the ranked
peer list, the host list of `-H` and the cluster document.  Parsing,
formatting and the peer-list fill match the JAX package, so both read and
write the same KungFu env contract and produce the same digests.  The
cluster document's resize, JSON round trips and the peer-list set
algebra are what the elastic config server, the watch launcher and the
resize protocol use (`elastic/`, `run/launcher.py`).  A document's serving
`tiers` map is kept through `from_json` and `to_json`, so its bytes and
digest match the JAX package's; the tier methods wait for the serving
slice (ROADMAP A.2).  `PeerList.ring_buddies` assigns the buddy that
holds each rank's in-memory snapshot (resilience/buddy.py).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

DEFAULT_RUNNER_PORT = 38080
DEFAULT_WORKER_PORT_BASE = 10000
DEFAULT_WORKER_PORT_LIMIT = 11000
SERVING_TIERS = ("prefill", "decode")


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

    @classmethod
    def from_json(cls, d: dict) -> "PeerID":
        return cls(host=d["host"], port=int(d["port"]))


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

    def local_size(self, p: PeerID) -> int:
        return sum(1 for q in self if q.host == p.host)

    def host_count(self) -> int:
        return len({p.host for p in self})

    def hosts(self) -> List[str]:
        """Distinct hosts in first-appearance order."""
        return list(dict.fromkeys(p.host for p in self))

    def ring_buddies(self) -> List[int]:
        """Ring-offset buddy assignment: buddies[r] is the rank holding rank
        r's in-memory snapshot (resilience/buddy.py).

        For each rank the buddy is ``(r + k) % n`` for the smallest k >= 1
        whose peer lives on a *different host*, falling back to the plain
        k=1 ring when the cluster is single-host (where host disjointness
        is unsatisfiable).  Never self (n > 1), host-disjoint whenever more
        than one host exists (asserted: a whole-host loss must never take a
        snapshot and its only copy together), and a function of the
        document alone, so every peer computes the same assignment without
        coordination.  Recomputed on every resize and heal (ranks shift).
        A single peer has nobody to buddy with: buddies == [-1].
        """
        n = len(self)
        if n <= 1:
            return [-1] * n
        multi_host = self.host_count() > 1
        out: List[int] = []
        for r, p in enumerate(self):
            k = next(k for k in range(1, n) if self[(r + k) % n].host != p.host) \
                if multi_host else 1
            out.append((r + k) % n)
        if multi_host:
            assert all(self[b].host != p.host for p, b in zip(self, out)), (
                f"ring_buddies produced a same-host pair on a multi-host document: "
                f"{self!r} -> {out}")
        return out

    def partition_by_host(self) -> Dict[str, "PeerList"]:
        out: Dict[str, List[PeerID]] = {}
        for p in self:
            out.setdefault(p.host, []).append(p)
        return {h: PeerList(v) for h, v in out.items()}

    def diff(self, other: "PeerList") -> "PeerList":
        """Peers in self but not in other (order preserved)."""
        o = set(other)
        return PeerList(p for p in self if p not in o)

    def intersection(self, other: "PeerList") -> "PeerList":
        o = set(other)
        return PeerList(p for p in self if p in o)

    def disjoint(self, other: "PeerList") -> bool:
        return not set(self) & set(other)

    def eq(self, other: "PeerList") -> bool:
        return tuple(self) == tuple(other)

    def bytes(self) -> bytes:
        return ";".join(str(p) for p in self).encode()

    def digest(self) -> str:
        return hashlib.sha256(self.bytes()).hexdigest()[:16]

    def to_json(self) -> list:
        return [p.to_json() for p in self]

    @classmethod
    def from_json(cls, xs: list) -> "PeerList":
        return cls(PeerID.from_json(x) for x in xs)

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
    """The cluster document: runners (one per host) + ranked workers, and
    an optional serving `tiers` map (worker "host:port" -> tier) that is
    serialized only when present."""

    runners: PeerList
    workers: PeerList
    tiers: Optional[Dict[str, str]] = None

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
        if self.tiers is not None:
            workers = {str(w) for w in self.workers}
            for spec, tier in self.tiers.items():
                if spec not in workers:
                    raise ValueError(f"tier entry {spec!r} is not a worker")
                if tier not in SERVING_TIERS:
                    raise ValueError(f"unknown tier {tier!r} for {spec!r}")

    def size(self) -> int:
        return len(self.workers)

    def resize(self, new_size: int) -> "Cluster":
        """Shrink from the tail, or grow one worker at a time on the
        least-loaded host (reference Cluster.Resize + growOne,
        srcs/go/plan/cluster.go:88-118).  A tiered document keeps the tiers
        of the workers it keeps, and a grown worker joins "decode"."""
        if new_size < 0:
            raise ValueError("negative size")
        workers = list(self.workers)
        grown: List[PeerID] = []
        if new_size <= len(workers):
            workers = workers[:new_size]
        else:
            while len(workers) < new_size:
                p = self._grow_one(PeerList(workers))
                workers.append(p)
                grown.append(p)
        tiers = None
        if self.tiers is not None:
            alive = {str(w) for w in workers}
            tiers = {s: t for s, t in self.tiers.items() if s in alive}
            for p in grown:
                tiers.setdefault(str(p), "decode")
        c = Cluster(runners=self.runners, workers=PeerList(workers), tiers=tiers)
        c.validate()
        return c

    def _grow_one(self, workers: PeerList) -> PeerID:
        # the least-loaded runner host gets the next worker, at its lowest
        # free port from the default base (cluster.go:107-118)
        load = {r.host: 0 for r in self.runners}
        used_ports: Dict[str, set] = {r.host: set() for r in self.runners}
        for w in workers:
            if w.host in load:
                load[w.host] += 1
                used_ports[w.host].add(w.port)
        order = list(load)
        host = min(load, key=lambda h: (load[h], order.index(h)))
        port = DEFAULT_WORKER_PORT_BASE
        while port in used_ports[host]:
            port += 1
        return PeerID(host, port)

    def bytes(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True).encode()

    def digest(self) -> str:
        return hashlib.sha256(self.bytes()).hexdigest()[:16]

    def to_json(self) -> dict:
        out = {"runners": self.runners.to_json(), "workers": self.workers.to_json()}
        if self.tiers is not None:
            out["tiers"] = dict(self.tiers)
        return out

    @classmethod
    def from_json(cls, d: dict) -> "Cluster":
        tiers = d.get("tiers")
        return cls(runners=PeerList.from_json(d["runners"]),
                   workers=PeerList.from_json(d["workers"]),
                   tiers=dict(tiers) if tiers is not None else None)
