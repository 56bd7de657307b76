"""Elastic config service: an HTTP store of one versioned Cluster document
(counterpart of kungfu_tpu.elastic.config_server).

Reference: srcs/go/kungfu/elastic/configserver/configserver.go:42-110 and
the standalone binary (cmd/kungfu-config-server/kungfu-config-server.go):
GET returns the current cluster (404 while cleared), PUT validates and
bumps the version (rejected while cleared), POST installs or resets,
DELETE clears, /stop shuts the server down.  Embedded in the launcher
(`-w`, `-builtin-config-server`) or standalone:

    python -m kungfu_tpu_torch.elastic.config_server -port 9100 [-init cluster.json]

The wire is the JAX package's, byte for byte in its bodies, so a client of
either package talks to a server of either, and replicas of either form
one ensemble:

  - GET of any path ending in /health answers {ok, version, size, cleared,
    role, replica, leader_epoch, ...} without the document;
  - a PUT body carrying "version": N is conditional: 409 unless N is the
    stored version ("version": null keeps the reference's unconditional
    PUT); a conditional PUT with "reconvene": true bumps the version even
    when the document's bytes are unchanged;
  - a KV plane under <url>/kv/<key>: PUT stores a JSON value stamped with
    the leader's receive time (t_server), GET returns one entry, GET
    <url>/kv?prefix=P lists matching entries and the server's `now`,
    DELETE removes one;
  - every answer carries the leader_epoch stamp, and GET /raft/status
    this replica's status.

A `flap@config_server=D[:after=N]` fault in KFT_FAULT_PLAN (chaos/) makes
the server answer 503 to document requests for the scripted window, as the
JAX server does (`ServerChaos.should_503` on every request; /health and the
KV plane are the liveness plane and answer inside the window).

The replicated control plane (`-replica-id I -peers url0,url1,...`; the
JAX package's docs/fault_tolerance.md "Replicated control plane"): N of
these processes form a leader-leased, log-replicated ensemble.

  - One epoch-numbered leader holds a lease renewed by majority heartbeats
    over /raft/append.  Every mutation (conditional PUT, reconvene, POST,
    DELETE, KV PUT and DELETE) is appended to the replicated log and
    acknowledged by a majority before the leader applies it and answers,
    so a majority can lose the rest without losing a committed write.
  - Elections run over /raft/vote: replica i campaigns after the election
    timeout plus 0.25 s x i, so the lowest live replica wins; a vote goes
    only to a candidate whose log is at least as new.  A new leader
    appends its epoch's no-op and serves once that has committed.
  - Followers answer document and KV requests with 421 and a leader hint
    (the failover client follows it); /health and /raft/status answer on
    every replica.  A leader that cannot renew its lease from a majority
    answers 421 too, never a 409 made from stale state, and steps down
    after twice the election timeout.
  - The log is compacted once long; a respawned or lagging replica
    catches up from the leader's applied snapshot.

One replica runs the same code path with a majority of one, epoch
LEADER_EPOCH (1) and no network round.  Timing knobs: KFT_RAFT_HB_S (the
heartbeat, default 0.15 s) and KFT_RAFT_ELECT_S (the base election
timeout, default 0.6 s).
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ..plan import Cluster
from ..utils import get_logger
from ..utils.ports import bind_when_free

log = get_logger("kungfu.configserver")

LEADER_EPOCH = 1  # a single server is the leader of epoch 1 for its whole life


class _State:
    def __init__(self, init: Optional[Cluster] = None):
        self.lock = threading.Lock()
        self.cluster: Optional[Cluster] = init
        self.version = 0
        self.cleared = False
        self.kv: dict = {}  # key -> {"value": ..., "t_server": float}

    def get(self) -> Optional[Tuple[Cluster, int]]:
        with self.lock:
            if self.cluster is None:
                return None
            return self.cluster, self.version

    def put(self, c: Cluster, expect_version: Optional[int] = None,
            reconvene: bool = False) -> Tuple[bool, str]:
        try:
            c.validate()
        except ValueError as e:
            return False, f"invalid cluster: {e}"
        with self.lock:
            if self.cleared:
                return False, "config was cleared"  # until POST re-inits
            if expect_version is not None and expect_version != self.version:
                return False, f"version conflict: expected {expect_version}, at {self.version}"
            if self.cluster is not None and c.bytes() == self.cluster.bytes():
                if not (reconvene and expect_version is not None):
                    return True, "unchanged"
                self.version += 1  # reconvene: identical membership, the version moves
                log.info("config reconvened at version %d (membership unchanged, %d workers)",
                         self.version, c.size())
                return True, "reconvened"
            self.cluster = c
            self.version += 1
            log.info("config updated to version %d (%d workers)", self.version, c.size())
            return True, "ok"

    def post(self, c: Cluster) -> Tuple[bool, str]:
        try:
            c.validate()
        except ValueError as e:
            return False, f"invalid cluster: {e}"
        with self.lock:
            self.cluster = c
            self.cleared = False
            self.version += 1
            return True, "ok"

    def delete(self) -> None:
        with self.lock:
            self.cluster = None
            self.cleared = True

    def health(self) -> dict:
        with self.lock:
            return {"ok": True, "version": self.version,
                    "size": self.cluster.size() if self.cluster is not None else 0,
                    "cleared": self.cleared}

    # -- the KV liveness plane ------------------------------------------------------

    def kv_put(self, key: str, value, t_server: Optional[float] = None) -> None:
        """Store `value` under `key`; a replica applies the leader's stamp
        `t_server`, so every replica holds the same entry."""
        if t_server is None:
            t_server = round(time.time(), 6)
        with self.lock:
            self.kv[key] = {"value": value, "t_server": t_server}

    def kv_get(self, key: str) -> Optional[dict]:
        with self.lock:
            return self.kv.get(key)

    def kv_list(self, prefix: str) -> dict:
        with self.lock:
            return {"now": round(time.time(), 6),
                    "entries": {k: dict(v) for k, v in self.kv.items() if k.startswith(prefix)}}

    def kv_delete(self, key: str) -> None:
        with self.lock:
            self.kv.pop(key, None)

    # -- the replicated state machine ------------------------------------------------

    def apply(self, op: list) -> Tuple[bool, str]:
        """Apply one log entry.  Deterministic: the same log applied in
        order gives every replica the same state and the same results (the
        leader answers with its own)."""
        kind = op[0]
        if kind == "noop":
            return True, "noop"  # a new leader's commit-point probe
        if kind == "put":
            return self.put(Cluster.from_json(op[1]), None if op[2] is None else int(op[2]),
                            reconvene=bool(op[3]))
        if kind == "post":
            return self.post(Cluster.from_json(op[1]))
        if kind == "delete":
            self.delete()
            return True, "ok"
        if kind == "kv_put":
            self.kv_put(op[1], op[2], t_server=op[3])
            return True, "ok"
        if kind == "kv_delete":
            self.kv_delete(op[1])
            return True, "ok"
        return False, f"unknown op {kind!r}"

    def snapshot(self) -> dict:
        """The applied state: a lagging replica's catch-up."""
        with self.lock:
            return {"cluster": self.cluster.to_json() if self.cluster is not None else None,
                    "version": self.version, "cleared": self.cleared,
                    "kv": {k: dict(v) for k, v in self.kv.items()}}

    def install(self, snap: dict) -> None:
        with self.lock:
            c = snap.get("cluster")
            self.cluster = Cluster.from_json(c) if c is not None else None
            self.version = int(snap.get("version", 0))
            self.cleared = bool(snap.get("cleared", False))
            self.kv = {k: dict(v) for k, v in (snap.get("kv") or {}).items()}


def _url_root(url: str) -> str:
    """http://h:p/config -> http://h:p (the /raft RPCs' root)."""
    parts = urllib.parse.urlsplit(url)
    return f"{parts.scheme}://{parts.netloc}"


class _Replicator:
    """The leader lease and the replicated operation log of N replicas.

    Raft-shaped, for 3-5 replicas: epoch-numbered elections (a vote only
    for a candidate whose log is up to date), one leader that appends each
    mutation and waits for a majority before applying it and answering, a
    lease renewed by majority heartbeats (a leader that cannot renew it
    stops serving), and catch-up from the leader's snapshot.  One replica
    runs the same code with a majority of one and no network round.
    """

    def __init__(self, state: _State, replica_id: int, peers: List[str]):
        self.state = state
        self.id = replica_id
        self.peers = [u.rstrip("/") for u in peers]  # client URLs, index = replica id
        self.n = max(1, len(self.peers))
        self._rlock = threading.Lock()  # the raft fields (taken outside state.lock)
        self._write_lock = threading.Lock()  # one client mutation at a time
        self.single = self.n == 1
        self.epoch = LEADER_EPOCH if self.single else 0
        self.voted_epoch = 0
        self.role = "leader" if self.single else "follower"
        self.leader_id: Optional[int] = replica_id if self.single else None
        self.base = 0  # log[0] is global index `base`
        self.base_epoch = 0
        self.log: List[dict] = []  # {"epoch": int, "op": [...]}
        self.commit = 0  # entries [0, commit) are applied
        self.epoch_start = 0  # the first index of the current epoch
        self.match: Dict[int, Optional[int]] = {}
        self.results: Dict[int, Tuple[bool, str]] = {}
        self.hb_s = float(os.environ.get("KFT_RAFT_HB_S", "") or 0.15)
        elect = float(os.environ.get("KFT_RAFT_ELECT_S", "") or 0.6)
        # replica i waits elect + 0.25 i before it campaigns: the lowest
        # live replica wins the race
        self.elect_s = elect + 0.25 * replica_id
        self.lease_valid_s = float("inf") if self.single else 0.75 * elect
        self.step_down_s = 2.0 * elect
        self.rpc_timeout_s = max(0.25, 2.0 * self.hb_s)
        now = time.monotonic()
        self.lease_until = now + self.elect_s
        self.last_quorum = now
        self.paused = False  # drills: the ticker alone stops
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------------

    def start(self) -> "_Replicator":
        if not self.single and self._thread is None:
            self._thread = threading.Thread(target=self._tick_loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    # -- introspection --------------------------------------------------------------

    def _majority(self) -> int:
        return self.n // 2 + 1

    def _end(self) -> int:
        return self.base + len(self.log)

    def _last_epoch(self) -> int:
        return self.log[-1]["epoch"] if self.log else self.base_epoch

    def _hint_locked(self) -> Optional[str]:
        if self.leader_id is None or self.leader_id == self.id:
            return None
        return self.peers[self.leader_id]

    def epoch_now(self) -> int:
        with self._rlock:
            return self.epoch

    def not_leader_body(self) -> dict:
        with self._rlock:
            return {"error": "not_leader", "leader": self._hint_locked(),
                    "leader_epoch": self.epoch}

    def _serving_locked(self) -> bool:
        return (self.role == "leader"
                and time.monotonic() - self.last_quorum <= self.lease_valid_s
                and self.commit >= self.epoch_start)

    def serving(self) -> bool:
        """True iff this replica may answer the document and KV planes: it
        leads, its lease is majority-fresh, and its epoch's no-op has
        committed (its applied state is current)."""
        with self._rlock:
            return self._serving_locked()

    def status(self) -> dict:
        with self._rlock:
            return {"replica": self.id, "role": self.role, "epoch": self.epoch,
                    "leader": self.leader_id,
                    "leader_url": self._hint_locked() or (
                        self.peers[self.id] if self.role == "leader" else None),
                    "log_index": self._end(), "commit": self.commit, "replicas": self.n}

    # -- client mutations -----------------------------------------------------------

    def submit(self, op: list, timeout_s: float = 5.0):
        """Append `op`, replicate it to a majority, apply it: ("ok",
        (applied, msg)); ("not_leader", None) when this replica cannot
        prove it leads (the client retries elsewhere, never a 409); or
        ("unavailable", reason) when no majority answered in timeout_s."""
        with self._write_lock:
            with self._rlock:
                if not self._serving_locked():
                    return "not_leader", None
                epoch = self.epoch
                self.log.append({"epoch": epoch, "op": op})
                target = self._end()
            if self.single:
                with self._rlock:
                    self._advance_locked(target)
                    return "ok", self.results.pop(target, (False, "lost"))
            deadline = time.monotonic() + timeout_s
            while True:
                self._heartbeat()
                with self._rlock:
                    if self.epoch != epoch or self.role != "leader":
                        return "not_leader", None
                    if self.commit >= target:
                        return "ok", self.results.pop(target, (False, "lost"))
                if time.monotonic() >= deadline:
                    return "unavailable", "no replication quorum"
                time.sleep(0.005)

    # -- the RPCs (on the HTTP server's threads) --------------------------------------

    def on_vote(self, body: dict) -> dict:
        epoch = int(body["epoch"])
        with self._rlock:
            if epoch > self.epoch:
                self._become_follower_locked(epoch, None)
            up_to_date = ((int(body.get("last_epoch", 0)), int(body.get("log_index", 0)))
                          >= (self._last_epoch(), self._end()))
            granted = epoch == self.epoch and self.voted_epoch < epoch and up_to_date
            if granted:
                self.voted_epoch = epoch
                # re-arm the election timer: no campaign against the backed candidate
                self.lease_until = time.monotonic() + self.elect_s
            return {"granted": granted, "epoch": self.epoch}

    def on_append(self, body: dict) -> dict:
        epoch = int(body["epoch"])
        with self._rlock:
            if epoch < self.epoch:  # a deposed leader: the new epoch makes it step down
                return {"ok": False, "epoch": self.epoch, "log_index": self.commit}
            if epoch > self.epoch or self.role != "follower":
                self._become_follower_locked(epoch, int(body["leader"]))
            self.leader_id = int(body["leader"])
            self.lease_until = time.monotonic() + self.elect_s
            if "snapshot" in body:  # catch-up: the leader's applied state wholesale
                self.state.install(body["snapshot"])
                self.base = int(body["base"])
                self.base_epoch = int(body["base_epoch"])
                self.log = list(body["entries"])
                self.commit = self.base
                self.results.clear()
            else:
                if int(body["prev"]) != self._end():  # behind or diverged: ask for a snapshot
                    return {"ok": False, "epoch": self.epoch, "log_index": self.commit,
                            "need_sync": True}
                self.log.extend(body["entries"])
            self._advance_locked(min(int(body["commit"]), self._end()))
            return {"ok": True, "epoch": self.epoch, "log_index": self._end()}

    # -- internals ------------------------------------------------------------------

    def _become_follower_locked(self, epoch: int, leader: Optional[int]) -> None:
        was_leader = self.role == "leader"
        if epoch > self.epoch:
            self.epoch = epoch
        self.role = "follower"
        self.leader_id = leader
        self.match = {}
        if was_leader:
            from ..monitor.journal import journal_event

            journal_event("leader_lost", leader_epoch=self.epoch, replica=self.id)
            log.info("replica %d stepped down at epoch %d", self.id, self.epoch)

    def _advance_locked(self, to: int) -> None:
        while self.commit < to:
            entry = self.log[self.commit - self.base]
            self.results[self.commit + 1] = self.state.apply(entry["op"])
            self.commit += 1
        if len(self.results) > 64:  # only the write in flight reads a result
            for idx in sorted(self.results)[:-16]:
                self.results.pop(idx, None)
        self._compact_locked()

    def _compact_locked(self, keep: int = 64) -> None:
        """Drop a long committed prefix: a replica that far behind catches
        up from a snapshot anyway."""
        if len(self.log) > 4 * keep and self.commit - self.base > keep:
            cut = self.commit - self.base - keep
            self.base_epoch = self.log[cut - 1]["epoch"]
            self.log = self.log[cut:]
            self.base += cut

    def _tick_loop(self) -> None:
        last_hb = 0.0
        while not self._stop.wait(0.02):
            if self.paused:
                continue
            with self._rlock:
                role, lease_until = self.role, self.lease_until
            now = time.monotonic()
            if role == "leader":
                if now - last_hb >= self.hb_s:
                    last_hb = now
                    self._heartbeat()
            elif now >= lease_until:
                self._campaign()
                last_hb = 0.0

    def _campaign(self) -> None:
        with self._rlock:
            self.epoch += 1
            epoch = self.epoch
            self.voted_epoch = epoch
            self.role = "candidate"
            self.leader_id = None
            self.lease_until = time.monotonic() + self.elect_s
            body = {"epoch": epoch, "candidate": self.id, "log_index": self._end(),
                    "last_epoch": self._last_epoch()}
        replies = self._broadcast("vote", {r: body for r in self._others()})
        votes, max_epoch = 1, epoch
        for r in replies.values():
            if r is None:
                continue
            max_epoch = max(max_epoch, int(r.get("epoch", 0)))
            votes += bool(r.get("granted"))
        with self._rlock:
            if self.epoch != epoch or self.role != "candidate":
                return
            if max_epoch > epoch:
                self._become_follower_locked(max_epoch, None)
                return
            if votes < self._majority():
                self.role = "follower"  # campaign again after the next timeout
                return
            self.role = "leader"
            self.leader_id = self.id
            self.match = {r: None for r in self._others()}
            # the no-op: once an entry of this epoch commits, the commit
            # point is known and the leader may serve
            self.log.append({"epoch": epoch, "op": ["noop"]})
            self.epoch_start = self._end()
            # the lease starts invalid: the first majority heartbeat proves it
            self.last_quorum = time.monotonic() - 2 * self.lease_valid_s
        from ..monitor.journal import journal_event

        journal_event("leader_elected", leader_epoch=epoch, replica=self.id)
        log.info("replica %d elected leader at epoch %d", self.id, epoch)
        self._heartbeat()

    def _heartbeat(self) -> None:
        with self._rlock:
            if self.role != "leader":
                return
            epoch = self.epoch
            payloads: Dict[int, dict] = {}
            for rid in self._others():
                m = self.match.get(rid)
                head = {"epoch": epoch, "leader": self.id, "commit": self.commit}
                if m is None or m < self.base:  # catch-up from the applied state
                    payloads[rid] = dict(
                        head, snapshot=self.state.snapshot(), base=self.commit,
                        base_epoch=(self.log[self.commit - self.base - 1]["epoch"]
                                    if self.commit > self.base else self.base_epoch),
                        entries=self.log[self.commit - self.base:])
                else:
                    payloads[rid] = dict(head, prev=m, entries=self.log[m - self.base:])
        replies = self._broadcast("append", payloads)
        with self._rlock:
            if self.epoch != epoch or self.role != "leader":
                return
            acks = 1
            for rid, r in replies.items():
                if r is None:
                    continue
                if int(r.get("epoch", 0)) > self.epoch:
                    self._become_follower_locked(int(r["epoch"]), None)
                    self.lease_until = time.monotonic() + self.elect_s
                    return
                if r.get("ok"):
                    acks += 1
                    self.match[rid] = int(r["log_index"])
                elif r.get("need_sync"):
                    self.match[rid] = None
            if acks >= self._majority():
                self.last_quorum = time.monotonic()
                # the commit rule: the highest index on a majority whose
                # entry carries the current epoch
                for idx in range(self._end(), self.commit, -1):
                    if self.log[idx - 1 - self.base]["epoch"] != self.epoch:
                        break
                    have = 1 + sum(1 for m in self.match.values() if m is not None and m >= idx)
                    if have >= self._majority():
                        self._advance_locked(idx)
                        break
            elif time.monotonic() - self.last_quorum > self.step_down_s:
                # cut off from a majority: step down, clients find the new leader
                self._become_follower_locked(self.epoch, None)
                self.lease_until = time.monotonic() + self.elect_s

    def _others(self) -> List[int]:
        return [r for r in range(self.n) if r != self.id]

    def _broadcast(self, rpc: str, payloads: Dict[int, dict]) -> Dict[int, Optional[dict]]:
        """One POST /raft/<rpc> to each addressed replica, in parallel; None
        for a replica that did not answer within the RPC timeout."""
        out: Dict[int, Optional[dict]] = {rid: None for rid in payloads}
        if not payloads:
            return out
        done = threading.Event()
        pending = [len(payloads)]
        plock = threading.Lock()

        def one(rid: int, body: dict) -> None:
            try:
                req = urllib.request.Request(
                    f"{_url_root(self.peers[rid])}/raft/{rpc}", data=json.dumps(body).encode(),
                    method="POST", headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.rpc_timeout_s) as r:
                    out[rid] = json.loads(r.read().decode())
            except (OSError, ValueError):
                out[rid] = None
            with plock:
                pending[0] -= 1
                if pending[0] == 0:
                    done.set()

        for rid, body in payloads.items():
            threading.Thread(target=one, args=(rid, body), daemon=True).start()
        done.wait(self.rpc_timeout_s + 0.2)
        return out


class ConfigServer:
    """Threaded config server, one replica of an ensemble of `peers` (its
    replica id indexes them) or a single server; .start()/.stop()
    embedded, or serve_forever."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9100,
                 init: Optional[Cluster] = None, chaos=None, replica_id: int = 0,
                 peers: Optional[List[str]] = None):
        from ..chaos import server_chaos_from_env

        self.state = state = _State(init)
        # scripted outage windows (KFT_FAULT_PLAN flap@config_server=...)
        chaos = chaos if chaos is not None else server_chaos_from_env()
        this = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                log.debug(fmt, *args)

            def _send(self, code: int, body: bytes = b"", ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, body: dict) -> None:
                self._send(code, json.dumps(body).encode())

            def _flapped(self) -> bool:
                if chaos is not None and chaos.should_503():
                    self._send(503, b'{"error": "chaos flap"}')
                    return True
                return False

            def _not_leader(self) -> bool:
                """Answer 421 and the leader hint unless this replica
                serves; True when it answered."""
                if this.node.serving():
                    return False
                self._json(421, this.node.not_leader_body())
                return True

            def _epoch(self) -> int:
                return this.node.epoch_now()

            def _read_body(self):
                """(ok, parsed); ok False means a 400 was already sent."""
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    return True, json.loads(self.rfile.read(n).decode() or "null")
                except (ValueError, OSError) as e:
                    self._json(400, {"error": str(e)})
                    return False, None

            def _reply(self, status, result, body: Optional[dict] = None) -> None:
                """The answer to a submitted mutation: 421 when this replica
                lost the lead, 503 without a quorum, else `body` (default
                the applied result's message: 200, or 409 when rejected)."""
                if status == "not_leader":
                    self._json(421, this.node.not_leader_body())
                elif status == "unavailable":
                    self._json(503, {"error": result, "leader_epoch": self._epoch()})
                elif body is not None:
                    self._json(200, {**body, "leader_epoch": self._epoch()})
                else:
                    ok, msg = result
                    self._json(200 if ok else 409, {"msg": msg, "leader_epoch": self._epoch()})

            def _kv_key(self) -> Optional[str]:
                """The key of a `.../kv/<key>` path, "" for the list form
                `.../kv?prefix=`, None for any other path."""
                path = self.path
                if "/kv/" in path:
                    return path.split("/kv/", 1)[1].split("?", 1)[0]
                if path.split("?", 1)[0].rstrip("/").endswith("/kv"):
                    return ""
                return None

            def _cluster_of(self, doc):
                """(cluster or None, PUT's expected version, reconvene); a
                400, 421 or 409 was sent when the cluster is None.  A
                cluster is validated before it reaches the log."""
                try:
                    c = Cluster.from_json(doc.get("cluster", doc))
                    version = doc.get("version") if isinstance(doc, dict) else None
                    reconvene = bool(isinstance(doc, dict) and doc.get("reconvene"))
                except Exception as e:  # noqa: BLE001 - any malformed body is a 400
                    self._json(400, {"error": str(e)})
                    return None, None, False
                if self._not_leader():
                    return None, None, False
                try:
                    c.validate()
                except ValueError as e:
                    self._json(409, {"msg": f"invalid cluster: {e}",
                                     "leader_epoch": self._epoch()})
                    return None, None, False
                return c, version, reconvene

            def do_GET(self):
                if self.path.startswith("/stop"):
                    self._send(200, b"{}")
                    threading.Thread(target=this.stop, daemon=True).start()
                    return
                if self.path.startswith("/raft/"):  # local on every replica
                    self._json(200, this.node.status())
                    return
                key = self._kv_key()
                if key is not None:
                    # the liveness plane: answered inside a flap window, by
                    # the leader only (t_server comes from one clock)
                    if self._not_leader():
                        return
                    if key == "":
                        q = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
                        body = state.kv_list((q.get("prefix") or [""])[0])
                        body["leader_epoch"] = self._epoch()
                        self._json(200, body)
                        return
                    got = state.kv_get(key)
                    if got is None:
                        self._send(404, b'{"error": "no such key"}')
                        return
                    self._json(200, {**got, "leader_epoch": self._epoch()})
                    return
                if self.path.rstrip("/").endswith("/health"):
                    # answered inside a flap window and by followers
                    body = state.health()
                    body.update(this.node.status() if not this.node.single
                                else {"role": "leader", "replica": 0})
                    body["leader_epoch"] = self._epoch()
                    self._json(200, body)
                    return
                if self._not_leader() or self._flapped():
                    return
                got = state.get()
                if got is None:
                    self._send(404, b'{"error": "no config"}')
                    return
                cluster, version = got
                self._json(200, {"cluster": cluster.to_json(), "version": version,
                                 "leader_epoch": self._epoch()})

            def do_PUT(self):
                key = self._kv_key()
                if key:
                    ok, value = self._read_body()
                    if ok and not self._not_leader():
                        self._reply(*this.node.submit(
                            ["kv_put", key, value, round(time.time(), 6)]), body={})
                    return
                if self._flapped():
                    return
                ok, doc = self._read_body()
                if not ok:
                    return
                c, version, reconvene = self._cluster_of(doc)
                if c is not None:
                    expect = int(version) if version is not None else None
                    self._reply(*this.node.submit(["put", c.to_json(), expect, reconvene]))

            def do_POST(self):
                if self.path.startswith("/raft/"):
                    ok, body = self._read_body()
                    if not ok:
                        return
                    rpc = self.path.rstrip("/").rsplit("/", 1)[-1]
                    if rpc == "vote":
                        self._json(200, this.node.on_vote(body))
                    elif rpc == "append":
                        self._json(200, this.node.on_append(body))
                    else:
                        self._send(404, b'{"error": "no such rpc"}')
                    return
                if self._flapped():
                    return
                ok, doc = self._read_body()
                if not ok:
                    return
                c, _, _ = self._cluster_of(doc)
                if c is not None:
                    self._reply(*this.node.submit(["post", c.to_json()]))

            def do_DELETE(self):
                if self._not_leader():
                    return
                key = self._kv_key()
                op = ["kv_delete", key] if key else ["delete"]
                self._reply(*this.node.submit(op), body={})

        # a respawned replica takes its old port: an outbound socket may hold it
        self._httpd = bind_when_free(lambda: ThreadingHTTPServer((host, port), Handler),
                                     port, host, f"config replica {replica_id}")
        self.host = host
        self.port = self._httpd.server_address[1]
        self.replica_id = replica_id
        self.node = _Replicator(self.state, replica_id, peers if peers else [self.url])
        self._thread: Optional[threading.Thread] = None
        self._serving = False  # serve_forever runs (shutdown waits for it to return)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/config"

    def status(self) -> dict:
        """This replica's /raft/status."""
        return self.node.status()

    def start(self) -> "ConfigServer":
        self.node.start()
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        log.info("config server at %s", self.url)
        return self

    def serve_forever(self) -> None:
        """Serve in this thread until /stop (the module's main)."""
        self.node.start()
        self._serving = True
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass

    def stop(self) -> None:
        self.node.stop()
        if self._serving:
            self._httpd.shutdown()
            self._serving = False
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def kill(self) -> None:
        """An abrupt death in this process for failover tests: no step
        down, no drain; the socket goes away as under SIGKILL."""
        self.stop()


def main(argv=None):
    ap = argparse.ArgumentParser("kungfu_tpu_torch config server")
    ap.add_argument("-port", type=int, default=9100)
    ap.add_argument("-host", default="0.0.0.0")
    ap.add_argument("-init", default="", help="path to the initial cluster JSON")
    ap.add_argument("-replica-id", dest="replica_id", type=int, default=0,
                    help="this replica's index into -peers (replicated mode)")
    ap.add_argument("-peers", default="",
                    help="comma-separated client URLs of every replica of the ensemble, in "
                    "replica-id order (this one included); empty: a single server")
    args = ap.parse_args(argv)
    init = None
    if args.init:
        with open(args.init) as f:
            init = Cluster.from_json(json.load(f))
    peers = [u.strip() for u in args.peers.split(",") if u.strip()] or None
    if peers is not None and not 0 <= args.replica_id < len(peers):
        ap.error(f"-replica-id {args.replica_id} out of range for {len(peers)} peers")
    if peers is not None:
        from ..monitor.journal import set_journal_context

        set_journal_context(rank=f"config-{args.replica_id}",
                            identity=f"config-{args.replica_id}")
    srv = ConfigServer(args.host, args.port, init, replica_id=args.replica_id, peers=peers)
    log.info("serving on %s (replica %d of %d)", srv.url, args.replica_id, srv.node.n)
    srv.serve_forever()


if __name__ == "__main__":
    main()
