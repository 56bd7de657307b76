"""Elastic config service: an HTTP store of one versioned Cluster document
(counterpart of kungfu_tpu.elastic.config_server, single-server mode).

Reference: srcs/go/kungfu/elastic/configserver/configserver.go:42-110 and
the standalone binary (cmd/kungfu-config-server/kungfu-config-server.go):
GET returns the current cluster (404 while cleared), PUT validates and
bumps the version (rejected while cleared), POST installs or resets,
DELETE clears, /stop shuts the server down.  Embedded in the launcher
(`-w`, `-builtin-config-server`) or standalone:

    python -m kungfu_tpu_torch.elastic.config_server -port 9100 [-init cluster.json]

The wire is the JAX package's, byte for byte in its bodies, so a client of
either package talks to a server of either:

  - GET of any path ending in /health answers {ok, version, size, cleared,
    role, replica, leader_epoch} without the document;
  - a PUT body carrying "version": N is conditional: 409 unless N is the
    stored version ("version": null keeps the reference's unconditional
    PUT); a conditional PUT with "reconvene": true bumps the version even
    when the document's bytes are unchanged;
  - a KV plane under <url>/kv/<key>: PUT stores a JSON value stamped with
    the server's receive time (t_server), GET returns one entry, GET
    <url>/kv?prefix=P lists matching entries and the server's `now`,
    DELETE removes one;
  - every answer carries the leader_epoch stamp of the replicated control
    plane, which a single server fixes at 1, and GET /raft/status its
    single-replica status.

A `flap@config_server=D[:after=N]` fault in KFT_FAULT_PLAN (chaos/) makes
the server answer 503 to document requests for the scripted window, as the
JAX server does (`ServerChaos.should_503` on every request; /health and the
KV plane are the liveness plane and answer inside the window).  The
replicated control plane (`-replica-id`, `-peers`: the leader-leased
ensemble of the JAX package) raises until it is ported (ROADMAP A.5c).
"""
from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from ..plan import Cluster
from ..utils import get_logger

log = get_logger("kungfu.configserver")

LEADER_EPOCH = 1  # a single server is the leader of epoch 1 for its whole life


class _State:
    def __init__(self, init: Optional[Cluster] = None):
        self.lock = threading.Lock()
        self.cluster: Optional[Cluster] = init
        self.version = 0
        self.cleared = False
        self.kv: dict = {}  # key -> {"value": ..., "t_server": float}
        self.log_index = 0  # mutations applied (the replicated log's length)

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

    def kv_put(self, key: str, value) -> None:
        with self.lock:
            self.kv[key] = {"value": value, "t_server": round(time.time(), 6)}

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

    def apply(self, fn, *args):
        """One mutation, counted as the replicated log counts its entries."""
        out = fn(*args)
        with self.lock:
            self.log_index += 1
        return out


class ConfigServer:
    """Threaded config server; .start()/.stop() embedded, or serve_forever."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9100,
                 init: Optional[Cluster] = None, chaos=None, replica_id: int = 0,
                 peers: Optional[List[str]] = None):
        if peers or replica_id:
            raise NotImplementedError("ConfigServer(replica_id=..., peers=...): the replicated "
                                      "control plane is not ported yet (ROADMAP A.5c)")
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

            def _read_body(self):
                """(ok, parsed); ok False means a 400 was already sent."""
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    return True, json.loads(self.rfile.read(n).decode() or "null")
                except (ValueError, OSError) as e:
                    self._json(400, {"error": str(e)})
                    return False, None

            def _reply(self, result: Tuple[bool, str]) -> None:
                ok, msg = result
                self._json(200 if ok else 409, {"msg": msg, "leader_epoch": LEADER_EPOCH})

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
                400 was sent when the cluster is None."""
                try:
                    c = Cluster.from_json(doc.get("cluster", doc))
                    version = doc.get("version") if isinstance(doc, dict) else None
                    reconvene = bool(isinstance(doc, dict) and doc.get("reconvene"))
                except Exception as e:  # noqa: BLE001 - any malformed body is a 400
                    self._json(400, {"error": str(e)})
                    return None, None, False
                try:
                    c.validate()
                except ValueError as e:
                    self._json(409, {"msg": f"invalid cluster: {e}", "leader_epoch": LEADER_EPOCH})
                    return None, None, False
                return c, version, reconvene

            def do_GET(self):
                if self.path.startswith("/stop"):
                    self._send(200, b"{}")
                    threading.Thread(target=this.stop, daemon=True).start()
                    return
                if self.path.startswith("/raft/"):
                    self._json(200, this.status())
                    return
                key = self._kv_key()
                if key is not None:
                    if key == "":
                        q = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
                        body = state.kv_list((q.get("prefix") or [""])[0])
                        body["leader_epoch"] = LEADER_EPOCH
                        self._json(200, body)
                        return
                    got = state.kv_get(key)
                    if got is None:
                        self._send(404, b'{"error": "no such key"}')
                        return
                    self._json(200, {**got, "leader_epoch": LEADER_EPOCH})
                    return
                if self.path.rstrip("/").endswith("/health"):
                    self._json(200, {**state.health(), "role": "leader", "replica": 0,
                                     "leader_epoch": LEADER_EPOCH})
                    return
                if self._flapped():
                    return
                got = state.get()
                if got is None:
                    self._send(404, b'{"error": "no config"}')
                    return
                cluster, version = got
                self._json(200, {"cluster": cluster.to_json(), "version": version,
                                 "leader_epoch": LEADER_EPOCH})

            def do_PUT(self):
                key = self._kv_key()
                if key:
                    ok, doc = self._read_body()
                    if ok:
                        state.apply(state.kv_put, key, doc)
                        self._json(200, {"leader_epoch": LEADER_EPOCH})
                    return
                if self._flapped():
                    return
                ok, doc = self._read_body()
                if not ok:
                    return
                c, version, reconvene = self._cluster_of(doc)
                if c is not None:
                    expect = int(version) if version is not None else None
                    self._reply(state.apply(state.put, c, expect, reconvene))

            def do_POST(self):
                if not self.path.startswith("/raft/") and self._flapped():
                    return
                ok, doc = self._read_body()
                if not ok:
                    return
                if self.path.startswith("/raft/"):
                    self._send(404, b'{"error": "no such rpc"}')
                    return
                c, _, _ = self._cluster_of(doc)
                if c is not None:
                    self._reply(state.apply(state.post, c))

            def do_DELETE(self):
                key = self._kv_key()
                if key:
                    state.apply(state.kv_delete, key)
                else:
                    state.apply(state.delete)
                self._json(200, {"leader_epoch": LEADER_EPOCH})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/config"

    def status(self) -> dict:
        """The replicated control plane's status of a single replica."""
        n = self.state.log_index
        return {"replica": 0, "role": "leader", "epoch": LEADER_EPOCH, "leader": 0,
                "leader_url": self.url, "log_index": n, "commit": n, "replicas": 1}

    def start(self) -> "ConfigServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        log.info("config server at %s", self.url)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None


def main(argv=None):
    ap = argparse.ArgumentParser("kungfu_tpu_torch config server")
    ap.add_argument("-port", type=int, default=9100)
    ap.add_argument("-host", default="0.0.0.0")
    ap.add_argument("-init", default="", help="path to the initial cluster JSON")
    ap.add_argument("-replica-id", dest="replica_id", type=int, default=0,
                    help="replicated mode: not ported yet (ROADMAP A.5c)")
    ap.add_argument("-peers", default="", help="replicated mode: not ported yet (ROADMAP A.5c)")
    args = ap.parse_args(argv)
    init = None
    if args.init:
        with open(args.init) as f:
            init = Cluster.from_json(json.load(f))
    peers = [u.strip() for u in args.peers.split(",") if u.strip()] or None
    srv = ConfigServer(args.host, args.port, init, replica_id=args.replica_id, peers=peers)
    log.info("serving on %s", srv.url)
    try:
        srv._httpd.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
