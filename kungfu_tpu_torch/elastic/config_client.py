"""HTTP client of the elastic config service (counterpart of
kungfu_tpu.elastic.config_client).

Reference: workers GET/PUT the versioned Cluster JSON from the config
server (srcs/go/kungfu/peer/peer.go:265 getClusterConfig, legacy.go:18-37
ProposeNewSize -> HTTP PUT of the resized Cluster).  Pure stdlib HTTP.

Every request runs under bounded retry with exponential backoff and full
jitter, capped by a wall-clock deadline: a config server that restarts or
is overloaded (5xx) is ridden out inside the client.  Semantic answers
(404 no config, 409 a rejected PUT) are never retried.  `poll_cluster` is
the variant the poll loops use: an outage past the retry budget is None
("no new config visible").

The failover client of the replicated ensemble: `url` may be a comma list
of replica URLs (the KFT_CONFIG_URLS form; `urls_spec` gives it back).
The client talks to one endpoint at a time; a transport error or a 5xx
rotates to the next, and a 421 (not the leader) jumps to the leader its
body names, both inside the retry budget, so a call site sees the single
server's behaviour with a failover's outage in place of a dead server.
Each answer's leader_epoch is tracked: a read stamped with an epoch older
than one already seen is a deposed leader's, discarded and retried
(`StaleLeaderRead`, an OSError).  A 409 comes only from a leader that has
just proven its lease, so it is a real version conflict and is returned at
once.
"""
from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional, Tuple

from ..plan import Cluster
from ..utils import get_logger

log = get_logger("kungfu.elastic")


class StaleLeaderRead(OSError):
    """An answer stamped with a leader_epoch older than one already seen:
    the replica that gave it lost the lead and is not believed.  An
    OSError, so the retry and poll loops take it as a transport fault."""


class ConfigClient:
    def __init__(self, url: str, timeout_s: float = 5.0, retries: int = 5,
                 backoff_s: float = 0.1, backoff_max_s: float = 2.0,
                 retry_deadline_s: float = 10.0):
        self._urls = [u.strip().rstrip("/") for u in (url or "").split(",") if u.strip()]
        if not self._urls:
            raise ValueError("config server URL is empty")
        self._active = 0
        self._max_epoch = 0
        self._ep_lock = threading.Lock()
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.retry_deadline_s = retry_deadline_s

    @property
    def url(self) -> str:
        """The endpoint in use (every request is built from it)."""
        return self._urls[self._active]

    @property
    def urls_spec(self) -> str:
        """Every endpoint in the comma form of KFT_CONFIG_URLS: what a
        launcher hands its workers, so that each rides its own failovers."""
        return ",".join(self._urls)

    def _rotate(self) -> None:
        self._active = (self._active + 1) % len(self._urls)

    def _follow_hint(self, e: urllib.error.HTTPError) -> None:
        """A 421 body names the leader ({"leader": url or null}): go there
        when it is one of ours, else to the next endpoint."""
        hint = None
        try:
            hint = (json.loads(e.read().decode() or "{}") or {}).get("leader")
        except (ValueError, OSError):
            pass
        if hint and hint.rstrip("/") in self._urls:
            self._active = self._urls.index(hint.rstrip("/"))
        else:
            self._rotate()

    def _seen_epoch(self, doc, enforce: bool = True):
        """Track the highest leader_epoch seen; with `enforce`, an answer
        of an older epoch raises StaleLeaderRead.  Returns `doc`."""
        if isinstance(doc, dict) and doc.get("leader_epoch") is not None:
            epoch = int(doc["leader_epoch"])
            with self._ep_lock:
                if epoch >= self._max_epoch:
                    self._max_epoch = epoch
                elif enforce:
                    raise StaleLeaderRead(f"stale leader read: epoch {epoch} < {self._max_epoch}")
        return doc

    def _with_retry(self, fn, what: str):
        """`fn` with bounded retry on transport errors, 5xx, 421 and stale
        reads, each moving to another endpoint (a 421 to its hint);
        backoff uniform in (cap/2, cap], doubling up to backoff_max_s,
        within both the attempt count and the wall-clock deadline."""
        t0 = time.monotonic()
        cap = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except urllib.error.HTTPError as e:
                if e.code == 421:  # not the leader: follow the hint
                    self._follow_hint(e)
                elif e.code < 500:  # a semantic answer: the caller's
                    raise
                else:
                    self._rotate()
                err: OSError = e
            except (TimeoutError, OSError) as e:  # URLError, refused, reset, timeout, stale
                self._rotate()
                err = e
            delay = cap * (0.5 + 0.5 * random.random())
            if attempt == self.retries or time.monotonic() - t0 + delay > self.retry_deadline_s:
                raise err
            log.debug("%s failed (%s); retry %d in %.2fs", what, err, attempt + 1, delay)
            time.sleep(delay)
            cap = min(cap * 2, self.backoff_max_s)

    def _request(self, path: str = "", method: str = "GET", body: Optional[bytes] = None,
                 epoch: Optional[bool] = True):
        """(status, parsed JSON body or None) of one request to the endpoint
        in use plus `path`; the body's leader_epoch is checked (`epoch`
        True), only recorded (False), or ignored (None)."""
        req = urllib.request.Request(self.url + path, data=body, method=method,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            raw = r.read().decode()
            doc = json.loads(raw) if raw else None
            if epoch is not None:
                self._seen_epoch(doc, enforce=epoch)
            return r.status, doc

    def get_cluster(self) -> Optional[Tuple[Cluster, int]]:
        """GET the current (cluster, version); None while cleared (404)."""
        try:
            _, doc = self._with_retry(lambda: self._request(), "config GET")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
        return Cluster.from_json(doc["cluster"]), int(doc.get("version", 0))

    def poll_cluster(self) -> Optional[Tuple[Cluster, int]]:
        """get_cluster for poll loops: an outage past the retry budget is
        None (logged), "keep doing what you were doing"."""
        try:
            return self.get_cluster()
        except OSError as e:
            log.warning("config server unreachable: %s", e)
            return None

    def get_health(self) -> Optional[dict]:
        """GET /health: {ok, version, size, cleared, ...} without the
        document; None when the server is unreachable."""
        try:
            return self._with_retry(lambda: self._request("/health", epoch=False),
                                    "config health GET")[1]
        except OSError:
            return None

    def _put(self, body: dict, what: str) -> bool:
        data = json.dumps(body).encode()
        try:
            status, _ = self._with_retry(
                lambda: self._request("", "PUT", data, epoch=False), what)
        except urllib.error.HTTPError as e:
            log.warning("%s rejected: %s", what, e)
            return False
        return 200 <= status < 300

    def put_cluster(self, cluster: Cluster, version: Optional[int] = None) -> bool:
        """PUT a new cluster; the server validates it and bumps the version.
        With `version` the PUT is conditional: rejected when the stored
        version has moved.  False if the server rejected it (cleared
        config or version conflict, reference configserver.go:60-88)."""
        return self._put({"cluster": cluster.to_json(), "version": version}, "config PUT")

    def reconvene_cluster(self, cluster: Cluster, version: int) -> bool:
        """Conditional PUT that bumps the version even when the membership
        is unchanged (the partition-heal nudge); False when a racing PUT
        won the version."""
        return self._put({"cluster": cluster.to_json(), "version": version, "reconvene": True},
                         "config reconvene PUT")

    # -- the KV liveness plane -----------------------------------------------------

    def kv_put(self, key: str, value) -> bool:
        """PUT one JSON value under <url>/kv/<key> (the server stamps
        t_server); False when the server is unreachable."""
        data = json.dumps(value).encode()
        try:
            status, _ = self._with_retry(
                lambda: self._request(f"/kv/{key}", "PUT", data, epoch=None), f"kv PUT {key}")
        except OSError:
            return False
        return 200 <= status < 300

    def kv_get(self, key: str) -> Optional[dict]:
        """One entry as {"value": ..., "t_server": float, ...}, or None."""
        try:
            return self._with_retry(lambda: self._request(f"/kv/{key}"),
                                    f"kv GET {key}")[1]
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
        except OSError:
            return None

    def kv_list(self, prefix: str = "") -> Optional[dict]:
        """{"now": server time, "entries": {key: {"value", "t_server"}}}
        for the keys under `prefix`; None when the server is unreachable."""
        path = f"/kv?prefix={urllib.parse.quote(prefix)}"
        try:
            return self._with_retry(lambda: self._request(path), f"kv LIST {prefix}")[1]
        except OSError:
            return None

    def kv_delete(self, key: str) -> None:
        try:
            self._with_retry(lambda: self._request(f"/kv/{key}", "DELETE", epoch=None),
                             f"kv DELETE {key}")
        except OSError:
            pass  # best effort: a stale key is judged by its t_server anyway

    def clear(self) -> None:
        self._with_retry(lambda: self._request("", "DELETE", epoch=None),
                         "config DELETE")

    def wait_for_config(self, poll_s: float = 0.05,
                        timeout_s: float = 120.0) -> Tuple[Cluster, int]:
        t0 = time.monotonic()
        while True:
            got = self.poll_cluster()
            if got is not None:
                return got
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"no config at {self.url} after {timeout_s}s")
            time.sleep(poll_s)


def propose_new_size(peer, new_size: int) -> bool:
    """Rank 0 proposes a resize: GET the current document, Cluster.resize,
    PUT it back conditional on the version just read (a concurrent writer
    wins, never silently overwritten).  Reference Peer.ProposeNewSize
    (srcs/go/kungfu/peer/legacy.go:18-37): only rank 0 acts, and a
    proposal of the current size is a no-op.  True if the PUT took."""
    if peer.rank != 0:
        return False
    url = peer.config.config_server
    if not url:
        raise RuntimeError("propose_new_size requires KFT_CONFIG_SERVER")
    client = ConfigClient(url)
    try:
        got = client.get_cluster()
        cluster, version = got if got is not None else (peer.config.cluster(),
                                                        peer.cluster_version)
        if cluster.size() == new_size:
            return False  # already proposed (or applied): no spurious bump
        ok = client.put_cluster(cluster.resize(new_size), version=version)
    except OSError as e:  # an outage past the retry budget drops the proposal
        log.warning("propose_new_size: config server unreachable: %s", e)
        return False
    log.info("proposed resize %d -> %d: %s", cluster.size(), new_size,
             "ok" if ok else "rejected")
    return ok
