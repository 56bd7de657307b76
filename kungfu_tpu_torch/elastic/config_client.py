"""HTTP client of the elastic config service (counterpart of
kungfu_tpu.elastic.config_client).

Reference: workers GET/PUT the versioned Cluster JSON from the config
server (srcs/go/kungfu/peer/peer.go:265 getClusterConfig, legacy.go:18-37
ProposeNewSize -> HTTP PUT of the resized Cluster).  Pure stdlib HTTP.

Every request runs under bounded retry with exponential backoff and full
jitter, capped by a wall-clock deadline: a config server that restarts or
is overloaded (5xx, or 421 from a replica that is not the leader) is ridden
out inside the client.  Semantic answers (404 no config, 409 a rejected
PUT) are never retried.  `poll_cluster` is the variant the poll loops use:
an outage past the retry budget is None ("no new config visible").

A URL list (`KFT_CONFIG_URLS` with several URLs: the replicated ensemble's
failover client) raises until the ensemble is ported (ROADMAP A.5c).
"""
from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional, Tuple

from ..plan import Cluster
from ..utils import get_logger

log = get_logger("kungfu.elastic")


class ConfigClient:
    def __init__(self, url: str, timeout_s: float = 5.0, retries: int = 5,
                 backoff_s: float = 0.1, backoff_max_s: float = 2.0,
                 retry_deadline_s: float = 10.0):
        urls = [u.strip().rstrip("/") for u in (url or "").split(",") if u.strip()]
        if not urls:
            raise ValueError("config server URL is empty")
        if len(urls) > 1:
            raise NotImplementedError(f"ConfigClient({url!r}): the failover client of a "
                                      "replicated config ensemble is not ported yet "
                                      "(ROADMAP A.5c)")
        self.url = urls[0]
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.retry_deadline_s = retry_deadline_s

    def _with_retry(self, fn, what: str):
        """`fn` with bounded retry on transport errors, 5xx and 421;
        backoff uniform in (cap/2, cap], doubling up to backoff_max_s,
        within both the attempt count and the wall-clock deadline."""
        t0 = time.monotonic()
        cap = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except urllib.error.HTTPError as e:
                if e.code < 500 and e.code != 421:  # a semantic answer: the caller's
                    raise
                err: OSError = e
            except (TimeoutError, OSError) as e:  # URLError, refused, reset, timeout
                err = e
            delay = cap * (0.5 + 0.5 * random.random())
            if attempt == self.retries or time.monotonic() - t0 + delay > self.retry_deadline_s:
                raise err
            log.debug("%s failed (%s); retry %d in %.2fs", what, err, attempt + 1, delay)
            time.sleep(delay)
            cap = min(cap * 2, self.backoff_max_s)

    def _request(self, url: str, method: str = "GET", body: Optional[bytes] = None):
        """(status, parsed JSON body or None) of one request."""
        req = urllib.request.Request(url, data=body, method=method,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            raw = r.read().decode()
            return r.status, (json.loads(raw) if raw else None)

    def get_cluster(self) -> Optional[Tuple[Cluster, int]]:
        """GET the current (cluster, version); None while cleared (404)."""
        try:
            _, doc = self._with_retry(lambda: self._request(self.url), "config GET")
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
            return self._with_retry(lambda: self._request(self.url + "/health"),
                                    "config health GET")[1]
        except OSError:
            return None

    def _put(self, body: dict, what: str) -> bool:
        data = json.dumps(body).encode()
        try:
            status, _ = self._with_retry(lambda: self._request(self.url, "PUT", data), what)
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
                lambda: self._request(f"{self.url}/kv/{key}", "PUT", data), f"kv PUT {key}")
        except OSError:
            return False
        return 200 <= status < 300

    def kv_get(self, key: str) -> Optional[dict]:
        """One entry as {"value": ..., "t_server": float, ...}, or None."""
        try:
            return self._with_retry(lambda: self._request(f"{self.url}/kv/{key}"),
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
        url = f"{self.url}/kv?prefix={urllib.parse.quote(prefix)}"
        try:
            return self._with_retry(lambda: self._request(url), f"kv LIST {prefix}")[1]
        except OSError:
            return None

    def kv_delete(self, key: str) -> None:
        try:
            self._with_retry(lambda: self._request(f"{self.url}/kv/{key}", "DELETE"),
                             f"kv DELETE {key}")
        except OSError:
            pass  # best effort: a stale key is judged by its t_server anyway

    def clear(self) -> None:
        self._with_retry(lambda: self._request(self.url, "DELETE"), "config DELETE")

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
