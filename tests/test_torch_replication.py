"""The replicated control plane of the port (elastic/config_server.py,
config_client.py, ensemble.py) against the JAX package's.

The cases of tests/unit/test_replication.py, on the port: the single
server stamps every answer with leader_epoch 1 and keeps the exact 409
text; its /raft/status; a trio elects its lowest replica and serves CAS
through the comma-list client; a follower answers 421 with the leader's
URL, which the client follows; a killed leader fails over with the epoch
moving; KV writes reach every replica with the leader's one t_server; the
client's seen epoch only rises and a stale read is an OSError; and the
CAS storm through a leader kill loses no update and applies none twice.

Then the wire against the JAX package's, with the JAX modules loaded by
`tests/_torch_reference.py`: the JAX ConfigClient against a port trio and
the port's client against a JAX trio (CAS, a conflict, the hint from a
follower, a failover); the sequence of raw requests of
tests/test_torch_elastic.py against each trio's leader giving the same
codes and bodies, timestamps and the servers' own URLs aside; and one
ensemble of port and JAX replicas.  Last, `ConfigEnsemble`'s replicas in
processes of their own: a SIGKILLed leader is replaced and respawned at
its port, and the respawned replica catches up from the snapshot; and the
module's -replica-id range check.
"""
from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from _torch_ranks import REPO
from _torch_reference import jax_reference
from kungfu_tpu_torch import plan as tplan
from kungfu_tpu_torch.elastic import config_client as CC
from kungfu_tpu_torch.elastic import config_server as CS
from kungfu_tpu_torch.elastic.ensemble import ConfigEnsemble, free_ports


@pytest.fixture(scope="module")
def jk():
    with jax_reference():
        from kungfu_tpu import plan as jplan
        from kungfu_tpu.elastic import config_client as jcc
        from kungfu_tpu.elastic import config_server as jcs

        yield types.SimpleNamespace(plan=jplan, cc=jcc, cs=jcs)


PORT = types.SimpleNamespace(plan=tplan, cc=CC, cs=CS)


@pytest.fixture(autouse=True)
def _fast_raft(monkeypatch):
    """Elections of a few tenths of a second (the replicas read these at
    construction), and no fault plan from the environment."""
    monkeypatch.setenv("KFT_RAFT_ELECT_S", "0.3")
    monkeypatch.setenv("KFT_RAFT_HB_S", "0.08")
    monkeypatch.delenv("KFT_FAULT_PLAN", raising=False)


def _cluster(n=3, pkg=PORT):
    return pkg.plan.Cluster.from_hostlist(pkg.plan.HostList.parse(f"127.0.0.1:{n}"), n)


def _get_json(url):
    with urllib.request.urlopen(url, timeout=2) as r:
        return json.loads(r.read().decode())


def _trio(pkgs=(PORT,) * 3, init=_cluster):
    """Three replicas in this process knowing each other from birth,
    replica i built by pkgs[i]'s ConfigServer, its document init(pkg=)."""
    ports = free_ports(3)
    urls = [f"http://127.0.0.1:{p}/config" for p in ports]
    servers = [pkg.cs.ConfigServer(port=ports[i], init=init(pkg=pkg), replica_id=i,
                                   peers=urls).start() for i, pkg in enumerate(pkgs)]
    return servers, urls


def _leader_of(servers, wait_s=10.0):
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        for s in servers:
            st = s.node.status()
            if st["role"] == "leader" and st["commit"] >= 1:
                return st["replica"]
        time.sleep(0.05)
    return None


def _stop_all(servers):
    for s in servers:
        try:
            s.stop()
        except Exception:  # noqa: BLE001 - a killed replica is already down
            pass


# -- one replica -------------------------------------------------------------------------

def test_document_and_health_stamped():
    srv = CS.ConfigServer(port=0, init=_cluster()).start()
    try:
        doc = _get_json(srv.url)
        assert doc["leader_epoch"] == 1 and doc["version"] == 0 and "cluster" in doc
        health = _get_json(srv.url + "/health")
        assert health["leader_epoch"] == 1
        assert health["role"] == "leader" and health["replica"] == 0
    finally:
        srv.stop()


def test_put_responses_stamped_and_409_text_exact():
    srv = CS.ConfigServer(port=0, init=_cluster()).start()
    try:
        body = json.dumps({"cluster": _cluster(2).to_json(), "version": 0}).encode()
        req = urllib.request.Request(srv.url, data=body, method="PUT")
        with urllib.request.urlopen(req, timeout=2) as r:
            out = json.loads(r.read().decode())
        assert out["msg"] == "ok" and out["leader_epoch"] == 1
        req = urllib.request.Request(srv.url, data=body, method="PUT")  # the same CAS again
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=2)
        assert e.value.code == 409
        assert json.loads(e.value.read().decode())["msg"] == "version conflict: expected 0, at 1"
        req = urllib.request.Request(srv.url + "/kv/drill/a", data=json.dumps({"x": 1}).encode(),
                                     method="PUT")
        with urllib.request.urlopen(req, timeout=2) as r:
            assert json.loads(r.read().decode())["leader_epoch"] == 1
        got = _get_json(srv.url + "/kv/drill/a")
        assert got["value"] == {"x": 1} and got["leader_epoch"] == 1
    finally:
        srv.stop()


def test_raft_status_single():
    srv = CS.ConfigServer(port=0, init=_cluster()).start()
    try:
        st = _get_json(srv.url.rsplit("/", 1)[0] + "/raft/status")
        assert st["role"] == "leader" and st["epoch"] == 1 and st["replicas"] == 1
        assert st["leader_url"] == srv.url
    finally:
        srv.stop()


# -- a trio ------------------------------------------------------------------------------

def test_lowest_replica_wins_and_client_cas_works():
    servers, urls = _trio()
    try:
        assert _leader_of(servers) == 0  # the staggered election
        client = CC.ConfigClient(",".join(urls), retries=6, retry_deadline_s=10.0)
        assert client.urls_spec == ",".join(urls)
        c, v = client.wait_for_config(timeout_s=10.0)
        assert c.size() == 3
        assert client.put_cluster(c.resize(2), version=v)
        assert not client.put_cluster(c.resize(4), version=v)  # a conflict, at once
        c2, v2 = client.get_cluster()
        assert c2.size() == 2 and v2 == v + 1
    finally:
        _stop_all(servers)


def test_follower_answers_421_with_leader_hint():
    servers, urls = _trio()
    try:
        lead = _leader_of(servers)
        follower = next(u for i, u in enumerate(urls) if i != lead)
        for method, path in (("GET", ""), ("GET", "/kv/x"), ("DELETE", "")):
            req = urllib.request.Request(follower + path, method=method)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=2)
            assert e.value.code == 421
            body = json.loads(e.value.read().decode())
            assert body["error"] == "not_leader" and body["leader"] == urls[lead]
        # the liveness plane answers on a follower
        health = _get_json(follower + "/health")
        assert health["role"] == "follower" and health["leader"] == lead
    finally:
        _stop_all(servers)


def test_client_follows_hint_from_follower():
    servers, urls = _trio()
    try:
        lead = _leader_of(servers)
        rotated = [u for i, u in enumerate(urls) if i != lead] + [urls[lead]]
        client = CC.ConfigClient(",".join(rotated), retries=6, retry_deadline_s=10.0)
        c, v = client.get_cluster()
        assert client.put_cluster(c.resize(2), version=v)
        assert client.url == urls[lead]  # straight to the hint
    finally:
        _stop_all(servers)


def test_leader_kill_fails_over_and_epoch_moves():
    servers, urls = _trio()
    try:
        lead = _leader_of(servers)
        client = CC.ConfigClient(",".join(urls), retries=10, retry_deadline_s=20.0)
        _, v = client.wait_for_config(timeout_s=10.0)
        epoch0 = servers[lead].node.status()["epoch"]
        servers[lead].kill()
        survivors = [s for i, s in enumerate(servers) if i != lead]
        new_lead = _leader_of(survivors, wait_s=15.0)
        assert new_lead is not None and new_lead != lead
        c, v1 = client.get_cluster()
        assert v1 >= v
        assert client.put_cluster(c.resize(2), version=v1)
        st = [s for s in survivors if s.node.status()["role"] == "leader"][0].node.status()
        assert st["epoch"] > epoch0
    finally:
        _stop_all(servers)


def test_kv_replicates_to_all():
    servers, urls = _trio()
    try:
        lead = _leader_of(servers)
        req = urllib.request.Request(urls[lead] + "/kv/hb/r0",
                                     data=json.dumps({"beat": 7}).encode(), method="PUT")
        urllib.request.urlopen(req, timeout=2).close()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            vals = [s.state.kv_get("hb/r0") for s in servers]
            if all(v is not None and v["value"] == {"beat": 7} for v in vals):
                assert len({v["t_server"] for v in vals}) == 1  # the leader's stamp, replayed
                return
            time.sleep(0.05)
        pytest.fail("the KV entry did not reach every replica")
    finally:
        _stop_all(servers)


def test_seen_epoch_enforces_monotonicity():
    client = CC.ConfigClient("http://127.0.0.1:9,http://127.0.0.1:10")
    client._seen_epoch({"leader_epoch": 5})
    with pytest.raises(CC.StaleLeaderRead):
        client._seen_epoch({"leader_epoch": 4})
    client._seen_epoch({"leader_epoch": 4}, enforce=False)  # liveness data: recorded only
    assert client._seen_epoch({"leader_epoch": 6})["leader_epoch"] == 6


def test_stale_read_is_oserror_for_poll_loops():
    assert issubclass(CC.StaleLeaderRead, OSError)


def test_storm_through_leader_kill():
    """A healer, two autoscalers and a reconvene nudger racing through a
    leader kill: no call dropped, each thread's versions monotonic, no
    version won twice, and the final version at least the wins."""
    random.seed(20260807)
    servers, urls = _trio()
    stop = threading.Event()
    wins, versions, drops = {}, {}, []
    lock = threading.Lock()

    def storm(name, reconvene=False):
        client = CC.ConfigClient(",".join(urls), timeout_s=2.0, retries=10, backoff_s=0.02,
                                 backoff_max_s=0.3, retry_deadline_s=15.0)
        my_wins, my_versions = [], []
        while not stop.is_set():
            try:
                got = client.get_cluster()
                if got is not None:
                    c, v = got
                    my_versions.append(v)
                    if reconvene:
                        ok = client.reconvene_cluster(c, v)
                    else:
                        ok = client.put_cluster(c.resize(4 if c.size() <= 3 else 3), version=v)
                    if ok:
                        my_wins.append(v)
            except OSError as e:
                drops.append(f"{name}: {e}")
            stop.wait(0.01)
        with lock:
            wins[name], versions[name] = my_wins, my_versions

    threads = [threading.Thread(target=storm, args=(name, name == "nudge"), daemon=True)
               for name in ("healer", "scaler-a", "scaler-b", "nudge")]
    try:
        lead = _leader_of(servers)
        assert lead is not None
        for t in threads:
            t.start()
        time.sleep(1.0)
        servers[lead].kill()  # mid-storm, no drain
        time.sleep(2.5)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not drops, drops
        for name, vs in versions.items():
            assert vs == sorted(vs), f"{name} saw versions regress"
        all_wins = [v for ws in wins.values() for v in ws]
        assert all_wins, "the storm never committed a CAS"
        assert len(all_wins) == len(set(all_wins)), ("lost update", sorted(wins.items()))
        survivors = [s for i, s in enumerate(servers) if i != lead]
        assert max(s.state.health()["version"] for s in survivors) >= len(all_wins)
    finally:
        stop.set()
        _stop_all(servers)


# -- against the JAX package ----------------------------------------------------------------

def _client_ops(cc, urls, lead, servers, plan):
    """One client's calls against a trio, as plain data: the document, a
    CAS and its conflict, a reconvene, the KV plane, the hint from a
    follower, then the same after the leader's kill."""
    rotated = [u for i, u in enumerate(urls) if i != lead] + [urls[lead]]
    client = cc.ConfigClient(",".join(rotated), retries=10, retry_deadline_s=20.0)
    c, v = client.get_cluster()
    out = [client.url == urls[lead], c.size(), v]
    out += [client.put_cluster(c.resize(2), version=v), client.put_cluster(c.resize(4), version=v)]
    c2, v2 = client.get_cluster()
    out += [c2.size(), v2, client.reconvene_cluster(c2, v2), client.get_cluster()[1]]
    out += [client.kv_put("hb/a", {"n": 1}), client.kv_get("hb/a")["value"], client.kv_get("no")]
    out += [sorted(client.kv_list("hb/")["entries"])]
    servers[lead].kill()
    c3, v3 = client.get_cluster()
    out += [c3.size(), v3, client.put_cluster(c3.resize(3), version=v3)]
    out += [client.url != urls[lead], client.get_cluster()[0].size(),
            client.kv_get("hb/a")["value"]]
    return out


WANT_OPS = [True, 3, 0, True, False, 2, 1, True, 2, True, {"n": 1}, None, ["hb/a"], 2, 2, True,
            True, 3, {"n": 1}]


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "port"), ("port", "jax"),
                                                   ("port", "port"), ("jax", "jax")])
def test_clients_and_trios_interoperate(jk, client_pkg, server_pkg):
    """The JAX client against a port trio and the port's against a JAX
    trio give what each gives against its own."""
    pkgs = {"port": PORT, "jax": jk}
    servers, urls = _trio((pkgs[server_pkg],) * 3)
    try:
        lead = _leader_of(servers)
        got = _client_ops(pkgs[client_pkg].cc, urls, lead, servers, pkgs[client_pkg].plan)
    finally:
        _stop_all(servers)
    assert got == WANT_OPS


def test_trio_wire_matches_jax(jk):
    """One sequence of raw requests (tests/test_torch_elastic.py's)
    against the leader of a port trio and of a JAX trio: the same codes
    and bodies, clocks and the servers' own URLs aside."""
    from test_torch_elastic import _docs, _raw_sequence

    got = {}
    for name, pkg in (("port", PORT), ("jax", jk)):
        servers, urls = _trio((pkg,) * 3, init=lambda pkg: _docs(pkg.plan)[0])
        try:
            lead = _leader_of(servers)
            got[name] = _raw_sequence(urls[lead].rsplit("/", 1)[0], pkg.plan)
        finally:
            _stop_all(servers)
    assert got["port"] == got["jax"]
    assert [c for c, _ in got["port"]] == [200, 200, 200, 409, 200, 200, 409, 400, 400, 200,
                                           200, 200, 200, 200, 200, 404, 200, 404, 200, 404,
                                           409, 200, 200, 200, 200, 200, 200]
    status = got["port"][-1][1]
    assert status["role"] == "leader" and status["replicas"] == 3


def test_mixed_ensemble(jk):
    """Two port replicas and a JAX one form one ensemble: replica 0 (the
    port's) leads, the KV plane reaches all three with one stamp, and
    when it dies the next (the port's) leads and the JAX replica follows
    it."""
    servers, urls = _trio((PORT, PORT, jk))
    try:
        assert _leader_of(servers) == 0
        client = CC.ConfigClient(",".join(urls), retries=10, retry_deadline_s=20.0)
        assert client.kv_put("hb/mixed", {"n": 3})
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            vals = [s.state.kv_get("hb/mixed") for s in servers]
            if all(v is not None for v in vals):
                break
            time.sleep(0.05)
        assert len({json.dumps(v, sort_keys=True) for v in vals}) == 1
        servers[0].kill()
        c, v = client.get_cluster()
        assert client.put_cluster(c.resize(2), version=v)
        assert _leader_of(servers[1:]) == 1
        deadline = time.monotonic() + 5.0
        while servers[2].state.health()["version"] != v + 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert servers[2].state.health()["version"] == v + 1
        assert servers[2].node.status()["leader"] == 1
    finally:
        _stop_all(servers)


# -- the ensemble of processes ----------------------------------------------------------------

def test_ensemble_respawns_and_catches_up():
    ens = ConfigEnsemble(replicas=3, init=_cluster()).start()
    try:
        client = ens.client(retries=10, retry_deadline_s=20.0)
        c, v = client.wait_for_config(timeout_s=15.0)
        assert client.put_cluster(c.resize(2), version=v)
        epoch0 = ens.raft_status(ens.leader())["epoch"]
        killed = ens.kill_leader()
        assert killed == 0
        c, v = client.get_cluster()
        assert client.put_cluster(c.resize(3), version=v)
        led = ens.leader(wait_s=10.0)
        assert led != killed and ens.raft_status(led)["epoch"] > epoch0
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            sts = ens.statuses()
            if (ens.respawns >= 1 and all(s is not None for s in sts)
                    and sts[killed]["commit"] == sts[led]["commit"]):
                break
            time.sleep(0.1)
        assert ens.respawns >= 1
        assert sts[killed]["commit"] == sts[led]["commit"] and sts[killed]["role"] == "follower"
        ens.pause_replica(led)  # a silent leader is replaced ...
        try:
            assert ens.leader(wait_s=10.0) not in (None, led) or ens.raft_status(led) is None
        finally:
            ens.resume_replica(led)
        deadline = time.monotonic() + 10.0  # ... and steps down once it wakes
        while time.monotonic() < deadline:
            st = ens.raft_status(led)
            if st is not None and st["role"] == "follower":
                break
            time.sleep(0.1)
        assert st["role"] == "follower"
    finally:
        ens.stop()
    assert all(p is None or p.poll() is not None for p in ens._procs)


def test_config_server_module_checks_the_replica_id():
    r = subprocess.run([sys.executable, "-m", "kungfu_tpu_torch.elastic.config_server",
                        "-replica-id", "3", "-peers", "http://127.0.0.1:1/config"],
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 2 and "out of range for 1 peers" in r.stderr
