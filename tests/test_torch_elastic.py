"""The port's elastic resize against the JAX package's, on the CPU.

* `elastic.schedule.StepBasedSchedule` on the specs of
  tests/integration/test_elastic.py and more, the invalid ones too, bit
  for bit against the JAX class;
* the cluster document: `Cluster.resize` (growing over several hosts,
  shrinking, a document with serving `tiers`), `digest`, `to_json` /
  `from_json` and the peer-list set algebra against the JAX plan, and
  `peer.coordinator_port` against the JAX package's at versions 0, 1, 999
  and 1000 with the same refusal of a root port too high;
* the wire: one sequence of raw requests to the port's and the JAX
  package's config servers (GET, POST, PUT, a stale conditional PUT, a
  reconvene with identical bytes, DELETE and a PUT while cleared,
  /health, the KV plane, /raft/status) gives the same codes and bodies,
  timestamps aside; each client (port, JAX) against each server gives the
  same results; `propose_new_size` on rank 0, on rank 1 and with the same
  size, against the JAX function;
* the consensus and sync programs on 3 gloo ranks: `agree_vec` agrees,
  converges with `refresh`, and times out into TimeoutError on values
  that never agree; `sync_state` takes the counters' max and rank 0's
  state bit for bit, integer leaves keeping their dtype
  (tests/unit/test_elastic_programs.py's case), and a fresh AdamW
  receives a stepped one's moments and step;
* `Peer.update_cluster` on gloo ranks: 3 -> 2 (rank 2 returns False and
  is detached; the survivors all-reduce over 2), then 2 -> 3 with a
  joiner started at the new version; each group listens at
  `coordinator_port(root port, version)` and not at the root port; the
  journal stamps follow the rank; `default_peer()` stays the same Peer;
* the launcher: `python -m kungfu_tpu_torch.run -w -np 2 -platform cpu --
  python -m kungfu_tpu_torch.testing.fake_adaptive_trainer --schedule
  2:8,3:8,2:100 --total-samples 2048 --check-every 2` (its two RESULT
  lines, one DETACHED); the same replay under each package's watch
  launcher through tests/_elastic_replay.py, the survivors' final loss and
  `w` within rtol 1e-6 of the JAX run's; a run resumed from its
  checkpoints, and SIGTERM to the watch launcher stopping its workers;
* one process, no resize: `run_elastic` on the fake trainer's functions
  against the JAX `run_elastic` in this process, on one of its virtual
  devices (`jax.devices` narrowed to the first for the JAX run: its
  reduction over 8 copies of one gradient would round where a single
  process does not), the final loss and `w` to rtol 1e-6, then against the
  JAX DataParallelTrainer stepping the same batches.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import MAX_WORKER_PORT, REPO, _free_port_range, start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch import peer as peer_mod
from kungfu_tpu_torch import plan as tplan
from kungfu_tpu_torch.elastic import config_client as CC
from kungfu_tpu_torch.elastic import config_server as CS
from kungfu_tpu_torch.elastic.schedule import StepBasedSchedule
from kungfu_tpu_torch.plan import Cluster, HostList, PeerID, PeerList
from kungfu_tpu_torch.store import STORE_PORT_OFFSET


@pytest.fixture(scope="module")
def jk():
    with jax_reference() as kf:
        from kungfu_tpu import peer as jpeer
        from kungfu_tpu import plan as jplan
        from kungfu_tpu.elastic import config_client as jcc
        from kungfu_tpu.elastic import config_server as jcs
        from kungfu_tpu.elastic import schedule as jsched

        yield types.SimpleNamespace(kf=kf, plan=jplan, peer=jpeer, cc=jcc, cs=jcs, sched=jsched)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the schedule and the cluster document -----------------------------------------------

SPECS = ["2:10,3:20,1:5", "", "4:2,2:2,4:2", "1:1", "8:100,1:3,8:1"]
BAD_SPECS = ["0:5", "2:0", "-1:3", "2", "a:b", "2:3:4"]


@pytest.mark.parametrize("spec", SPECS)
def test_schedule_matches_jax(jk, spec):
    ours, theirs = StepBasedSchedule(spec), jk.sched.StepBasedSchedule(spec)
    assert ours.pieces == theirs.pieces and bool(ours) == bool(theirs)
    assert ours.total_steps == theirs.total_steps
    assert [ours.size_at(s) for s in range(ours.total_steps + 3)] == \
        [theirs.size_at(s) for s in range(theirs.total_steps + 3)]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_schedule_refuses_what_jax_refuses(jk, spec):
    with pytest.raises(ValueError):
        jk.sched.StepBasedSchedule(spec)
    with pytest.raises(ValueError):
        StepBasedSchedule(spec)


RESIZES = [("127.0.0.1:4", 2, [4, 1, 3, 0]),
           ("10.0.0.1:2,10.0.0.2:2,10.0.0.3:1", 2, [5, 3, 4, 1]),
           ("a:1,b:3", 4, [1, 2, 3])]


@pytest.mark.parametrize("hosts,np_,sizes", RESIZES)
def test_cluster_resize_matches_jax(jk, hosts, np_, sizes):
    ours = Cluster.from_hostlist(HostList.parse(hosts), np_)
    theirs = jk.plan.Cluster.from_hostlist(jk.plan.HostList.parse(hosts), np_)
    for n in sizes:
        ours, theirs = ours.resize(n), theirs.resize(n)
        assert ours.to_json() == theirs.to_json()
        assert ours.bytes() == theirs.bytes() and ours.digest() == theirs.digest()
        assert Cluster.from_json(theirs.to_json()) == ours
    with pytest.raises(ValueError):
        ours.resize(-1)


def test_tiered_document_round_trips(jk):
    doc = jk.plan.Cluster.from_hostlist(jk.plan.HostList.parse("h:4"), 3).assign_tiers(1)
    ours = Cluster.from_json(doc.to_json())
    assert ours.tiers == doc.tiers and ours.digest() == doc.digest()
    assert ours.to_json() == doc.to_json()
    for n in (2, 4):
        assert ours.resize(n).to_json() == doc.resize(n).to_json()
    bad = dict(doc.to_json(), tiers={"h:10000": "gpu"})
    with pytest.raises(ValueError):
        Cluster.from_json(bad).validate()


def test_peer_list_set_algebra_matches_jax(jk):
    a = [("x", 1), ("y", 1), ("x", 2), ("z", 5)]
    b = [("y", 1), ("z", 5), ("w", 9)]
    mine = [PeerList(PeerID(h, p) for h, p in xs) for xs in (a, b)]
    ref = [jk.plan.PeerList(jk.plan.PeerID(h, p) for h, p in xs) for xs in (a, b)]
    for op in ("diff", "intersection"):
        assert [str(p) for p in getattr(mine[0], op)(mine[1])] == \
            [str(p) for p in getattr(ref[0], op)(ref[1])]
    assert mine[0].disjoint(mine[1]) == ref[0].disjoint(ref[1])
    assert mine[0].eq(PeerList(mine[0])) and not mine[0].eq(mine[1])
    assert mine[0].hosts() == ref[0].hosts()
    assert {h: [str(p) for p in v] for h, v in mine[0].partition_by_host().items()} == \
        {h: [str(p) for p in v] for h, v in ref[0].partition_by_host().items()}
    assert [mine[0].local_size(p) for p in mine[0]] == [ref[0].local_size(p) for p in ref[0]]
    assert PeerList.from_json(ref[0].to_json()) == mine[0]


@pytest.mark.parametrize("version", [0, 1, 999, 1000])
def test_coordinator_port_matches_jax(jk, version):
    for root in (10000, 12345, MAX_WORKER_PORT):
        assert peer_mod.coordinator_port(root, version) == jk.peer.coordinator_port(root, version)
    for high in (MAX_WORKER_PORT + 1, 60000):
        with pytest.raises(ValueError, match="pick worker ports <= 44536"):
            peer_mod.coordinator_port(high, version)
        with pytest.raises(ValueError, match="pick worker ports <= 44536"):
            jk.peer.coordinator_port(high, version)


# -- the wire ------------------------------------------------------------------------------

def _strip(x):
    """A response body without its clocks and the server's own URL."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in ("t_server", "now", "leader_url")}
    return x


def _raw(url: str, method: str, path: str, body=None):
    data = body if isinstance(body, bytes) or body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            code, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    return code, _strip(json.loads(raw.decode() or "null"))


def _docs(plan):
    c0 = plan.Cluster.from_hostlist(plan.HostList.parse("127.0.0.1:4"), 2)
    c1 = c0.resize(3)
    bad = plan.Cluster(runners=plan.PeerList(), workers=c1.workers)  # a worker without a runner
    return c0, c1, bad


def _raw_sequence(base: str, plan):
    """(code, body) of each request of one sequence; `base` is the server's
    root URL (the document lives at /config)."""
    c0, c1, bad = _docs(plan)
    seq = [
        ("GET", "/config", None), ("GET", "/config/health", None),
        ("PUT", "/config", {"cluster": c1.to_json(), "version": None}),
        ("PUT", "/config", {"cluster": c0.to_json(), "version": 0}),  # stale: 409
        ("PUT", "/config", {"cluster": c1.to_json(), "version": 1, "reconvene": True}),
        ("PUT", "/config", {"cluster": c1.to_json(), "version": None}),  # unchanged
        ("PUT", "/config", {"cluster": bad.to_json(), "version": None}),  # invalid: 409
        ("PUT", "/config", b"{not json"),  # 400
        ("PUT", "/config", {"workers": []}),  # no runners: 400
        ("GET", "/config", None),
        ("PUT", "/config/kv/runner-hb/a", {"alive": True}),
        ("PUT", "/config/kv/suspect/b", {"reason": "x", "step": 3}),
        ("GET", "/config/kv/runner-hb/a", None), ("GET", "/config/kv?prefix=runner", None),
        ("GET", "/config/kv?prefix=", None), ("GET", "/config/kv/none", None),
        ("DELETE", "/config/kv/runner-hb/a", None), ("GET", "/config/kv/runner-hb/a", None),
        ("DELETE", "/config", None), ("GET", "/config", None),
        ("PUT", "/config", {"cluster": c0.to_json(), "version": None}),  # cleared: 409
        ("GET", "/config/health", None),
        ("POST", "/config", {"cluster": c0.to_json()}), ("GET", "/config", None),
        ("POST", "/config", c1.to_json()), ("GET", "/config/health", None),
        ("GET", "/raft/status", None),
    ]
    return [_raw(base, m, p, b) for m, p, b in seq]


def _server(cs_mod, plan):
    c0, _, _ = _docs(plan)
    return cs_mod.ConfigServer(port=_free_port(), init=c0).start()


def test_wire_matches_jax_server(jk, monkeypatch):
    monkeypatch.delenv("KFT_FAULT_PLAN", raising=False)
    ours, theirs = _server(CS, tplan), _server(jk.cs, jk.plan)
    try:
        got = _raw_sequence(f"http://127.0.0.1:{ours.port}", tplan)
        want = _raw_sequence(f"http://127.0.0.1:{theirs.port}", jk.plan)
    finally:
        ours.stop()
        theirs.stop()
    assert [c for c, _ in got] == [200, 200, 200, 409, 200, 200, 409, 400, 400, 200, 200, 200,
                                   200, 200, 200, 404, 200, 404, 200, 404, 409, 200, 200, 200,
                                   200, 200, 200]
    assert got == want


def _drive(client_mod, url: str, plan):
    """The results of one client's calls, as plain data."""
    c0, c1, _ = _docs(plan)
    c = client_mod.ConfigClient(url, retry_deadline_s=2.0)

    def doc(got):
        return None if got is None else (got[0].to_json(), got[1])

    out = [doc(c.get_cluster()), c.get_health()]
    out += [c.put_cluster(c1), c.put_cluster(c0, version=0), c.reconvene_cluster(c1, 1),
            c.reconvene_cluster(c1, 0), doc(c.poll_cluster())]
    out += [c.kv_put("suspect/a", {"step": 2}), _strip(c.kv_get("suspect/a")),
            c.kv_get("nothing"), _strip(c.kv_list("suspect/"))]
    c.kv_delete("suspect/a")
    out += [c.kv_get("suspect/a")]
    c.clear()
    out += [c.get_cluster(), c.poll_cluster(), c.put_cluster(c0)]
    with pytest.raises(TimeoutError):
        c.wait_for_config(timeout_s=0.2)
    out += [c.get_health()]
    return out


def test_clients_and_servers_interoperate(jk, monkeypatch):
    """Each client against each server: the port's client against the JAX
    server, the JAX client against the port's server, and each against
    its own package's, all alike."""
    monkeypatch.delenv("KFT_FAULT_PLAN", raising=False)
    results = {}
    for sname, smod, splan in (("port", CS, tplan), ("jax", jk.cs, jk.plan)):
        for cname, cmod, cplan in (("port", CC, tplan), ("jax", jk.cc, jk.plan)):
            srv = _server(smod, splan)
            try:
                results[(cname, sname)] = _drive(cmod, srv.url, cplan)
            finally:
                srv.stop()
    first = results[("jax", "jax")]
    assert first[2:7] == [True, False, True, False, (_docs(jk.plan)[1].to_json(), 2)]
    assert all(r == first for r in results.values()), results


def test_unreachable_server_and_ensembles(jk):
    dead = f"http://127.0.0.1:{_free_port()}/config"
    c = CC.ConfigClient(dead, retries=1, backoff_s=0.01, retry_deadline_s=0.5)
    assert c.poll_cluster() is None and c.get_health() is None and c.kv_put("k", 1) is False
    with pytest.raises(OSError):
        c.get_cluster()
    with pytest.raises(NotImplementedError, match="A.5c"):
        CC.ConfigClient(f"{dead},{dead}")
    with pytest.raises(NotImplementedError, match="A.5c"):
        CS.ConfigServer(port=0, replica_id=1, peers=[dead, dead])


def test_config_server_module(tmp_path, monkeypatch):
    """`python -m kungfu_tpu_torch.elastic.config_server -port P -init
    file` serves the document until /stop; under the chaos harness's
    outage plan the server answers 503 for its window."""
    c0, _, _ = _docs(tplan)
    (tmp_path / "init.json").write_text(json.dumps(c0.to_json()))
    port = _free_port()
    p = subprocess.Popen([sys.executable, "-m", "kungfu_tpu_torch.elastic.config_server",
                          "-host", "127.0.0.1", "-port", str(port), "-init",
                          str(tmp_path / "init.json")], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    try:
        client = CC.ConfigClient(f"http://127.0.0.1:{port}/config")
        assert client.wait_for_config(timeout_s=30) == (c0, 0)
        assert _raw(f"http://127.0.0.1:{port}", "GET", "/stop") == (200, {})
        assert p.wait(timeout=30) == 0
    finally:
        if p.poll() is None:
            p.kill()
    monkeypatch.setenv("KFT_FAULT_PLAN", "flap@config_server=30:after=1")
    srv = CS.ConfigServer(port=0, init=c0).start()
    try:
        assert _raw(srv.url.rsplit("/", 1)[0], "GET", "/config")[0] == 200
        assert _raw(srv.url.rsplit("/", 1)[0], "GET", "/config")[0] == 503
    finally:
        srv.stop()


def _fake_peer(rank: int, url: str, plan):
    c0, _, _ = _docs(plan)
    return types.SimpleNamespace(rank=rank, cluster_version=0, config=types.SimpleNamespace(
        config_server=url, cluster=lambda: c0))


@pytest.mark.parametrize("rank,size", [(0, 3), (1, 3), (0, 2), (0, 1)])
def test_propose_new_size_matches_jax(jk, monkeypatch, rank, size):
    """Only rank 0 acts; a proposal of the current size (2) is a no-op; the
    PUT is conditional on the version just read."""
    monkeypatch.delenv("KFT_FAULT_PLAN", raising=False)
    got = {}
    for name, smod, cmod, plan in (("port", CS, CC, tplan), ("jax", jk.cs, jk.cc, jk.plan)):
        srv = _server(smod, plan)
        try:
            ok = cmod.propose_new_size(_fake_peer(rank, srv.url, plan), size)
            doc = _raw(f"http://127.0.0.1:{srv.port}", "GET", "/config")
        finally:
            srv.stop()
        got[name] = (ok, doc)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (rank == 0 and size != 2)


# -- the programs on 3 gloo ranks -----------------------------------------------------------

PROGRAMS = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.elastic.trainer import _GroupPrograms
    from kungfu_tpu_torch.train import DataParallelTrainer

    distributed.init_distributed(device="cpu")
    r = dist.get_rank()
    pr = _GroupPrograms(DataParallelTrainer(lambda m, b: None, None, device="cpu"))
    res = {"agree": pr.agree_vec((5, 7, -3))}
    calls = []
    res["refresh"] = pr.agree_vec((r,), refresh=lambda: calls.append(1) or (42,))
    res["refresh_calls"] = len(calls)
    try:
        pr.agree_vec((r, 1), timeout_s=1.0, refresh=lambda: (r, 1))
        res["never"] = "agreed"
    except TimeoutError as e:
        res["never"] = type(e).__name__
    res["agree_int"] = pr.agree_int(9)

    # tests/unit/test_elastic_programs.py: integer leaves keep their dtype
    tree = {"count": torch.tensor(3 + r, dtype=torch.int32), "value": torch.tensor(1.5 + r),
            "step64": torch.tensor(9 + r, dtype=torch.int64), "lr": 0.1, "flags": [True, None]}
    counters, out = pr.sync_state((5 + r, 7 - r), tree)
    res["counters"] = counters
    res["dtypes"] = [str(out[k].dtype) for k in ("count", "value", "step64")]
    res["values"] = [out["count"].item(), out["value"].item(), out["step64"].item()]
    res["scalars"] = [out["lr"], out["flags"]]

    # a joiner's fresh AdamW receives a stepped one's moments and step
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    if r == 0:
        for i in range(3):
            for p in model.parameters():
                p.grad = torch.full_like(p, 0.1 * (i + 1))
            opt.step()
    counters, got = pr.sync_state((0, 3 * (r == 0)),
                                  {"params": dict(model.state_dict()), "opt": opt.state_dict()})
    model.load_state_dict(got["params"])
    fresh = torch.optim.AdamW(model.parameters(), lr=1e-2)
    fresh.load_state_dict(got["opt"])
    st = fresh.state_dict()["state"]
    res["opt"] = {str(i): {k: v.flatten().tolist() if v.dim() else v.item()
                           for k, v in s.items()} for i, s in st.items()}
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    fresh.step()
    res["after"] = [p.detach().flatten().tolist() for p in model.parameters()]
    res["opt_counters"] = counters
    print("PROGRAMS " + json.dumps(res), flush=True)
    distributed.shutdown_distributed()
""")


def test_consensus_and_sync_programs():
    outs = wait_ranks(start_ranks(PROGRAMS, 3, []), timeout=120)
    res = [json.loads(next(l[9:] for l in o.splitlines() if l.startswith("PROGRAMS ")))
           for _, o in sorted(outs.items())]
    for r, got in enumerate(res):
        assert got["agree"] == [5, 7, -3] and got["agree_int"] == 9
        assert got["refresh"] == [42] and got["refresh_calls"] >= 1
        assert got["never"] == "TimeoutError"
        assert got["counters"] == [7, 7]
        assert got["dtypes"] == ["torch.int32", "torch.float32", "torch.int64"]
        assert got["values"] == [3, 1.5, 9]  # rank 0's, on every rank
        assert got["scalars"] == [0.1, [True, None]]
        assert got["opt_counters"] == [0, 3]
        assert got["opt"] == res[0]["opt"] and got["opt"]["0"]["step"] == 3.0
        assert got["after"] == res[0]["after"]  # bit-identical replicas from here on
    assert len(res[0]["opt"]) == 2 and any(res[0]["opt"]["0"]["exp_avg"])


# -- Peer.update_cluster ----------------------------------------------------------------------

RESIZE_WORKER = textwrap.dedent("""
    import json, socket, sys
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import peer as P
    from kungfu_tpu_torch.monitor import journal
    from kungfu_tpu_torch.plan import Cluster, PeerID, PeerList

    p = P.Peer(device="cpu").start()
    P.set_default_peer(p)
    root = p.config.peers[0]
    runners = PeerList([PeerID("127.0.0.1", 38080)])

    def listens(port):
        try:
            socket.create_connection(("127.0.0.1", port), timeout=2).close()
            return True
        except OSError:
            return False

    def state():
        t = torch.ones(1)
        dist.all_reduce(t)
        return {"sum": t.item(), "rank": p.rank, "size": p.size,
                "fenced": listens(P.coordinator_port(root.port, p.cluster_version)),
                "root_port": listens(root.port), "stamp": journal._context.get("rank"),
                "stamp_version": journal._context.get("cluster_version"),
                "default": P.default_peer() is p, "session": p.current_session().mesh.size}

    out = {}
    if sys.argv[1] == "joiner":  # started at version 2 by the env
        out["v2"] = state()
    else:
        out["v0"] = state()
        two = Cluster(runners=runners, workers=PeerList(p.config.peers[:2]))
        out["kept"] = p.update_cluster(two, 1)
        out["detached"] = p.detached
        if out["kept"]:
            out["v1"] = state()
            joiner = PeerID.parse(sys.argv[2])
            three = Cluster(runners=runners, workers=PeerList([*p.config.peers, joiner]))
            assert p.update_cluster(three, 2)
            out["v2"] = state()
    print("RESIZE " + json.dumps(out), flush=True)
    p.close()
""")


def test_update_cluster_shrinks_and_grows():
    port = _free_port_range(4, MAX_WORKER_PORT, (STORE_PORT_OFFSET,))
    specs = [f"127.0.0.1:{port + r}" for r in range(4)]
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RESIZE_WORKER, "rank", specs[3]],
        env=dict(base, KFT_SELF_SPEC=specs[r], KFT_INIT_PEERS=",".join(specs[:3])),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(3)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", RESIZE_WORKER, "joiner"],
        env=dict(base, KFT_SELF_SPEC=specs[3], KFT_INIT_PEERS=",".join(specs[:2] + specs[3:]),
                 KFT_INIT_CLUSTER_VERSION="2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = wait_ranks(procs, timeout=120)
    res = [json.loads(next(l[7:] for l in o.splitlines() if l.startswith("RESIZE ")))
           for _, o in sorted(outs.items())]
    for r in range(3):
        v0 = res[r]["v0"]
        assert (v0["sum"], v0["rank"], v0["size"], v0["stamp"]) == (3.0, r, 3, r)
        assert v0["fenced"] and not v0["root_port"]  # the group listens at the fenced port
    assert res[2]["kept"] is False and res[2]["detached"] is True and "v1" not in res[2]
    for r in range(2):
        assert res[r]["kept"] is True and res[r]["detached"] is False
        v1, v2 = res[r]["v1"], res[r]["v2"]
        assert (v1["sum"], v1["rank"], v1["size"], v1["stamp_version"]) == (2.0, r, 2, 1)
        assert (v2["sum"], v2["rank"], v2["size"], v2["stamp_version"]) == (3.0, r, 3, 2)
        assert v1["default"] and v2["default"] and v2["session"] == 3
        assert v1["fenced"] and v2["fenced"] and not v2["root_port"]
    j = res[3]["v2"]
    assert (j["sum"], j["rank"], j["size"], j["stamp"], j["stamp_version"]) == (3.0, 2, 3, 2, 2)


# -- the launcher ---------------------------------------------------------------------------

# the launcher with its first worker port at argv[1] (free ports, not 10000+)
_LAUNCHER = textwrap.dedent("""
    import functools, sys
    from kungfu_tpu_torch.plan import peer
    from kungfu_tpu_torch.run.__main__ import main

    base = int(sys.argv[1])
    peer.HostList.gen_peer_list = functools.partialmethod(
        peer.HostList.gen_peer_list, port_base=base, port_limit=base + 64)
    sys.exit(main(sys.argv[2:]))
""")
# a loopback alias of its own: a worker the resize grows takes port 10000
# there (Cluster._grow_one), and its blob store binds that alias only
HOST = "127.0.0.3"
FAKE = [sys.executable, "-m", "kungfu_tpu_torch.testing.fake_adaptive_trainer"]


def _watch(np_: int, *worker: str, extra=(), **kw):
    base = _free_port_range(np_, MAX_WORKER_PORT, (STORE_PORT_OFFSET,))
    args = [sys.executable, "-c", _LAUNCHER, str(base), "-w", "-np", str(np_), "-H",
            f"{HOST}:{np_ + 2}", "-self", HOST, "-port", str(_free_port()), "-platform", "cpu",
            *extra, "--", *worker]
    return args, dict(cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                      **kw)


def test_launcher_resizes_fake_trainer():
    args, kw = _watch(2, *FAKE, "--schedule", "2:8,3:8,2:100", "--total-samples", "2048",
                      "--check-every", "2")
    r = subprocess.run(args, capture_output=True, text=True, timeout=240, **kw)
    out = r.stdout
    assert r.returncode == 0, out[-4000:] + r.stderr[-2000:]
    results = [line for line in out.splitlines() if "RESULT:" in line]
    detached = [line for line in out.splitlines() if "DETACHED:" in line]
    assert len(results) == 2 and len(detached) == 1, out[-4000:]
    for line in results:
        assert "resizes=2 " in line and "trained=2048 " in line and "final_size=2 " in line
    losses = {line.split("loss=")[1].split()[0] for line in results}
    assert len(losses) == 1, results


REPLAY = os.path.join(REPO, "tests", "_elastic_replay.py")


def test_launcher_resize_matches_jax():
    """The same 2 -> 3 -> 2 replay under each package's watch launcher
    (tests/_elastic_replay.py: the fake trainer's bowl and SGD(0.1) on
    batches centred on 1): every survivor's final loss and `w` within
    rtol 1e-6 of the JAX run's. A survivor or joiner that resumed at
    another offset, or skipped or repeated a batch, trains on other
    numbers and misses by far more."""
    runs = {}
    for pkg, host in (("jax", "127.0.0.4"), ("torch", "127.0.0.5")):
        base = _free_port_range(3, MAX_WORKER_PORT, (STORE_PORT_OFFSET,))
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        env.pop("XLA_FLAGS", None)
        env.pop("JAX_PLATFORMS", None)
        runs[pkg] = subprocess.Popen(
            [sys.executable, REPLAY, "launch", pkg, str(base), "-w", "-np", "2", "-H",
             f"{host}:4", "-self", host, "-port", str(_free_port()), "-platform", "cpu", "--",
             sys.executable, REPLAY, "worker", pkg, "--schedule", "2:8,3:8,2:100",
             "--total-samples", "2048", "--check-every", "2"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    results = {}
    try:
        for pkg, p in runs.items():
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out[-4000:]
            assert sum("DETACHED:" in line for line in out.splitlines()) == 1, out[-4000:]
            results[pkg] = {json.dumps(json.loads(line.split("REPLAY: ", 1)[1]))
                            for line in out.splitlines() if "REPLAY: " in line}
            assert len(results[pkg]) == 1, out[-4000:]  # both survivors print the same
    finally:
        for p in runs.values():
            if p.poll() is None:
                p.kill()
    ours, theirs = (json.loads(results[pkg].pop()) for pkg in ("torch", "jax"))
    assert [ours[k] for k in ("trained", "resizes", "final_size")] == \
        [theirs[k] for k in ("trained", "resizes", "final_size")] == [2048, 2, 2]
    np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-6)
    np.testing.assert_allclose(ours["w"], theirs["w"], rtol=1e-6)


def test_launcher_resumes_from_checkpoints(tmp_path):
    ckpt = str(tmp_path / "ckpt")

    def launch(total):
        return subprocess.run(
            [sys.executable, "-m", "kungfu_tpu_torch.run", "-np", "1", "-platform", "cpu", "--",
             *FAKE, "--total-samples", str(total), "--checkpoint-dir", ckpt,
             "--checkpoint-every", "5"],
            capture_output=True, text=True, timeout=120, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO))

    r1 = launch(640)
    assert r1.returncode == 0, r1.stdout[-3000:] + r1.stderr[-2000:]
    assert "trained=640 " in r1.stdout
    r2 = launch(1280)
    assert r2.returncode == 0, r2.stdout[-3000:] + r2.stderr[-2000:]
    assert "resumed from checkpoint: step 20, 640 samples" in r2.stdout + r2.stderr
    assert "trained=1280 " in r2.stdout
    assert sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()) == [30, 35, 40]


def test_sigterm_to_watch_launcher_stops_its_workers():
    marker = "987654321"
    args, kw = _watch(2, *FAKE, "--total-samples", marker, "--batch-size", "32",
                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    p = subprocess.Popen(args, **kw)
    up, lines = threading.Event(), []

    def pump():
        for line in p.stdout:
            lines.append(line)
            if sum("peer up" in x for x in lines) >= 2:
                up.set()

    threading.Thread(target=pump, daemon=True).start()
    try:
        assert up.wait(90), "".join(lines)[-3000:]
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=90) == 130
        deadline = time.time() + 30
        while subprocess.run(["pgrep", "-f", f"--total-samples {marker}"],
                             capture_output=True).returncode == 0:
            assert time.time() < deadline, "workers survived the launcher's SIGTERM"
            time.sleep(0.5)
    finally:
        if p.poll() is None:
            p.kill()
        subprocess.run(["pkill", "-9", "-f", f"--total-samples {marker}"], check=False)


def test_run_elastic_refuses_unported_paths(monkeypatch):
    """The monitoring counters (A.8) still raise; the self-healing path's
    variables (KFT_HEAL, KFT_FAULT_PLAN, KFT_PROGRESS_BEACON) are ported."""
    from kungfu_tpu_torch.elastic import trainer as ET

    for name in ("KFT_HEAL", "KFT_FAULT_PLAN", "KFT_PROGRESS_BEACON"):
        with monkeypatch.context() as m:
            m.setenv(name, "1")
            ET._refuse_unported()
    with monkeypatch.context() as m:
        m.setenv("KFT_CONFIG_ENABLE_MONITORING", "1")
        with pytest.raises(NotImplementedError, match="A.8"):
            ET.run_elastic(None, None, None, None, ET.ElasticConfig(1, 1))


# -- one process, no resize, against the JAX package -----------------------------------------

ROWS, DIM, STEPS = 32, 64, 16


def _batches(rank, offset):
    """The fake trainer's batches, centred on 1 instead of 0: `w` then
    moves away from zero, where an elementwise rtol measures the two
    packages' rounding and not the cancellation of values near 0."""
    rng = np.random.RandomState(rank + (offset % 7))
    while True:
        yield (rng.randn(ROWS, DIM) + 1.0).astype(np.float32)


def test_single_process_run_matches_jax(jk, monkeypatch):
    """The JAX side runs on one of this process's virtual devices, as the
    port's single process runs on the CPU."""
    from kungfu_tpu_torch.elastic.trainer import ElasticConfig, run_elastic
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.testing.fake_adaptive_trainer import Bowl, bowl_loss

    for k in [k for k in os.environ if k.startswith("KFT_")]:
        monkeypatch.delenv(k)
    monkeypatch.setattr(peer_mod, "_default_peer", None)
    ours = run_elastic(
        lambda: bowl_loss, lambda: Bowl(DIM),
        lambda axes=None, impl="pmean": synchronous_sgd(
            lambda ps: torch.optim.SGD(ps, lr=0.1), group=axes, impl=impl),
        lambda rank, size, offset: ((torch.from_numpy(x),) for x in _batches(rank, offset)),
        ElasticConfig(total_samples=ROWS * STEPS, batch_size=ROWS), device="cpu")
    peer_mod.finalize_default_peer()
    w = ours["state"].params.w.detach().numpy()

    import optax
    from kungfu_tpu.elastic.trainer import ElasticConfig as JConfig, run_elastic as jrun
    from kungfu_tpu.optimizers import synchronous_sgd as jsgd
    from kungfu_tpu.train import DataParallelTrainer as JTrainer

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])

    def jloss(params, batch):
        x, = batch
        return jnp.mean((params["w"] - jnp.mean(x, axis=0)) ** 2)

    theirs = jrun(lambda: jloss, lambda: {"w": jnp.zeros((DIM,), jnp.float32)},
                  lambda axes="dp", impl="pmean": jsgd(optax.sgd(0.1), axis_name=axes, impl=impl),
                  lambda rank, size, offset: ((x,) for x in _batches(rank, offset)),
                  JConfig(total_samples=ROWS * STEPS, batch_size=ROWS))
    jk.kf.finalize()
    assert theirs["trainer"].world == 1
    assert (ours["trained_samples"], ours["resizes"], ours["final_size"]) == \
        (theirs["trained_samples"], theirs["resizes"], theirs["final_size"]) == (ROWS * STEPS, 0, 1)
    np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-6)
    np.testing.assert_allclose(w, np.asarray(theirs["state"].params["w"]).reshape(DIM),
                               rtol=1e-6)

    # the JAX DataParallelTrainer stepping the same batches
    trainer = JTrainer(jloss, jsgd(optax.sgd(0.1)))
    state = trainer.init({"w": jnp.zeros((DIM,), jnp.float32)})
    batches = _batches(0, 0)
    for _ in range(STEPS):
        state, metrics = trainer.train_step(state, trainer.shard_batch((next(batches),)))
    np.testing.assert_allclose(w, np.asarray(state.params["w"]).reshape(DIM), rtol=1e-6)
    np.testing.assert_allclose(ours["loss"], float(metrics["loss"]), rtol=1e-6)
