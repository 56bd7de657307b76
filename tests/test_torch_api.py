"""The port's scalar api, torch interop, launcher flags, remote launch and
hierarchical reductions against the JAX package's.

* the api (`kungfu_tpu_torch.init`, `current_rank`, ..., `set_strategy`)
  on 2 and 4 gloo ranks put on the CPU by KFT_PLATFORM=cpu, as the
  launcher's -platform cpu does: identity, the blob store, the MST over
  the measured latencies and its neighbour masks (against the JAX
  functions on the same matrix), the tree and strategy swaps,
  propose_new_size through a config server, the refusals that name A.8;
* `python -m kungfu_tpu_torch.run -np N -platform cpu -- python -m
  kungfu_tpu_torch.torch.check`, the counterpart of
  tests/integration/test_torch.py, and the interop on one process;
* the launcher's -platform and -devices-per-worker (1 only);
* `run/distribute`'s command lines against the JAX module's, the cases
  of tests/unit/test_distribute.py;
* `synchronous_sgd(impl="hierarchical")` and
  `compression.hierarchical_all_reduce` on a ("dcn", "ici") mesh of 2 x 2
  gloo ranks against the JAX package in shard_map over ("dcn", "ici"):
  bit for bit at full precision, to rtol 1e-6 with a quantized leg (the
  peer sums' order, as tests/test_torch_compression.py holds
  compression.all_reduce), except where two quantizers are chained (an
  int8 ici leg, then an fp8 dcn leg, or a step that reduces g + e): there
  a value that the first leg leaves one rounding apart may land on the
  other side of the second leg's code boundary, so at most 0.5% of the
  values may differ by one code step (`_one_code_step`).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import REPO, _free_port_range, start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch.plan import Cluster, HostList
from kungfu_tpu_torch.run import __main__ as cli
from kungfu_tpu_torch.run.distribute import rrun
from kungfu_tpu_torch.run.job import Job
from kungfu_tpu_torch.store import STORE_PORT_OFFSET

BASH = ("bash", "-c")  # a local transport standing in for ssh


@pytest.fixture(scope="module")
def jk():
    with jax_reference() as kf:
        from kungfu_tpu import compression as jc
        from kungfu_tpu import plan as jplan
        from kungfu_tpu.compat import shard_map
        from kungfu_tpu.optimizers.sync import all_reduce_gradients
        from kungfu_tpu.plan import strategy as jstrategy
        from kungfu_tpu.run import distribute as jdist

        yield {"kf": kf, "plan": jplan, "strategy": jstrategy, "dist": jdist, "comp": jc,
               "shard_map": shard_map, "arg": all_reduce_gradients}


# -- the scalar api on gloo ranks ------------------------------------------------------

API_WORKER = textwrap.dedent("""
    import json
    import numpy as np
    import torch
    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch import torch as kt

    peer = kf.init()
    r, n = kf.current_rank(), kf.cluster_size()
    sess = peer.current_session()
    res = {"rank": r, "size": n, "local": [kf.current_local_rank(), kf.current_local_size()],
           "hosts": kf.host_count(), "cluster": [str(w) for w in kf.current_cluster().workers],
           "detached": kf.detached(), "uid": kf.uid(), "device": str(sess.device),
           "strategy": sess.strategy.name, "axes": list(sess.mesh.axis_names)}
    kf.run_barrier()
    kf.save_variable("w", np.full(3, r, np.float32))
    kf.run_barrier()
    res["pulled"] = kf.request_variable((r + 1) % n, "w").tolist()
    lat = torch.tensor(kf.get_peer_latencies(), dtype=torch.float64)
    res["self_latency"] = lat[r].item()
    m = kt.all_gather(lat)  # every rank's row: one matrix on every rank
    res["matrix"] = ((m + m.T) / 2).tolist()
    father = kf.minimum_spanning_tree(res["matrix"])
    res["father"], res["mask"] = father, api.get_neighbour_mask(father)
    kf.set_tree(father)
    res["tree_strategy"] = sess.strategy.name
    kf.set_strategy("ring")
    res["ring_strategy"] = sess.strategy.name
    t = torch.full((4,), float(r + 1))
    res["sum"] = kt.all_reduce(t).tolist()
    res["max"] = kt.all_reduce(t, op="max").tolist()
    res["bcast"] = kt.broadcast(t, root=n - 1).tolist()
    res["gathered"] = kt.all_gather(torch.tensor([float(r)])).flatten().tolist()
    res["interop"] = [kt.rank(), kt.cluster_size()]
    res["stats"] = sorted(kf.calc_stats())
    kf.log_stats()
    kf.set_variable("x", 2.5)
    res["var"] = kf.get_variable("x")
    res["refusals"] = {}
    for name, call in (("egress_rates", kf.egress_rates),
                       ("check_interference", kf.check_interference)):
        try:
            call()
        except NotImplementedError as e:
            res["refusals"][name] = str(e)
    # rank 0 proposes through the config server; a proposal of the current
    # size and any other rank's do nothing
    kf.propose_new_size(len(kf.current_cluster().workers))
    kf.run_barrier()
    res["proposed"] = kf.propose_new_size(n + 1)
    print("API " + json.dumps(res), flush=True)
    kf.finalize()
""")


@pytest.fixture(scope="module")
def api_runs():
    """{n: {rank: its results}} on 2 and 4 ranks, each run beside a config
    server holding a document of n workers; {n: that server's document
    after the run} under the key ("doc", n)."""
    from kungfu_tpu_torch.elastic import ConfigServer

    servers = {n: ConfigServer(port=0, init=Cluster.from_hostlist(HostList.parse("127.0.0.1:8"),
                                                                   n)).start() for n in (2, 4)}
    try:
        procs = {n: start_ranks(API_WORKER, n, [], max_port=30000, offsets=[15000],
                                env={"KFT_PLATFORM": "cpu", "KFT_ALLREDUCE_STRATEGY": "PALLAS_RING",
                                     "KFT_CONFIG_SERVER": servers[n].url})
                 for n in (2, 4)}
        out = {}
        for n, ps in procs.items():
            outs = wait_ranks(ps, timeout=180)
            out[n] = {r: json.loads(next(line[4:] for line in o.splitlines()
                                         if line.startswith("API "))) for r, o in outs.items()}
            out[("doc", n)] = servers[n].state.get()
    finally:
        for srv in servers.values():
            srv.stop()
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_api_identity_and_store(api_runs, n):
    res = api_runs[n]
    for r, got in res.items():
        assert (got["rank"], got["size"], got["local"], got["hosts"]) == (r, n, [r, n], 1)
        assert got["uid"] == r and got["detached"] is False
        assert got["cluster"] == res[0]["cluster"] and len(got["cluster"]) == n
        assert got["device"] == "cpu"  # KFT_PLATFORM=cpu
        assert got["strategy"] == "PALLAS_RING" and got["axes"] == ["dp"]
        assert got["pulled"] == [float((r + 1) % n)] * 3
        assert got["self_latency"] == 0.0
        assert got["var"] == 2.5 and got["interop"] == [r, n]
        assert "all_reduce" in got["stats"] or "all_gather" in got["stats"]


@pytest.mark.parametrize("n", [2, 4])
def test_api_topology_matches_jax(jk, api_runs, n):
    jplan, js = jk["plan"], jk["strategy"]
    res = api_runs[n]
    matrix = res[0]["matrix"]
    father = jplan.minimum_spanning_tree(matrix)
    tree = js.strategy_for_tree(jplan.Graph.from_forest_array(father)).name
    for r, got in res.items():
        assert got["matrix"] == matrix  # one matrix on every rank
        assert got["father"] == father
        assert got["mask"] == jplan.mst_neighbour_mask(father, r)
        assert got["tree_strategy"] == tree and got["ring_strategy"] == "RING"


@pytest.mark.parametrize("n", [2, 4])
def test_api_interop_collectives(api_runs, n):
    for r, got in api_runs[n].items():
        assert got["sum"] == [float(n * (n + 1) // 2)] * 4
        assert got["max"] == [float(n)] * 4
        assert got["bcast"] == [float(n)] * 4
        assert got["gathered"] == [float(k) for k in range(n)]


def test_api_refusals_name_their_items(api_runs):
    refusals = api_runs[2][0]["refusals"]
    assert refusals.keys() == {"egress_rates", "check_interference"}
    assert "A.8" in refusals["egress_rates"] and "A.8" in refusals["check_interference"]


@pytest.mark.parametrize("n", [2, 4])
def test_api_propose_new_size_acts(api_runs, n):
    """Rank 0's proposal of n + 1 workers is the server's one change: the
    same-size proposal and every other rank's did nothing, as in the JAX
    api (which returns None)."""
    cluster, version = api_runs[("doc", n)]
    assert version == 1 and cluster.size() == n + 1
    assert cluster.workers[:n] == Cluster.from_hostlist(HostList.parse("127.0.0.1:8"), n).workers
    assert all(got["proposed"] is None for got in api_runs[n].values())


def test_interop_on_one_process(monkeypatch):
    """A cluster of one: collectives are the identity (copies), as the
    reference at np=1; S-SGD steps without a sync."""
    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch import torch as kt

    monkeypatch.setenv("KFT_PLATFORM", "cpu")  # the launcher's -platform cpu
    kf.init()
    try:
        t = torch.tensor([1.0, 2.0])
        assert torch.equal(kt.all_reduce(t), t) and kt.all_reduce(t) is not t
        assert torch.equal(kt.broadcast(t), t)
        assert kt.all_gather(t).shape == (1, 2)
        model = torch.nn.Linear(4, 1)
        kt.broadcast_parameters(model.state_dict())
        opt = kt.SynchronousSGDOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
        loss = model(torch.ones(2, 4)).sum()
        opt.zero_grad()
        loss.backward()
        opt.step()
        assert opt.param_groups and opt.state_dict() is not None
        assert kf.cluster_size() == 1 and kf.current_rank() == 0
        kf.run_barrier()
    finally:
        kf.finalize()


# -- the launcher -----------------------------------------------------------------------


# The launcher in a process of its own, its workers on ports that are free
# now (and their blob stores' too) instead of the default 10000 and up,
# where another job on the machine may listen.
_LAUNCHER = textwrap.dedent("""
    import functools, sys
    from kungfu_tpu_torch.plan import peer
    from kungfu_tpu_torch.run.__main__ import main

    base = int(sys.argv[1])
    peer.HostList.gen_peer_list = functools.partialmethod(
        peer.HostList.gen_peer_list, port_base=base, port_limit=base + 64)
    sys.exit(main(sys.argv[2:]))
""")


def _launch(np_: int, *args: str, timeout: float = 240):
    """`python -m kungfu_tpu_torch.run -np np_ *args` on free worker ports."""
    base = _free_port_range(np_, 65535 - STORE_PORT_OFFSET, (STORE_PORT_OFFSET,))
    return subprocess.run([sys.executable, "-c", _LAUNCHER, str(base), "-np", str(np_), *args],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("np_", [2, 4])
def test_torch_check_under_launcher(np_):
    out = _launch(np_, "-platform", "cpu", "--", sys.executable, "-m",
                  "kungfu_tpu_torch.torch.check")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    oks = [line for line in out.stdout.splitlines() if "RESULT: torch-check" in line]
    assert len(oks) == np_, out.stdout[-3000:]


def test_platform_and_devices_per_worker():
    with pytest.raises(ValueError, match="one rank with one card"):
        cli.main(["-devices-per-worker", "2", "-np", "1", sys.executable, "-c", "pass"])
    with pytest.raises(ValueError, match="KFT_PLATFORM"):
        cli.main(["-platform", "tpu", "-np", "1", sys.executable, "-c", "pass"])
    from kungfu_tpu_torch.plan import Cluster, Strategy

    cluster = Cluster.from_hostlist(HostList.parse("127.0.0.1:2"), 2)
    job = Job(prog="p", args=[], strategy=Strategy.AUTO, platform="cpu")
    env = job.new_proc(cluster.workers[1], -1, cluster, 0).env
    assert env["KFT_PLATFORM"] == "cpu" and env["KFT_SELF_SPEC"] == "127.0.0.1:10001"
    from kungfu_tpu_torch import env as kfenv

    assert kfenv.platform_device({"KFT_PLATFORM": "cpu"}) == "cpu"
    assert kfenv.platform_device({"KFT_PLATFORM": "gpu"}) is None
    assert kfenv.platform_device({}) is None


# -- run/distribute ---------------------------------------------------------------------


def _dist_runs(mod, capsys):
    """What each case of tests/unit/test_distribute.py sees, run through `mod`."""
    out = {}
    d = mod.Distributor(["h1", "h2", "h3"], transport=BASH)
    out["parallel"] = [(r.host, r.returncode, r.output) for r in d.run("echo from-$KFT_DIST_HOST")]
    out["prefixed"] = sorted(capsys.readouterr().out.splitlines())
    d = mod.Distributor(["a", "b"], transport=BASH, prefix_output=False)
    out["failure"] = {r.host: r.returncode for r in d.run("test $KFT_DIST_HOST = a")}
    d = mod.Distributor(["x"], transport=BASH, prefix_output=False, extra_env={"FOO": "bar baz"})
    out["env"] = d.run("echo FOO=$FOO")[0].output
    out["timeout"] = mod.Distributor(["x"], transport=BASH, prefix_output=False).run(
        "sleep 30", timeout=0.5)[0].returncode
    hl = mod.HostList.parse("10.0.0.1:2,10.0.0.2:2")
    out["rrun"] = [(r.host, r.returncode, r.output) for r in mod.rrun(
        hl, 4, ["python", "train.py"], transport=BASH, python="echo python3")]
    capsys.readouterr()
    out["ssh"] = mod.Distributor(["h"])._command_for("h", "hostname")
    return out


def test_distribute_matches_jax(jk, capsys):
    import kungfu_tpu_torch.run.distribute as ours

    mine, theirs = _dist_runs(ours, capsys), _dist_runs(jk["dist"], capsys)
    # the remote launcher is the port's own module
    theirs["rrun"] = [(h, rc, o.replace("-m kungfu_tpu.run ", "-m kungfu_tpu_torch.run "))
                      for h, rc, o in theirs["rrun"]]
    assert mine == theirs
    assert mine["failure"] == {"a": 0, "b": 1} and mine["timeout"] == 124
    for spec, (host, rc, output) in zip(HostList.parse("10.0.0.1:2,10.0.0.2:2"), mine["rrun"]):
        assert rc == 0 and f"-self {spec.host}" in output and "-np 4" in output
        assert "-m kungfu_tpu_torch.run -np 4 -H 10.0.0.1:2,10.0.0.2:2" in output


def test_rrun_hosts_launch_in_parallel():
    hl = HostList.parse("h1:1,h2:1,h3:1")
    t0 = time.perf_counter()
    results = rrun(hl, 3, ["x"], transport=BASH, python="sleep 1; echo python3")
    assert all(r.returncode == 0 for r in results)
    assert time.perf_counter() - t0 < 2.5  # sequential launches would deadlock a real job


def test_distribute_cli(capsys):
    from kungfu_tpu_torch.run import distribute

    assert distribute.Distributor(["x"]).transport[0] == "ssh"
    with pytest.raises(SystemExit):
        distribute.main(["-H", "h1:1"])  # no command


# -- hierarchical reductions on a (dcn, ici) mesh ------------------------------------------

H_SHAPES = ((37, 11), (1000,), (3, 4, 5))
H_STEPS = 2
H_LEGS = [(None, None), (None, "int8"), ("int8", None), ("int8", "fp8"), ("bf16", "int8")]
H_SYNC = [None, {"dcn": "int8"}, {"ici": "int8", "dcn": "fp8"}]


def _h_inputs():
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((4, 3001)) * rng.uniform(0.1, 5.0, (4, 3001))).astype(np.float32)
    ints = rng.integers(-50, 50, (4, 3001)).astype(np.float32)
    grads = [(rng.standard_normal((4, H_STEPS) + s) * rng.uniform(1e-3, 3.0, (4, H_STEPS) + s)
              ).astype(np.float32) for s in H_SHAPES]
    return x, ints, grads


H_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import compression, distributed
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.plan import make_hierarchical_mesh

    assert distributed.init_distributed(device="cpu") == 4
    mesh = make_hierarchical_mesh(2)
    r = dist.get_rank()
    data = np.load(sys.argv[1])
    legs, syncs, steps = eval(sys.argv[3])
    out = {}
    dcn, ici = mesh.group("dcn"), mesh.group("ici")
    for name in ("x", "ints"):
        x = torch.from_numpy(data[name][r])
        for ic, dc in legs:
            for op in ("sum", "mean", "max"):
                out[f"{name}/{ic}/{dc}/{op}"] = compression.hierarchical_all_reduce(
                    x, ici, dcn, ic, dc, op=op)
    grads = [data[f"g{i}"][r] for i in range(3)]
    for k, comp in enumerate(syncs):
        params = [torch.nn.Parameter(torch.zeros(g.shape[1:])) for g in grads]
        opt = synchronous_sgd(lambda ps: torch.optim.SGD(ps, lr=0.0), group=mesh,
                              impl="hierarchical", compression=comp)(params)
        for t in range(steps):
            for p, g in zip(params, grads):
                p.grad = torch.from_numpy(g[t].copy())
            opt.step()
            for i, p in enumerate(params):
                out[f"sync/{k}/{t}/{i}"] = p.grad
    try:
        synchronous_sgd(lambda ps: torch.optim.SGD(ps, lr=0.0), impl="hierarchical")
    except ValueError as e:
        out["refused"] = np.array(str(e))
    np.savez(sys.argv[2] + f".{r}.npz", **{k: np.asarray(v) for k, v in out.items()})
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def h_gloo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hier")
    x, ints, grads = _h_inputs()
    np.savez(tmp / "in.npz", x=x, ints=ints, **{f"g{i}": g for i, g in enumerate(grads)})
    wait_ranks(start_ranks(H_WORKER, 4, [tmp / "in.npz", tmp / "out",
                                         repr((H_LEGS, H_SYNC, H_STEPS))]), timeout=180)
    files = [np.load(tmp / f"out.{r}.npz") for r in range(4)]
    return {k: np.stack([f[k] for f in files]) for k in files[0].files}


def _h_mesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))


@pytest.fixture(scope="module")
def h_jax(jk):
    from jax.sharding import PartitionSpec as P

    jc, shard_map, arg = jk["comp"], jk["shard_map"], jk["arg"]
    mesh, spec = _h_mesh(), P(("dcn", "ici"))
    x, ints, grads = _h_inputs()
    out = {}
    for name, v in (("x", x), ("ints", ints)):
        for ic, dc in H_LEGS:
            for op in ("sum", "mean", "max"):
                fn = jax.jit(shard_map(
                    lambda a: jc.hierarchical_all_reduce(a[0], "ici", "dcn", ic, dc, op=op)[None],
                    mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False))
                out[f"{name}/{ic}/{dc}/{op}"] = np.asarray(fn(jnp.asarray(v)))
    for k, comp in enumerate(H_SYNC):
        tx = arg(("dcn", "ici"), impl="hierarchical", compression=comp)

        def body(gs, state):
            reduced, state = tx.update([g[0] for g in gs], jax.tree.map(lambda s: s[0], state))
            return [g[None] for g in reduced], jax.tree.map(lambda s: s[None], state)

        step = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=(spec, spec), check_vma=False))
        state = tx.init([jnp.asarray(g[0, 0]) for g in grads])
        state = jax.tree.map(lambda s: jnp.stack([s] * 4), state)
        for t in range(H_STEPS):
            reduced, state = step([jnp.asarray(g[:, t]) for g in grads], state)
            for i, g in enumerate(reduced):
                out[f"sync/{k}/{t}/{i}"] = np.asarray(g)
    return out


def _one_code_step(got, want, err_msg=""):
    """Within rtol 1e-6, but for at most 0.5% of the values, each of which
    is at most one code step apart: an fp8 code's (1/7 of the value, at
    the top of a binade) or an int8 code's of the largest block (absmax /
    127, twice over the two ranks the dcn leg sums)."""
    off = ~np.isclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert off.mean() <= 0.005, (err_msg, off.sum())
    step = np.maximum(np.abs(want) / 7, 2 * np.abs(want).max() / 127)
    assert (np.abs(got - want)[off] <= step[off]).all(), err_msg


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("legs", H_LEGS, ids=str)
@pytest.mark.parametrize("name", ["x", "ints"])
def test_hierarchical_all_reduce_matches_jax(h_jax, h_gloo, name, legs, op):
    key = f"{name}/{legs[0]}/{legs[1]}/{op}"
    got, want = h_gloo[key], h_jax[key]
    if legs == (None, None) or op == "max":
        np.testing.assert_array_equal(got, want)  # full precision: sums of 2 and 2, exact
    elif legs == ("int8", "fp8"):
        _one_code_step(got, want, key)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("k", range(len(H_SYNC)), ids=[str(c) for c in H_SYNC])
def test_hierarchical_sync_matches_jax(h_jax, h_gloo, k):
    for t in range(H_STEPS):
        for i in range(len(H_SHAPES)):
            key = f"sync/{k}/{t}/{i}"
            got, want = h_gloo[key], h_jax[key]
            if H_SYNC[k] is None:
                np.testing.assert_array_equal(got, want, err_msg=key)
            elif t == 0 and len(H_SYNC[k]) == 1:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                           err_msg=key)
            else:  # step 2 reduces g + e: a residual not carried changes most codes
                _one_code_step(got, want, key)


def test_hierarchical_sync_needs_the_mesh(h_gloo):
    assert all("('dcn', 'ici') mesh" in str(e) for e in h_gloo["refused"])
