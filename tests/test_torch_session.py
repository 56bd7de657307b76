"""The port's Session against the JAX package's, case by case as
tests/unit/test_collective.py holds the JAX one.

The JAX Session runs over 4 of the virtual CPU devices, its Pallas ring
strategies on the interpreted kernels (KFT_PALLAS=interpret); the port's
over 4 gloo ranks (tests/_torch_ranks.py), each started as a `peer.Peer`
on the CPU, whose Session takes this rank's tensor and returns this
rank's result: rank r's output is compared with row r of the JAX output.

Tolerances: bit for bit on integer-valued f32 (every strategy, every op;
prod on values whose products are exact), on the fused int8/fp8 ring
(its plain version against the interpreted B7/B8), on the groups and on
every other collective; bf16 to the JAX suite's rtol 2e-2 of the f32 sum;
a quantized wire off the Pallas ring (compression.all_reduce, the
hierarchical compressed legs) to rtol 1e-6 as
tests/test_torch_compression.py holds compression.all_reduce.

The hierarchical cases run 2 "hosts" (127.0.0.1 and 127.0.0.2) of 2
ranks, whose Peer builds the ("dcn", "ici") mesh, against the JAX
Session on `make_hierarchical_mesh(2)`.  The route table (session.py) is
held by `Session.route` and by the spans' `collective_impl`.
"""
from __future__ import annotations

import os
import textwrap

import numpy as np
import pytest
import torch

import jax

from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch.plan import Strategy, make_mesh
from kungfu_tpu_torch.session import OpStats, Session

N = 4
STRATEGIES = [s.name for s in Strategy]  # AUTO included
OP_STRATEGIES = ("STAR", "RING", "CLIQUE", "PALLAS_RING")  # every route of the ops
OPS = ("sum", "mean", "max", "min", "prod")
PALLAS = ("PALLAS_RING", "PALLAS_RING_FUSED", "PALLAS_FUSED_MATMUL")
GROUP_STRATEGIES = ("AUTO", "RING", "CLIQUE", "PALLAS_RING")
BUCKET = 64  # bytes: the group's four tensors in three buckets
SCHEMES = ("int8", "fp8")


def _inputs():
    rng = np.random.RandomState(0)
    return {
        "ints": rng.randint(-40, 40, (N, 1037)).astype(np.float32),  # odd, chunked
        "small": rng.randint(-3, 4, (N, 1037)).astype(np.float32),  # exact products
        "odd": rng.randint(-40, 40, (N, 13)).astype(np.float32),
        "twod": rng.randint(-40, 40, (N, 3, 7)).astype(np.float32),
        "normal": (rng.randn(N, 3000) * rng.uniform(0.1, 4.0, (N, 3000))).astype(np.float32),
        "g0": rng.randint(-9, 9, (N, 5)).astype(np.float32),
        "g1": rng.randint(-9, 9, (N, 3, 4)).astype(np.float32),
        "g2": rng.randint(0, 100, (N, 7)).astype(np.int32),
        "g3": rng.randint(-9, 9, (N,)).astype(np.float32)[:, None],
        "agree": np.tile(np.arange(4, dtype=np.float32), (N, 1)),
        "hier": rng.randint(-40, 40, (N, 11)).astype(np.float32),
    }


def _group(inputs):
    """The mixed list of tests/unit/test_collective.py's fused group test:
    f32, f64 (f32 in the JAX package, whose x64 is off), int32, f32."""
    return [inputs["g0"], inputs["g1"].astype(np.float64), inputs["g2"], inputs["g3"]]


def _disagree(inputs):
    x = inputs["agree"].copy()
    x[3, 0] = 99.0
    return x


def _neg_zero_root(inputs):
    x = inputs["agree"].copy()
    x[0, 0] = -0.0
    x[1:, 0] = 5.0
    return x


@pytest.fixture(scope="module")
def want():
    """Every case of the JAX Session, {case: stacked numpy result}."""
    old = os.environ.get("KFT_PALLAS")
    os.environ["KFT_PALLAS"] = "interpret"
    try:
        with jax_reference():
            from kungfu_tpu.plan import Strategy as JS, make_hierarchical_mesh
            from kungfu_tpu.plan import make_mesh as jax_make_mesh
            from kungfu_tpu.session import Session as JaxSession

            yield _jax_cases(JaxSession, JS, jax_make_mesh, make_hierarchical_mesh)
    finally:
        if old is None:
            del os.environ["KFT_PALLAS"]
        else:
            os.environ["KFT_PALLAS"] = old


def _jax_cases(JaxSession, JS, jax_make_mesh, make_hierarchical_mesh):
    inputs = _inputs()
    s = JaxSession(jax_make_mesh(dp=N, devices=jax.devices()[:N]))
    a = lambda v: np.asarray(v)  # noqa: E731
    out = {}
    for st in STRATEGIES:
        out[f"sum/{st}"] = a(s.all_reduce(inputs["ints"], strategy=JS[st]))
    for st in OP_STRATEGIES:
        for op in OPS:
            x = inputs["small" if op == "prod" else "ints"]
            out[f"op/{st}/{op}"] = a(s.all_reduce(x, op=op, strategy=JS[st]))
    for st in ("AUTO", "RING", "PALLAS_RING"):
        out[f"odd/{st}"] = a(s.all_reduce(inputs["odd"], strategy=JS[st]))
        out[f"2d/{st}"] = a(s.all_reduce(inputs["twod"], strategy=JS[st]))
    for st in ("AUTO", "PALLAS_RING"):
        bf = jax.numpy.asarray(inputs["normal"], dtype=jax.numpy.bfloat16)
        out[f"bf16/{st}"] = a(s.all_reduce(bf, strategy=JS[st]).astype(jax.numpy.float32))
    for scheme in SCHEMES:
        for op in ("sum", "mean"):
            out[f"fused/{scheme}/{op}"] = a(s.all_reduce(
                inputs["normal"], op=op, strategy=JS.PALLAS_RING_FUSED, compression=scheme))
    out["compressed/int8"] = a(s.all_reduce(inputs["normal"], strategy=JS.STAR,
                                            compression="int8"))
    xs = _group(inputs)
    for st in GROUP_STRATEGIES:
        for mode, kw in (("fused", {}), ("unfused", {"fuse": False}),
                         ("bucketed", {"bucket_bytes": BUCKET})):
            for i, o in enumerate(s.group_all_reduce(xs, strategy=JS[st], **kw)):
                out[f"group/{st}/{mode}/{i}"] = a(o)
    for i, o in enumerate(s.group_all_reduce(xs[:2], op="max")):
        out[f"group/max/{i}"] = a(o)
    for root in (0, 3):
        out[f"broadcast/{root}"] = a(s.broadcast(inputs["normal"], root=root))
    out["broadcast/neg_zero"] = a(s.broadcast(_neg_zero_root(inputs), root=0))
    out["reduce"] = a(s.reduce(inputs["ints"], root=2))
    out["reduce/max"] = a(s.reduce(inputs["ints"], root=1, op="max"))
    out["all_gather"] = a(s.all_gather(inputs["twod"]))
    out["gather"] = a(s.gather(inputs["odd"], root=2))
    out["cross/identity"] = a(s.cross_all_reduce(inputs["ints"]))
    s.barrier()
    out["consensus/agree"] = np.array(s.consensus(inputs["agree"]))
    out["consensus/disagree"] = np.array(s.consensus(_disagree(inputs)))
    out["consensus/int"] = np.array(s.consensus(np.ones((N, 2), np.int32)))
    bools = np.ones((N, 3), bool)
    out["consensus/bool"] = np.array(s.consensus(bools))
    bools[2, 1] = False
    out["consensus/bool_disagree"] = np.array(s.consensus(bools))
    out["tree"] = a(s.all_reduce(inputs["ints"], tree=[0] * N))
    s.set_compression("int8")
    s.set_strategy(JS.PALLAS_RING_FUSED)
    out["installed"] = a(s.all_reduce(inputs["normal"]))
    s.set_compression(None)
    s.set_strategy(JS.AUTO)
    try:
        JaxSession(jax_make_mesh(dp=N, devices=jax.devices()[:N]),
                   host_count=4).cross_all_reduce(inputs["ints"])
    except ValueError as e:
        out["cross/refused"] = np.array(str(e))
    h = JaxSession(make_hierarchical_mesh(2, devices=jax.devices()[:N]),
                   strategy=JS.BINARY_TREE_STAR, host_count=2)
    for op in ("sum", "mean", "max"):
        out[f"hier/{op}"] = a(h.all_reduce(inputs["hier"], op=op))
    out["hier/cross"] = a(h.cross_all_reduce(inputs["hier"]))
    out["hier/cross_max"] = a(h.cross_all_reduce(inputs["hier"], op="max"))
    out["hier/int8"] = a(h.all_reduce(inputs["normal"], compression="int8"))
    out["hier/legs"] = a(h.all_reduce(inputs["normal"], compression={"ici": "int8",
                                                                      "dcn": "fp8"}))
    out["hier/strategy/BINARY_TREE_STAR"] = a(h.all_reduce(inputs["ints"]))
    return out


WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from kungfu_tpu_torch.peer import Peer
    from kungfu_tpu_torch.plan import Strategy
    from kungfu_tpu_torch.utils import trace as T

    p = Peer(device="cpu").start()
    s = p.current_session()
    r = p.rank
    data = np.load(sys.argv[1])
    t = lambda k: torch.from_numpy(data[k][r].copy())
    out = {}
    for st in Strategy:
        out[f"sum/{st.name}"] = s.all_reduce(t("ints"), strategy=st)
    for st in ("STAR", "RING", "CLIQUE", "PALLAS_RING"):
        for op in ("sum", "mean", "max", "min", "prod"):
            x = t("small" if op == "prod" else "ints")
            out[f"op/{st}/{op}"] = s.all_reduce(x, op=op, strategy=Strategy[st])
    for st in ("AUTO", "RING", "PALLAS_RING"):
        out[f"odd/{st}"] = s.all_reduce(t("odd"), strategy=Strategy[st])
        out[f"2d/{st}"] = s.all_reduce(t("twod"), strategy=Strategy[st])
    for st in ("AUTO", "PALLAS_RING"):
        out[f"bf16/{st}"] = s.all_reduce(t("normal").bfloat16(), strategy=Strategy[st]).float()
    for scheme in ("int8", "fp8"):
        for op in ("sum", "mean"):
            out[f"fused/{scheme}/{op}"] = s.all_reduce(
                t("normal"), op=op, strategy=Strategy.PALLAS_RING_FUSED, compression=scheme)
    out["compressed/int8"] = s.all_reduce(t("normal"), strategy=Strategy.STAR,
                                          compression="int8")
    xs = [t("g0"), t("g1").double(), t("g2"), t("g3")]
    for st in ("AUTO", "RING", "CLIQUE", "PALLAS_RING"):
        for mode, kw in (("fused", {}), ("unfused", {"fuse": False}),
                         ("bucketed", {"bucket_bytes": int(sys.argv[3])})):
            for i, o in enumerate(s.group_all_reduce(xs, strategy=Strategy[st], **kw)):
                out[f"group/{st}/{mode}/{i}"] = o
    for i, o in enumerate(s.group_all_reduce(xs[:2], op="max")):
        out[f"group/max/{i}"] = o
    for root in (0, 3):
        out[f"broadcast/{root}"] = s.broadcast(t("normal"), root=root)
    out["broadcast/neg_zero"] = s.broadcast(t("neg_zero"), root=0)
    out["reduce"] = s.reduce(t("ints"), root=2)
    out["reduce/max"] = s.reduce(t("ints"), root=1, op="max")
    out["all_gather"] = s.all_gather(t("twod"))
    out["gather"] = s.gather(t("odd"), root=2)
    out["cross/identity"] = s.cross_all_reduce(t("ints"))
    s.barrier()
    out["consensus/agree"] = np.array(s.consensus(t("agree")))
    out["consensus/disagree"] = np.array(s.consensus(t("disagree")))
    out["consensus/int"] = np.array(s.consensus(torch.ones(2, dtype=torch.int32)))
    bools = torch.ones(3, dtype=torch.bool)
    out["consensus/bool"] = np.array(s.consensus(bools))
    bools[1] = r != 2
    out["consensus/bool_disagree"] = np.array(s.consensus(bools))
    # the per-op tree leaves the installed strategy alone
    default = s.strategy
    out["tree"] = s.all_reduce(t("ints"), tree=[0] * p.size)
    out["tree/kept"] = np.array(s.strategy is default)
    # the installed wire and strategy, then back
    s.set_compression("int8")
    s.set_strategy(Strategy.PALLAS_RING_FUSED)
    out["installed"] = s.all_reduce(t("normal"))
    out["installed/route"] = np.array(s.route(t("normal")))
    out["installed/explicit"] = s.all_reduce(t("normal"), compression="none")
    s.set_compression({"dcn": "int8"})  # kept per leg; on a flat single-host mesh a
    out["installed/legs"] = np.array(s.compression.describe())  # call takes the ici leg
    out["installed/legs/route"] = np.array(s.route(t("normal")))
    s.set_compression(None)
    s.set_strategy(Strategy.AUTO)
    # the route table on this rank's tensors, and the spans' tags
    routes = {}
    for st in ("PALLAS_RING", "PALLAS_RING_FUSED", "PALLAS_FUSED_MATMUL", "RING", "CLIQUE",
               "STAR", "BINARY_TREE_STAR"):
        for dtype in ("float32", "bfloat16", "int32", "float64"):
            x = torch.ones(8, dtype=getattr(torch, dtype))
            for op in ("sum", "mean", "max", "min", "prod"):
                routes[f"{st}/{dtype}/{op}"] = s.route(x, op, Strategy[st])
        for scheme in ("int8", "fp8", "bf16", "int8-sr"):
            routes[f"{st}/float32/sum/{scheme}"] = s.route(torch.ones(8), "sum", Strategy[st],
                                                           scheme)
    T.global_trace_buffer().clear()
    s.all_reduce(t("ints"), strategy=Strategy.PALLAS_RING, name="kernels")
    s.all_reduce(t("ints"), op="max", strategy=Strategy.PALLAS_RING, name="one-shot")
    s.all_reduce(t("normal"), strategy=Strategy.PALLAS_RING_FUSED, compression="int8",
                 name="fused")
    s.group_all_reduce([t("g0"), t("g2")], strategy=Strategy.PALLAS_RING, name="group")
    spans = {sp.name: sp.args for sp in T.global_trace_buffer().spans()
             if sp.cat == "collective"}
    # stats: the first call of a name is left out
    s.stats.reset()
    s.all_reduce(t("ints"), name="grad0")
    first = "grad0" in s.calc_stats()
    s.all_reduce(t("ints"), name="grad0")
    out["stats"] = np.array([first, "grad0" in s.calc_stats(), s.throughput() > 0])
    json.dump({"routes": routes, "spans": spans}, open(sys.argv[2] + f".{r}.json", "w"))
    np.savez(sys.argv[2] + f".{r}.npz", **{k: np.asarray(v) for k, v in out.items()})
    p.close()
""")

HIER_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from kungfu_tpu_torch.peer import Peer
    from kungfu_tpu_torch.plan import Strategy

    p = Peer(device="cpu").start()  # two hosts of two ranks: the (dcn, ici) mesh
    s = p.current_session()
    r = p.rank
    data = np.load(sys.argv[1])
    t = lambda k: torch.from_numpy(data[k][r].copy())
    out = {"axes": np.array(s.mesh.axis_names), "strategy": np.array(s.strategy.name),
           "route": np.array(s.route(t("hier"))),
           "route/int8": np.array(s.route(t("normal"), compression="int8"))}
    for op in ("sum", "mean", "max"):
        out[f"hier/{op}"] = s.all_reduce(t("hier"), op=op)
    out["hier/cross"] = s.cross_all_reduce(t("hier"))
    out["hier/cross_max"] = s.cross_all_reduce(t("hier"), op="max")
    out["hier/int8"] = s.all_reduce(t("normal"), compression="int8")
    out["hier/legs"] = s.all_reduce(t("normal"), compression={"ici": "int8", "dcn": "fp8"})
    out["hier/strategy/BINARY_TREE_STAR"] = s.all_reduce(t("ints"))
    np.savez(sys.argv[2] + f".{r}.npz", **{k: np.asarray(v) for k, v in out.items()})
    p.close()
""")


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """({case: stacked result of the 4 ranks}, {rank: routes and spans})."""
    import json

    tmp = tmp_path_factory.mktemp("session")
    inputs = _inputs()
    inputs["disagree"] = _disagree(inputs)
    inputs["neg_zero"] = _neg_zero_root(inputs)
    np.savez(tmp / "in.npz", **inputs)
    env = {"KFT_CONFIG_ENABLE_TRACE": "1"}
    flat = start_ranks(WORKER, N, [tmp / "in.npz", tmp / "flat", BUCKET], max_port=30000,
                       offsets=[15000], env=env)
    hier = start_ranks(HIER_WORKER, N, [tmp / "in.npz", tmp / "hier"], max_port=30000,
                       offsets=[15000], hosts=["127.0.0.1"] * 2 + ["127.0.0.2"] * 2)
    wait_ranks(flat, timeout=240)
    wait_ranks(hier, timeout=240)
    got = {}
    for name in ("flat", "hier"):
        files = [np.load(tmp / f"{name}.{r}.npz") for r in range(N)]
        got.update({k: np.stack([f[k] for f in files]) for k in files[0].files})
    meta = {r: json.load(open(tmp / f"flat.{r}.json")) for r in range(N)}
    return got, meta


# -- all_reduce ------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sum_all_strategies(want, gloo, strategy):
    got = gloo[0][f"sum/{strategy}"]
    np.testing.assert_array_equal(got, want[f"sum/{strategy}"])
    np.testing.assert_array_equal(got[0], _inputs()["ints"].sum(axis=0))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("strategy", OP_STRATEGIES)
def test_ops(want, gloo, strategy, op):
    np.testing.assert_array_equal(gloo[0][f"op/{strategy}/{op}"], want[f"op/{strategy}/{op}"])


@pytest.mark.parametrize("case", ["odd", "2d"])
@pytest.mark.parametrize("strategy", ["AUTO", "RING", "PALLAS_RING"])
def test_odd_sizes_and_2d(want, gloo, case, strategy):
    got = gloo[0][f"{case}/{strategy}"]
    np.testing.assert_array_equal(got, want[f"{case}/{strategy}"])
    assert got.shape == want[f"{case}/{strategy}"].shape


@pytest.mark.parametrize("strategy", ["AUTO", "PALLAS_RING"])
def test_bf16(want, gloo, strategy):
    got = gloo[0][f"bf16/{strategy}"]
    np.testing.assert_allclose(got, want[f"bf16/{strategy}"], rtol=2e-2, atol=2e-2)
    exact = _inputs()["normal"].sum(axis=0)
    np.testing.assert_allclose(got[0], exact, rtol=2e-2, atol=2e-2 * np.abs(exact).max())


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_fused_wire_matches_interpreted_kernels(want, gloo, scheme, op):
    """PALLAS_RING_FUSED with an int8/fp8 wire: the plain version of B7/B8
    against the interpreted Pallas kernels, bit for bit."""
    np.testing.assert_array_equal(gloo[0][f"fused/{scheme}/{op}"], want[f"fused/{scheme}/{op}"])


def test_compressed_wire_off_the_ring(want, gloo):
    w = want["compressed/int8"]
    np.testing.assert_allclose(gloo[0]["compressed/int8"], w, rtol=1e-6,
                               atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("mode", ["fused", "unfused", "bucketed"])
@pytest.mark.parametrize("strategy", GROUP_STRATEGIES)
def test_group(want, gloo, strategy, mode):
    """Fused (one grouped call a dtype), per-tensor and bucketed, mixed
    dtypes and shapes, against the JAX Session (whose f64 is f32) and each
    other, bit for bit."""
    for i, x in enumerate(_group(_inputs())):
        got = gloo[0][f"group/{strategy}/{mode}/{i}"]
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got.astype(np.float64),
                                      want[f"group/{strategy}/{mode}/{i}"].astype(np.float64))
        np.testing.assert_array_equal(got, gloo[0][f"group/{strategy}/unfused/{i}"])


def test_group_max(want, gloo):
    for i in range(2):
        np.testing.assert_array_equal(gloo[0][f"group/max/{i}"].astype(np.float32),
                                      want[f"group/max/{i}"])


# -- the other collectives -------------------------------------------------------------


@pytest.mark.parametrize("root", [0, 3])
def test_broadcast(want, gloo, root):
    np.testing.assert_array_equal(gloo[0][f"broadcast/{root}"], want[f"broadcast/{root}"])


def test_broadcast_of_a_negative_zero_matches_the_mask_and_sum(want, gloo):
    """The JAX broadcast is psum(where(idx == root, x, 0)): a root's -0.0
    arrives as +0.0 on every rank.  The port matches it (root's tensor
    plus zero), bit for bit, signs included."""
    got, w = gloo[0]["broadcast/neg_zero"], want["broadcast/neg_zero"]
    assert not np.signbit(w[:, 0]).any() and not np.signbit(got[:, 0]).any()
    np.testing.assert_array_equal(got.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("case", ["reduce", "reduce/max", "all_gather", "gather",
                                  "cross/identity"])
def test_other_collectives(want, gloo, case):
    got = gloo[0][case]
    assert got.shape == want[case].shape
    np.testing.assert_array_equal(got, want[case])


@pytest.mark.parametrize("case", ["agree", "disagree", "int", "bool", "bool_disagree"])
def test_consensus(want, gloo, case):
    got = gloo[0][f"consensus/{case}"]
    assert (got == want[f"consensus/{case}"]).all()  # every rank agrees with the JAX answer


def test_cross_all_reduce_multi_host_flat_mesh_refused(want):
    assert "ici×dcn" in str(want["cross/refused"])
    sess = Session(make_mesh(dp=-1), host_count=4, device="cpu")
    with pytest.raises(ValueError, match="ici×dcn"):
        sess.cross_all_reduce(torch.zeros(3))
    one = Session(make_mesh(dp=-1), device="cpu")  # one host: the identity
    x = torch.arange(3.0)
    assert one.cross_all_reduce(x) is x


# -- the hierarchical mesh -------------------------------------------------------------


def test_hierarchical_session_from_the_peer(gloo):
    got = gloo[0]
    assert (got["axes"] == ["dcn", "ici"]).all()
    assert (got["strategy"] == "BINARY_TREE_STAR").all()
    assert (got["route"] == "hierarchical").all()
    assert (got["route/int8"] == "compressed_hierarchical").all()


@pytest.mark.parametrize("case", ["hier/sum", "hier/mean", "hier/max", "hier/cross",
                                  "hier/cross_max", "hier/strategy/BINARY_TREE_STAR"])
def test_hierarchical(want, gloo, case):
    np.testing.assert_array_equal(gloo[0][case], want[case])


@pytest.mark.parametrize("case", ["hier/int8", "hier/legs"])
def test_hierarchical_compressed(want, gloo, case):
    w = want[case]
    np.testing.assert_allclose(gloo[0][case], w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


# -- mechanics -------------------------------------------------------------------------


def test_per_op_tree(want, gloo):
    got = gloo[0]
    np.testing.assert_array_equal(got["tree"], want["tree"])
    assert got["tree/kept"].all()


def test_installed_wire_and_strategy(want, gloo):
    got = gloo[0]
    np.testing.assert_array_equal(got["installed"], want["installed"])
    assert (got["installed/route"] == "fused_ring_kernels_plain").all()
    # compression="none" on the call overrides the installed int8: B5/B6's plain ring
    np.testing.assert_allclose(got["installed/explicit"][0], _inputs()["normal"].sum(axis=0),
                               rtol=1e-5, atol=1e-5)
    assert (got["installed/legs"] == "dcn=int8(block=256)").all()
    assert (got["installed/legs/route"] == "ring_kernels_plain").all()


def test_stats(gloo):
    assert (gloo[0]["stats"] == [False, True, True]).all()
    s = OpStats()
    s.record("a", 100, 1.0)  # warm-up call: left out
    s.record("a", 100, 0.5)
    assert s.throughput("a") == 200.0 and s.throughput() == 200.0


def test_every_kernel_sum_or_mean_goes_to_b5_b6(gloo):
    """Under the Pallas strategies an f32/bf16 sum or mean is routed to
    the ring kernels (on a CPU tensor their plain versions: the tag says
    so), an int8/fp8 wire on PALLAS_RING_FUSED to B7/B8; max, min and
    prod to the one-shot, another dtype's sum to the ring of
    ops/collective.py; a stochastic wire to compression.all_reduce."""
    routes = gloo[1][0]["routes"]
    assert all(m["routes"] == routes for m in gloo[1].values())
    for st in PALLAS:
        for dtype in ("float32", "bfloat16"):
            for op in ("sum", "mean"):
                assert routes[f"{st}/{dtype}/{op}"] == "ring_kernels_plain"
        for dtype in ("int32", "float64"):
            for op in ("sum", "mean"):
                assert routes[f"{st}/{dtype}/{op}"] == "ring"
        for dtype in ("float32", "bfloat16", "int32", "float64"):
            for op in ("max", "min", "prod"):
                assert routes[f"{st}/{dtype}/{op}"] == "one_shot"
        assert routes[f"{st}/float32/sum/int8"] == "fused_ring_kernels_plain"
        assert routes[f"{st}/float32/sum/fp8"] == "fused_ring_kernels_plain"
        assert routes[f"{st}/float32/sum/bf16"] == "ring_kernels_plain"
        assert routes[f"{st}/float32/sum/int8-sr"] == "compressed"
    assert routes["RING/float32/sum"] == "ring" and routes["RING/float32/max"] == "one_shot"
    assert routes["CLIQUE/float32/sum"] == "rs_ag" and routes["CLIQUE/float32/mean"] == "one_shot"
    assert routes["STAR/float32/sum"] == routes["BINARY_TREE_STAR/float32/sum"] == "one_shot"
    assert routes["STAR/float32/sum/int8"] == "compressed"


def test_spans_name_the_route(gloo):
    spans = gloo[1][0]["spans"]
    assert spans["collective:kernels"]["collective_impl"] == "ring_kernels_plain"
    assert spans["collective:one-shot"]["collective_impl"] == "one_shot"
    fused = spans["collective:fused"]
    assert fused["collective_impl"] == "fused_ring_kernels_plain"
    assert fused["compression"] == "int8(block=256)" and fused["impl"] == "PALLAS_RING_FUSED"
    assert spans["collective:group"]["collective_impl"] == ["ring", "ring_kernels_plain"]
    for key in ("kind", "op", "impl", "strategy", "bytes", "dtype", "t_arrive"):
        assert key in spans["collective:kernels"]


def test_session_refusals():
    with pytest.raises(NotImplementedError, match="A.8"):
        Session(make_mesh(dp=-1), analyze=True, device="cpu")
    s = Session(make_mesh(dp=-1), device="cpu")
    with pytest.raises(NotImplementedError, match="A.8"):
        s.program_for()
    with pytest.raises(ValueError, match="unknown reduce op"):
        s.all_reduce(torch.ones(2), op="avg")
    assert s.size == 1 and torch.equal(s.all_reduce(torch.ones(2)), torch.ones(2))
