"""Ring reduce-scatter, all-gather and all-reduce of the port against the
Pallas ring kernels of the JAX package, bit for bit.

The reference is `kungfu_tpu.ops.pallas_collectives` under the Pallas
interpreter (KFT_PALLAS=interpret), in shard_map over n virtual CPU
devices: the TPU kernels' own bodies (`ring_kernels.make_rs_kernel`,
`make_ag_kernel`).  The port runs twice: its stacked plain versions (every
rank's input in one process, `ops/collective.py`) and its rank-local
wrappers (`ops/ring_collectives.py`) on n gloo ranks in subprocesses.
Payloads are random normal floats of sizes that are not multiples of
n * 1024, so the chunking, the padding and every element's order of adds
must all agree: no tolerance.  The lax ring (impl="ring") is held against
`collective.ring_all_reduce` the same way; rs_ag, whose reduce-scatter is
XLA's psum_scatter in the JAX package, to float rounding (1e-6 relative).
The group wrappers (`ring_reduce_scatter_group`, `ring_all_gather_group`:
many tensors through one ring at 16-byte-rounded offsets) must give every
tensor the bits of its own call and of the Pallas ring on it alone,
integer-valued and random, for groups of one, two and eight tensors of 1
to 4099 values; the grouped DMA pair must give the gathers and gradients
of a pair a tensor.  `segment_plan` splits a group into launches.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_reference import jax_reference
from _torch_ranks import MAX_WORKER_PORT, _free_port_range
from kungfu_tpu_torch.ops import collective as C
from kungfu_tpu_torch.ops import ring_collectives as RC
from kungfu_tpu_torch.tools.ring_check import planted_faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = (2, 3, 4)
DTYPES = ("float32", "bfloat16")
RS_ROW, AG_LEN, AR_LEN = 1500, 1300, 5000  # none a multiple of n * 1024
OPS = ("rs", "ag", "ar_sum", "ar_mean", "lax_ring")


def _inputs(n: int, dtype: str):
    """Every rank's inputs as torch tensors (rank-major), from numpy."""
    rng = np.random.default_rng(100 + n)
    raw = {"rs": rng.standard_normal((n, n, RS_ROW)), "ag": rng.standard_normal((n, AG_LEN)),
           "ar": rng.standard_normal((n, AR_LEN))}
    return {k: torch.from_numpy(v.astype(np.float32)).to(getattr(torch, dtype))
            for k, v in raw.items()}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jax_outputs(n: int, dtype: str):
    """{op: (n, ...) per-rank outputs} of the JAX package's rings."""
    from jax.sharding import Mesh, PartitionSpec as P

    from kungfu_tpu.compat import shard_map
    from kungfu_tpu.ops import collective as JC
    from kungfu_tpu.ops import pallas_collectives as PC

    ins = _inputs(n, dtype)
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(_np(ins[k])).astype(jdt) for k in ("rs", "ag", "ar")]
    args[0] = args[0].reshape(n * n, RS_ROW)

    def body(rs, ag, ar):
        out = {"rs": PC.ring_reduce_scatter(rs, "dp"), "ag": PC.ring_all_gather(ag[0], "dp"),
               "ar_sum": PC.ring_all_reduce(ar[0], "dp"),
               "ar_mean": PC.ring_all_reduce(ar[0], "dp", op="mean"),
               "lax_ring": JC.ring_all_reduce(ar[0], "dp"),
               "rs_ag": JC.rs_ag_all_reduce(ar[0], "dp")}
        return {k: v[None] for k, v in out.items()}

    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"),) * 3, out_specs=P("dp"),
                           check_vma=False))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in fn(*args).items()}


@pytest.fixture(scope="module")
def ref():
    old = os.environ.get("KFT_PALLAS")
    os.environ["KFT_PALLAS"] = "interpret"
    try:
        with jax_reference():
            yield {(n, dt): _jax_outputs(n, dt) for n in NS for dt in DTYPES}
    finally:
        if old is None:
            del os.environ["KFT_PALLAS"]
        else:
            os.environ["KFT_PALLAS"] = old


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.ops import ring_collectives as RC

    n = int(sys.argv[1])
    assert distributed.init_distributed(device="cpu") == n
    d = dist.get_rank()
    data = np.load(sys.argv[2] + ".in.npz")
    out = {}
    for dt in ("float32", "bfloat16"):
        ins = {k: torch.from_numpy(data[f"{dt}/{k}"]).to(getattr(torch, dt))
               for k in ("rs", "ag", "ar")}
        got = {"rs": RC.ring_reduce_scatter(ins["rs"][d]),
               "ag": RC.ring_all_gather(ins["ag"][d]),
               "ar_sum": RC.ring_all_reduce(ins["ar"][d]),
               "ar_mean": RC.ring_all_reduce(ins["ar"][d], op="mean"),
               "lax_ring": C.ring_all_reduce(ins["ar"][d]),
               "rs_ag": C.rs_ag_all_reduce(ins["ar"][d])}
        for k, v in got.items():
            out[f"{dt}/{k}"] = v.float().numpy()
    np.savez(sys.argv[2] + f".{d}.npz", **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{(n, dtype): {op: (n, ...) outputs}} of the rank-local wrappers on n
    gloo ranks, every n at once."""
    tmp = tmp_path_factory.mktemp("ring")
    procs = []
    for n in NS:
        np.savez(tmp / f"n{n}.in.npz", **{f"{dt}/{k}": _np(v) for dt in DTYPES
                                          for k, v in _inputs(n, dt).items()})
        port = _free_port_range(n, MAX_WORKER_PORT, ())
        peers = ",".join(f"127.0.0.1:{port + r}" for r in range(n))
        for r in range(n):
            env = dict(os.environ, KFT_SELF_SPEC=f"127.0.0.1:{port + r}", KFT_INIT_PEERS=peers,
                       PYTHONPATH=REPO, OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(n), str(tmp / f"n{n}")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    results = {}
    for n in NS:
        files = [np.load(tmp / f"n{n}.{r}.npz") for r in range(n)]
        for dt in DTYPES:
            results[(n, dt)] = {k: np.stack([f[f"{dt}/{k}"] for f in files])
                                for k in OPS + ("rs_ag",)}
    return results


def _stacked(n: int, dtype: str):
    ins = _inputs(n, dtype)
    xs = list(ins["ar"])
    return {"rs": C._plain_ring_reduce_scatter(list(ins["rs"])),
            "ag": C._plain_ring_all_gather(list(ins["ag"])),
            "ar_sum": C._plain_ring_all_reduce(xs),
            "ar_mean": C._plain_ring_all_reduce(xs, op="mean")}


@pytest.mark.parametrize("op", OPS[:4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_stacked_plain_matches_pallas(ref, n, dtype, op):
    got = np.stack([_np(t) for t in _stacked(n, dtype)[op]])
    np.testing.assert_array_equal(got, ref[(n, dtype)][op])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_rank_local_rings_match_jax(ref, ranks, n, dtype, op):
    np.testing.assert_array_equal(ranks[(n, dtype)][op], ref[(n, dtype)][op])


@pytest.mark.parametrize("n", NS)
def test_rs_ag_matches_jax_to_rounding(ref, ranks, n):
    want = ref[(n, "float32")]["rs_ag"]
    np.testing.assert_allclose(ranks[(n, "float32")]["rs_ag"], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", NS)
def test_check_rejects_planted_faults(ref, n):
    xs = list(_inputs(n, "float32")["ar"])
    want = ref[(n, "float32")]["ar_sum"][0]
    faults = planted_faults(xs, C._plain_ring_all_reduce(xs)[0])
    assert [name for name, _ in faults] == ["chunk misrouted", "hop left out"]
    for name, got in faults:
        assert not np.array_equal(_np(got), want), name


def test_wrappers_refuse_what_has_no_kernel():
    for dtype in (torch.float16, torch.int32):
        with pytest.raises(NotImplementedError, match="the Session routes other dtypes"):
            RC.ring_all_reduce(torch.zeros(4, dtype=dtype))
    with pytest.raises(NotImplementedError, match="the Session routes other ops"):
        RC.ring_all_reduce(torch.zeros(4), op="max")
    x = torch.arange(6.0)
    assert RC.ring_all_reduce(x) is x  # one rank: the input, no kernel
    assert torch.equal(RC.ring_reduce_scatter(x[None]), x)
    assert torch.equal(RC.ring_all_gather(x), x[None])
    assert RC.RING_RS.launches == RC.RING_AG.launches == 0


# ------------------------------------------------------------ groups --
# A group of tensors through one ring (`ring_*_group`): each tensor's
# chunk at its offset in one concatenated chunk.  Rows below, at and past
# one 16-byte vector and one 1024-value tile, none a multiple of another;
# each leaf its own data.  Groups of one, two and every leaf.

LEAVES = (1, 255, 256, 1000, 4099, 256, 1000, 1)
GROUPS = {"one": (4,), "two": (1, 3), "many": tuple(range(len(LEAVES)))}
VALUES = ("integers", "random")


def _group_inputs(n: int, dtype: str, values: str):
    """Every rank's inputs, rank-major: for leaf i, "rs" (n, n, row) and
    "ag" (n, row); integer-valued (every partial sum exact) or normal."""
    rng = np.random.default_rng(300 + 10 * n + VALUES.index(values))

    def draw(shape):
        raw = rng.integers(-64, 65, shape) if values == "integers" else rng.standard_normal(shape)
        return torch.from_numpy(raw.astype(np.float32)).to(getattr(torch, dtype))

    return {"rs": [draw((n, n, row)) for row in LEAVES], "ag": [draw((n, row)) for row in LEAVES]}


def _jax_group_outputs(n: int, dtype: str, values: str):
    """{(op, leaf): (n, ...) per-rank outputs} of the Pallas rings, one
    call per leaf."""
    from jax.sharding import Mesh, PartitionSpec as P

    from kungfu_tpu.compat import shard_map
    from kungfu_tpu.ops import pallas_collectives as PC

    ins = _group_inputs(n, dtype, values)
    jdt = getattr(jnp, dtype)
    args = ([jnp.asarray(_np(x).reshape(n * n, -1)).astype(jdt) for x in ins["rs"]]
            + [jnp.asarray(_np(x)).astype(jdt) for x in ins["ag"]])
    k = len(LEAVES)

    def body(*xs):
        return ([PC.ring_reduce_scatter(x, "dp")[None] for x in xs[:k]]
                + [PC.ring_all_gather(x[0], "dp")[None] for x in xs[k:]])

    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"),) * (2 * k),
                           out_specs=[P("dp")] * (2 * k), check_vma=False))
    outs = [np.asarray(v.astype(jnp.float32)) for v in fn(*args)]
    return {(op, i): outs[j * k + i] for j, op in enumerate(("rs", "ag")) for i in range(k)}


@pytest.fixture(scope="module")
def group_ref():
    old = os.environ.get("KFT_PALLAS")
    os.environ["KFT_PALLAS"] = "interpret"
    try:
        with jax_reference():
            return {(n, dt, v): _jax_group_outputs(n, dt, v)
                    for n in NS for dt in DTYPES for v in VALUES}
    finally:
        if old is None:
            del os.environ["KFT_PALLAS"]
        else:
            os.environ["KFT_PALLAS"] = old


GROUP_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import ring_collectives as RC

    n, groups = int(sys.argv[1]), eval(sys.argv[3])
    assert distributed.init_distributed(device="cpu") == n
    d = dist.get_rank()
    data = np.load(sys.argv[2] + ".in.npz")
    out = {}
    for key in sorted({k.rsplit("/", 2)[0] for k in data.files}):
        dt = key.split("/")[0]
        leaves = len([k for k in data.files if k.startswith(key + "/rs/")])
        rs = [torch.from_numpy(data[f"{key}/rs/{i}"][d]).to(getattr(torch, dt))
              for i in range(leaves)]
        ag = [torch.from_numpy(data[f"{key}/ag/{i}"][d]).to(getattr(torch, dt))
              for i in range(leaves)]
        for i in range(leaves):
            out[f"{key}/leaf/rs/{i}"] = RC.ring_reduce_scatter(rs[i]).float().numpy()
            out[f"{key}/leaf/ag/{i}"] = RC.ring_all_gather(ag[i]).float().numpy()
        for name, idx in groups.items():
            got_rs = RC.ring_reduce_scatter_group([rs[i] for i in idx])
            got_ag = RC.ring_all_gather_group([ag[i] for i in idx])
            for i, a, b in zip(idx, got_rs, got_ag):
                out[f"{key}/{name}/rs/{i}"] = a.float().numpy()
                out[f"{key}/{name}/ag/{i}"] = b.float().numpy()
        # the grouped DMA pair and a call per leaf, forward and backward;
        # the last output gets no gradient (grouped: zeros reach B5)
        for how in ("group", "leaf"):
            xs = [a.clone().requires_grad_() for a in ag]
            if how == "group":
                fulls = FM.dma_all_gather_group(xs)
            else:
                fulls = [FM.dma_all_gather(x) for x in xs]
            torch.autograd.backward(fulls[:-1], [r.reshape(-1) for r in rs[:-1]])
            for i, (x, f) in enumerate(zip(xs, fulls)):
                out[f"{key}/dma-{how}/full/{i}"] = f.detach().float().numpy()
                grad = x.grad if x.grad is not None else torch.zeros_like(x)
                out[f"{key}/dma-{how}/grad/{i}"] = grad.float().numpy()
    np.savez(sys.argv[2] + f".{d}.npz", **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def group_ranks(tmp_path_factory):
    """{(n, dtype, values): {name: (n, ...) outputs}} of the rank-local
    group wrappers and calls per leaf on n gloo ranks, every n at once."""
    from _torch_ranks import start_ranks, wait_ranks

    tmp = tmp_path_factory.mktemp("ring_groups")
    procs = {}
    for n in NS:
        arrays = {}
        for dt in DTYPES:
            for v in VALUES:
                ins = _group_inputs(n, dt, v)
                for op in ("rs", "ag"):
                    arrays.update({f"{dt}/{v}/{op}/{i}": _np(x) for i, x in enumerate(ins[op])})
        np.savez(tmp / f"n{n}.in.npz", **arrays)
        procs[n] = start_ranks(GROUP_WORKER, n, [n, tmp / f"n{n}", repr(GROUPS)])
    results = {}
    for n, ps in procs.items():
        wait_ranks(ps)
        files = [np.load(tmp / f"n{n}.{r}.npz") for r in range(n)]
        for dt in DTYPES:
            for v in VALUES:
                prefix = f"{dt}/{v}/"
                results[(n, dt, v)] = {k[len(prefix):]: np.stack([f[k] for f in files])
                                       for k in files[0].files if k.startswith(prefix)}
    return results


@pytest.mark.parametrize("op", ("rs", "ag"))
@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_group_matches_calls_per_leaf(group_ranks, n, dtype, values, group, op):
    """A grouped call gives every tensor the bits of its own call."""
    res = group_ranks[(n, dtype, values)]
    for i in GROUPS[group]:
        np.testing.assert_array_equal(res[f"{group}/{op}/{i}"], res[f"leaf/{op}/{i}"],
                                      err_msg=f"leaf {i} ({LEAVES[i]} values)")


@pytest.mark.parametrize("op", ("rs", "ag"))
@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_group_matches_pallas_per_leaf(group_ref, group_ranks, n, dtype, values, group, op):
    """... and the bits of the interpreted Pallas ring on that tensor alone."""
    res, ref = group_ranks[(n, dtype, values)], group_ref[(n, dtype, values)]
    for i in GROUPS[group]:
        np.testing.assert_array_equal(res[f"{group}/{op}/{i}"], ref[(op, i)],
                                      err_msg=f"leaf {i} ({LEAVES[i]} values)")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_dma_group_matches_calls_per_leaf(group_ranks, n, dtype):
    """The grouped DMA pair: the gathers of a call per leaf, and their
    gradients reduce-scattered in one grouped call; an output with no
    gradient reaches it as zeros."""
    res = group_ranks[(n, dtype, "random")]
    for i in range(len(LEAVES)):
        for what in ("full", "grad"):
            np.testing.assert_array_equal(res[f"dma-group/{what}/{i}"],
                                          res[f"dma-leaf/{what}/{i}"], err_msg=f"{what} {i}")
    assert not res[f"dma-group/grad/{len(LEAVES) - 1}"].any()


def _plan(rows, cap, dtypes=None):
    dtypes = dtypes or [torch.float32] * len(rows)
    return RC.segment_plan(list(zip(rows, dtypes)), cap)


@pytest.mark.parametrize("case", ["fits", "cap", "oversize", "table", "dtype", "empty"])
def test_segment_plan(case):
    """Runs of consecutive segments, one launch each: one dtype, at most
    MAX_SEGMENTS, and at most the cap in 16-byte-rounded bytes unless a
    run is one segment."""
    m = RC.MAX_SEGMENTS
    got, want = {
        # 1 + 255 + 256 f32 values round to 16 + 1024 + 1024 bytes
        "fits": (_plan([1, 255, 256], 2064), [(0, 3)]),
        "cap": (_plan([1, 255, 256], 2063), [(0, 2), (2, 3)]),
        "oversize": (_plan([4, 5000, 4, 4], 64), [(0, 1), (1, 2), (2, 4)]),
        "table": (_plan([4] * (m + 1), 1 << 20), [(0, m), (m, m + 1)]),
        "dtype": (_plan([8, 8, 8, 8], 1 << 20, [torch.float32, torch.bfloat16,
                                                torch.bfloat16, torch.float32]),
                  [(0, 1), (1, 3), (3, 4)]),
        "empty": (_plan([], 64), []),
    }[case]
    assert got == want
