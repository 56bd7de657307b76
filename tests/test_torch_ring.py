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
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_reference import jax_reference
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{(n, dtype): {op: (n, ...) outputs}} of the rank-local wrappers on n
    gloo ranks, every n at once."""
    tmp = tmp_path_factory.mktemp("ring")
    procs = []
    for n in NS:
        np.savez(tmp / f"n{n}.in.npz", **{f"{dt}/{k}": _np(v) for dt in DTYPES
                                          for k, v in _inputs(n, dt).items()})
        port = _free_port()
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
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            RC.ring_all_reduce(torch.zeros(4, dtype=dtype))
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        RC.ring_all_reduce(torch.zeros(4), op="max")
    x = torch.arange(6.0)
    assert RC.ring_all_reduce(x) is x  # one rank: the input, no kernel
    assert torch.equal(RC.ring_reduce_scatter(x[None]), x)
    assert torch.equal(RC.ring_all_gather(x), x[None])
    assert RC.RING_RS.launches == RC.RING_AG.launches == 0
