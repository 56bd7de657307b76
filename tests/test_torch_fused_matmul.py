"""The port's all-gather-matmul (B9), matmul-reduce-scatter (B10) and DMA
gather/scatter pair against the JAX package's, on the CPU.

The reference is `kungfu_tpu.ops.fused_matmul` under the Pallas
interpreter (KFT_PALLAS=interpret) in shard_map over n virtual CPU
devices: `ring_kernels.make_ag_matmul_kernel` and `make_matmul_rs_kernel`
run their own bodies, the pair rides the interpreted ring kernels.  The
port runs twice: its stacked plain versions (every rank's operands in one
process, which the card checks hold the kernels against) and its
rank-local functions on n gloo ranks in subprocesses (the shards gathered,
or the partials reduce-scattered, by the plain ring).  n = 2, 3, 4, at the
JAX tests' shapes that tile nothing (B9 x [24, n*40] @ shards [40, 72];
B10 x [24, 40] @ [40, 72]; every rank's operands its own).

Tolerances: integer-valued f32 and bf16 operands make every product and
partial exact in f32, so those results must match bit for bit (bf16
rounds the same exact sums once).  Random f32 operands are held to a
normwise relative error of 1e-5 over 64-row blocks
(`utils.compare.REL_LIMIT`): the JAX kernel's per-hop `jnp.dot` and
torch's matmul add each product's terms in other orders (readings about
1e-7).  The DMA pair moves and sums f32 in the ring kernels' order, bit for
bit, and so do its VJPs.
"""
from __future__ import annotations

import os
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch.ops import fused_matmul as FM
from kungfu_tpu_torch.tools import fused_check
from kungfu_tpu_torch.utils.compare import REL_LIMIT

NS = (2, 3, 4)
M, KS, N = 24, 40, 72  # tests/unit/test_fused_matmul.py: nothing tiles
PAYLOADS = ("f32-int", "bf16-int", "f32-rand")
PAIR = (6, 5)  # a rank's rows of the DMA pair's payload


def _operands(kind: str, n: int, payload: str):
    """Every rank's (x, w), rank-major numpy f32 (b9: w is the shard)."""
    rng = np.random.default_rng({"b9": 1, "b10": 2}[kind] * 100 + n * 10 + PAYLOADS.index(
        payload))
    xs = (n, M, n * KS) if kind == "b9" else (n, M, KS)
    ws = (n, KS, N)

    def draw(shape):
        if payload.endswith("int"):
            return rng.integers(-8, 8, size=shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    return draw(xs), draw(ws)


def _dtype(payload: str):
    return torch.bfloat16 if payload.startswith("bf16") else torch.float32


def _pair(n: int):
    rng = np.random.default_rng(50 + n)
    x, g = (rng.standard_normal((n,) + PAIR).astype(np.float32) for _ in range(2))
    y, h = (rng.standard_normal((n, n * PAIR[0], PAIR[1])).astype(np.float32)
            for _ in range(2))
    return x, g, y, h


def _jax_outputs(n: int):
    """{key: (n, ...) stacked outputs} of the JAX functions."""
    from jax.sharding import Mesh, PartitionSpec as P

    from kungfu_tpu.compat import shard_map
    from kungfu_tpu.ops import fused_matmul as JFM

    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))

    def shmap(fn, args):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=tuple(P("dp") for _ in args),
                                 out_specs=P("dp"), check_vma=False))(*args)

    out = {}
    for kind, fn in (("b9", JFM.all_gather_matmul), ("b10", JFM.matmul_reduce_scatter)):
        for payload in PAYLOADS:
            dt = jnp.bfloat16 if payload.startswith("bf16") else jnp.float32
            x, w = (jnp.asarray(a).astype(dt) for a in _operands(kind, n, payload))
            got = shmap(lambda xx, ww, fn=fn: fn(xx[0], ww[0], "dp")[None], (x, w))
            out[f"{kind}/{payload}"] = np.asarray(got.astype(jnp.float32))
    x, g, y, h = (jnp.asarray(a) for a in _pair(n))

    def ag(a):
        return shmap(lambda xx: JFM.dma_all_gather(xx[0], "dp")[None], (a,))

    def rs(a):
        return shmap(lambda yy: JFM.dma_reduce_scatter(yy[0], "dp")[None], (a,))

    out["ag"] = np.asarray(ag(x))
    out["rs"] = np.asarray(rs(y))
    out["ag_vjp"] = np.asarray(jax.grad(lambda a: (ag(a) * h).sum())(x))
    out["rs_vjp"] = np.asarray(jax.grad(lambda a: (rs(a) * g).sum())(y))
    return out


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops import fused_matmul as FM

    n, path = int(sys.argv[1]), sys.argv[2]
    assert distributed.init_distributed(device="cpu") == n
    d = dist.get_rank()
    data = np.load(path + ".in.npz")
    out = {}
    for key in data.files:
        if key.count("/") != 2:
            continue
        kind, payload, which = key.split("/")
        if which != "x":
            continue
        dt = torch.bfloat16 if payload.startswith("bf16") else torch.float32
        x = torch.from_numpy(data[key][d]).to(dt)
        w = torch.from_numpy(data[f"{kind}/{payload}/w"][d]).to(dt)
        fn = FM.all_gather_matmul if kind == "b9" else FM.matmul_reduce_scatter
        out[f"{kind}/{payload}"] = fn(x, w).float().numpy()
    x = torch.from_numpy(data["x"][d]).requires_grad_()
    y = torch.from_numpy(data["y"][d]).requires_grad_()
    a = FM.dma_all_gather(x)
    (a * torch.from_numpy(data["h"][d])).sum().backward()
    r = FM.dma_reduce_scatter(y)
    (r * torch.from_numpy(data["g"][d])).sum().backward()
    out.update(ag=a.detach().numpy(), rs=r.detach().numpy(), ag_vjp=x.grad.numpy(),
               rs_vjp=y.grad.numpy())
    refused = []
    for call in (lambda: FM.matmul_reduce_scatter(torch.zeros(n + 1, 4), torch.zeros(4, 3)),
                 lambda: FM.all_gather_matmul(torch.zeros(5, 4 * n + 1), torch.zeros(4, 3)),
                 lambda: FM.dma_reduce_scatter(torch.zeros(n + 1, 2))):
        try:
            call()
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = np.array(refused)
    np.savez(path + f".{d}.npz", **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({n: JAX outputs}, {n: {key: (n, ...) rank-local outputs}}): the
    port's ranks run while the JAX functions do."""
    tmp = tmp_path_factory.mktemp("fused")
    procs = []
    for n in NS:
        arrays = {}
        for kind in ("b9", "b10"):
            for payload in PAYLOADS:
                arrays[f"{kind}/{payload}/x"], arrays[f"{kind}/{payload}/w"] = _operands(
                    kind, n, payload)
        x, g, y, h = _pair(n)
        np.savez(tmp / f"n{n}.in.npz", x=x, g=g, y=y, h=h, **arrays)
        procs += start_ranks(WORKER, n, [n, tmp / f"n{n}"])
    old = os.environ.get("KFT_PALLAS")
    os.environ["KFT_PALLAS"] = "interpret"
    try:
        with jax_reference():
            ref = {n: _jax_outputs(n) for n in NS}
    finally:
        wait_ranks(procs, timeout=300)
        if old is None:
            del os.environ["KFT_PALLAS"]
        else:
            os.environ["KFT_PALLAS"] = old
    ranks = {}
    for n in NS:
        files = [np.load(tmp / f"n{n}.{r}.npz") for r in range(n)]
        ranks[n] = {k: np.stack([f[k] for f in files]) for k in files[0].files}
    return ref, ranks


def _stacked_plain(kind: str, n: int, payload: str) -> np.ndarray:
    dt = _dtype(payload)
    xs, ws = (torch.from_numpy(a).to(dt) for a in _operands(kind, n, payload))
    fn = FM._plain_all_gather_matmul if kind == "b9" else FM._plain_matmul_reduce_scatter
    return fn(xs, ws).float().numpy()


def _assert_matches(got: np.ndarray, want: np.ndarray, payload: str) -> None:
    if payload.endswith("int"):
        np.testing.assert_array_equal(got, want)
        return
    for g, w in zip(got, want):  # every rank's result
        _, worst = fused_check._rel(torch.tensor(g), torch.tensor(w))
        assert worst <= REL_LIMIT[torch.float32], worst


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("kind", ["b9", "b10"])
@pytest.mark.parametrize("n", NS)
def test_stacked_plain_matches_jax(runs, n, kind, payload):
    _assert_matches(_stacked_plain(kind, n, payload), runs[0][n][f"{kind}/{payload}"], payload)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("kind", ["b9", "b10"])
@pytest.mark.parametrize("n", NS)
def test_rank_local_matches_jax(runs, n, kind, payload):
    got = runs[1][n][f"{kind}/{payload}"]
    _assert_matches(got, runs[0][n][f"{kind}/{payload}"], payload)
    # the stacked plain version is what the card checks hold the kernel to
    np.testing.assert_array_equal(got, _stacked_plain(kind, n, payload))


@pytest.mark.parametrize("key", ["ag", "rs", "ag_vjp", "rs_vjp"])
@pytest.mark.parametrize("n", NS)
def test_dma_pair_and_vjps_match_jax(runs, n, key):
    np.testing.assert_array_equal(runs[1][n][key], runs[0][n][key])


@pytest.mark.parametrize("kind", ["b9", "b10"])
@pytest.mark.parametrize("n", NS)
def test_planted_faults_are_rejected(n, kind):
    """fused_check's comparisons reject a B9 that takes one hop's shard
    twice and a B10 that drops one incoming partial, on integer and on
    random operands, on every rank."""
    for payload in ("f32-int", "f32-rand"):
        xs, ws = (torch.from_numpy(a) for a in _operands(kind, n, payload))
        want = torch.from_numpy(_stacked_plain(kind, n, payload))
        for d in range(n):
            bad = fused_check.planted_fault(kind, xs, ws, d)
            if payload.endswith("int"):
                assert not torch.equal(bad, want[d])
            else:
                assert fused_check._rel(bad, want[d])[1] > REL_LIMIT[torch.float32]


@pytest.mark.parametrize("n", NS)
def test_rank_local_refusals(runs, n):
    """Rows not divisible by n, a contraction dim that is not n shards,
    and a scatter of rows not divisible by n raise ValueError on every rank."""
    for msgs in runs[1][n]["refused"]:
        assert len(msgs) == 3
        assert "not divisible by n" in msgs[0]
        assert "contraction dim" in msgs[1]
        assert "not divisible" in msgs[2]


def test_refusals_and_one_rank():
    x, w = torch.ones(4, 6), torch.ones(6, 3)
    with pytest.raises(NotImplementedError, match="no kernel"):
        FM.all_gather_matmul(x.int(), w.int())
    with pytest.raises(NotImplementedError, match="no kernel"):
        FM.matmul_reduce_scatter(x, w.bfloat16())
    with pytest.raises(ValueError, match="contraction dim"):
        FM.all_gather_matmul(x, torch.ones(5, 3))
    with pytest.raises(ValueError, match="do not multiply"):
        FM.matmul_reduce_scatter(x, torch.ones(5, 3))
    with pytest.raises(ValueError, match="matrices"):
        FM.all_gather_matmul(x[0], w)
    # n == 1: the unfused product in f32, in x's dtype, and no launch
    for dt in (torch.float32, torch.bfloat16):
        a, b = torch.randn(5, 6).to(dt), torch.randn(6, 7).to(dt)
        want = (a.float() @ b.float()).to(dt)
        assert torch.equal(FM.all_gather_matmul(a, b), want)
        assert torch.equal(FM.matmul_reduce_scatter(a, b), want)
    assert torch.equal(FM.dma_all_gather(x), x) and torch.equal(FM.dma_reduce_scatter(x), x)
    assert FM.AG_MATMUL.launches == 0 and FM.MATMUL_RS.launches == 0


@pytest.mark.parametrize("n", NS)
def test_workspace_slots_tile_the_workspace(n):
    """Each kind's slots (B9's n, the shift's one, every other kind's n-1)
    follow the header in KINDS order, back to back, and end at nbytes."""
    from kungfu_tpu_torch.ops import peer_memory as PM

    ws = object.__new__(PM.Workspace)  # the layout alone, no card
    ws.n, ws.header = n, 4096
    ws.slot_bytes = {k: (i + 1) * PM.SLOT_ALIGN for i, k in enumerate(PM.KINDS)}
    counts = {"rs": n - 1, "ag": n - 1, "frs": n - 1, "fag": n - 1, "shift": 1, "agmm": n,
              "mmrs": n - 1}
    end = ws.header
    for k in PM.KINDS:
        assert ws.slots(k) == (end, ws.slot_bytes[k]), k
        end += counts[k] * ws.slot_bytes[k]
    assert end == ws.nbytes
