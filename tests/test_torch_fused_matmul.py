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

import json
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


# ------------------------------------------- bf16 padding and tile plan ----

# Shapes the copy engine cannot read as they are (a row of N = 75 bf16 values
# is not whole 16 bytes; ks = 37 neither) and shapes below one tile: (rows,
# ks or K, N) with B9's rows M = 24 or 1 and B10's chunk rows 24 / n or 1.
UNALIGNED = ((24, 40, 75), (1, 37, 75))
BF16_PAYLOADS = ("bf16-int", "bf16-rand")


def _unaligned_operands(kind: str, n: int, shape, payload: str):
    """Every rank's (x, w) at an unaligned shape, rank-major numpy f32."""
    rows, k, nn = shape
    rng = np.random.default_rng(7 * n + UNALIGNED.index(shape) * 3 + BF16_PAYLOADS.index(payload)
                                + {"b9": 0, "b10": 100}[kind])
    if kind == "b9":
        xs, ws = (n, rows, n * k), (n, k, nn)
    else:
        xs, ws = (n, n * (rows if rows == 1 else rows // n), k), (n, k, nn)

    def draw(s):
        if payload.endswith("int"):
            return rng.integers(-8, 8, size=s).astype(np.float32)
        return rng.standard_normal(s).astype(np.float32)

    return draw(xs), draw(ws)


@pytest.fixture(scope="module")
def unaligned_jax():
    """{(n, kind, shape, payload): the JAX functions' stacked outputs} at the
    unaligned shapes, in bf16, under the Pallas interpreter."""
    from jax.sharding import Mesh, PartitionSpec as P

    old = os.environ.get("KFT_PALLAS")
    os.environ["KFT_PALLAS"] = "interpret"
    out = {}
    try:
        with jax_reference():
            from kungfu_tpu.compat import shard_map
            from kungfu_tpu.ops import fused_matmul as JFM

            for n in NS:
                mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
                for kind, fn in (("b9", JFM.all_gather_matmul),
                                 ("b10", JFM.matmul_reduce_scatter)):
                    run = jax.jit(shard_map(lambda xx, ww, fn=fn: fn(xx[0], ww[0], "dp")[None],
                                            mesh=mesh, in_specs=(P("dp"), P("dp")),
                                            out_specs=P("dp"), check_vma=False))
                    for shape in UNALIGNED:
                        for payload in BF16_PAYLOADS:
                            x, w = (jnp.asarray(a).astype(jnp.bfloat16)
                                    for a in _unaligned_operands(kind, n, shape, payload))
                            out[(n, kind, shape, payload)] = np.asarray(
                                run(x, w).astype(jnp.float32))
    finally:
        if old is None:
            del os.environ["KFT_PALLAS"]
        else:
            os.environ["KFT_PALLAS"] = old
    return out


def _padded_plain(kind: str, xs: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """The stacked plain version on the operands as the bf16 wrappers pad
    them for the kernels, sliced back: what the kernels must equal."""
    n, nn = xs.shape[0], ws.shape[2]
    if kind == "b9":
        padded = [FM._pad_ag(x, w, n) for x, w in zip(xs, ws)]
    else:
        padded = [FM._pad_rs(x, w) for x, w in zip(xs, ws)]
    xp = torch.stack([p[0] for p in padded])
    wp = torch.stack([p[1] for p in padded])
    for p in wp:  # whole 16-byte rows: what the copy engine reads
        assert p.shape[0] % FM._ALIGN == 0 and p.shape[1] % FM._ALIGN == 0
    return fused_check.plain(kind, xp, wp)[:, :, :nn]


@pytest.mark.parametrize("payload", BF16_PAYLOADS)
@pytest.mark.parametrize("shape", UNALIGNED)
@pytest.mark.parametrize("kind", ["b9", "b10"])
@pytest.mark.parametrize("n", NS)
def test_padded_plain_matches_jax(unaligned_jax, n, kind, shape, payload):
    """The bf16 wrappers pad a shard's rows, K and N to multiples of 8 with
    zeros and slice the result: on the padded operands the stacked plain
    version still equals the interpreted JAX kernels at the unaligned
    shapes (integer operands bit for bit, normal ones within the bf16 limit:
    both round f32 sums in other orders to bf16)."""
    xs, ws = (torch.from_numpy(a).to(torch.bfloat16)
              for a in _unaligned_operands(kind, n, shape, payload))
    got = _padded_plain(kind, xs, ws).float()
    want = torch.from_numpy(np.array(unaligned_jax[(n, kind, shape, payload)]))
    assert got.shape == want.shape
    if payload.endswith("int"):
        assert torch.equal(got, want)
        assert torch.equal(got, fused_check.plain(kind, xs, ws).float())  # padding adds nothing
    else:
        for g, w in zip(got, want):
            assert fused_check._rel(g, w)[1] <= REL_LIMIT[torch.bfloat16]


@pytest.mark.parametrize("kind, dtype, rows, cols, tiles, blocks", [
    ("b10", torch.bfloat16, 256, 4096, 128, 128),  # the FSDP MLP: a work unit an SM a hop
    ("b10", torch.float32, 256, 4096, 64, 64),
    ("b9", torch.bfloat16, 4096, 4096, 512, 132),  # persistent: 512 tiles over 132 blocks
    ("b9", torch.float32, 4096, 4096, 1024, 132),
    ("b9", torch.bfloat16, 1, 80, 1, 1),
    ("b10", torch.bfloat16, 65, 129, 4, 4),
    ("b10", torch.bfloat16, 512, 4096, 256, 132),  # two waves of tiles a hop
    ("b9", torch.bfloat16, 129, 257, 4, 4),
])
def test_tile_plan(kind, dtype, rows, cols, tiles, blocks):
    assert FM._plan(kind, dtype, rows, cols, 132) == (tiles, blocks)


@pytest.mark.parametrize("shape", [(24, 40, 75), (1, 37, 75), (3, 8, 16), (5, 64, 4096)])
def test_padding_keeps_the_operands(shape):
    """The pad helpers put the operands at the top left (x's columns shard
    by shard for B9), zeros elsewhere, and leave aligned shapes alone."""
    m, k, nn = shape
    n = 3
    g = torch.Generator().manual_seed(m * k + nn)
    x9 = torch.randn(m, n * k, generator=g).bfloat16()
    w = torch.randn(k, nn, generator=g).bfloat16()
    xp, wp = FM._pad_ag(x9, w, n)
    kp, np_ = -(-k // 8) * 8, -(-nn // 8) * 8
    assert xp.shape == (m, n * kp) and wp.shape == (kp, np_)
    assert torch.equal(wp[:k, :nn], w) and not wp[k:].any() and not wp[:, nn:].any()
    xv = xp.reshape(m, n, kp)
    assert torch.equal(xv[:, :, :k], x9.reshape(m, n, k)) and not xv[:, :, k:].any()
    x10 = torch.randn(m, k, generator=g).bfloat16()
    xq, wq = FM._pad_rs(x10, w)
    assert xq.shape == (m, kp) and torch.equal(xq[:, :k], x10) and not xq[:, k:].any()
    assert torch.equal(wq, wp)
    if (k % 8, nn % 8) == (0, 0):
        assert xq.data_ptr() == x10.data_ptr() and wq.data_ptr() == w.data_ptr()


def test_product_entry_on_the_cpu():
    """`mm_product` on CPU tensors is the f32 product in the asked dtype,
    launches nothing, and refuses what the body does not take."""
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(9, 37, generator=g).bfloat16(), torch.randn(37, 75, generator=g).bfloat16()
    for kind in ("b9", "b10"):
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(FM.mm_product(x, w, kind, dt), (x.float() @ w.float()).to(dt))
    assert FM.MM_PRODUCT.launches == 0
    with pytest.raises(NotImplementedError, match="bf16"):
        FM.mm_product(x.float(), w.float())
    with pytest.raises(NotImplementedError, match="out_dtype"):
        FM.mm_product(x, w, "b9", torch.float16)
    with pytest.raises(ValueError, match="do not multiply"):
        FM.mm_product(x, w[1:])


def test_ab_tool_ablates_a_copy_and_reads_the_runs(tmp_path):
    """tools/fused_ab: an ablated copy differs from this checkout only in
    KFT_MM_ABLATE, and the readings of a run are the slowest rank's."""
    from kungfu_tpu_torch.tools import fused_ab

    root = fused_ab.ablated(str(tmp_path), 2)
    rel = os.path.join("kungfu_tpu_torch", "ops", "csrc", "mm_sm90.cuh")
    with open(os.path.join(fused_ab.HERE, rel)) as f:
        want = f.read().replace("#define KFT_MM_ABLATE 0\n", "#define KFT_MM_ABLATE 2\n")
    with open(os.path.join(root, rel)) as f:
        assert f.read() == want
    assert not os.path.exists(os.path.join(root, "kungfu_tpu_torch", "_build"))
    line = {"ok_all": True, "timing": {k: {"ms": ms, "library_ms": 0.5, "bound_ms": 0.03,
                                          "bound_by": "operations"}
                                      for k, ms in (("b9", 0.1), ("b10", 0.2))}}
    out = "\n".join(f"[{r}] FUSED_CHECK " + json.dumps(
        dict(line, timing={k: dict(v, ms=v["ms"] + r) for k, v in line["timing"].items()}))
        for r in range(4))
    got = fused_ab.readings("noise\n" + out, product=False)
    assert got["b9"]["ms"] == 3.1 and got["b10"]["ms"] == 3.2 and got["b9"]["ok"]
    assert got["b10"]["ms_ranks"] == [0.2, 1.2, 2.2, 3.2]
