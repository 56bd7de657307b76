"""The port's compression package against the JAX package's, on the CPU.

Inputs come from numpy seeds and reach both packages as numpy.  The JAX
side runs jitted, as its training step runs it (under jit XLA turns
`absmax / 127` into a product with the f32 reciprocal, which the port
computes too):

  quantize, dequantize, roundtrip  int8, fp8 and bf16 at blocks 256 and 64,
                                   lengths that are not a multiple of the
                                   block, all-zero blocks, values at the
                                   clamp: bit for bit
  error feedback                   correct and residual_update: bit for bit;
                                   the grouped residual (one table of
                                   tensors a launch on a card) per tensor
                                   and against the JAX residual_update
  compression.all_reduce           on 2, 3 and 4 gloo ranks against the JAX
                                   all_reduce in shard_map: the peer sums
                                   run in another order (torch's sum over
                                   dim 0, XLA's reduce), so values agree
                                   to 1e-6 relative; a bf16 wire sums in
                                   bf16 on gloo, one rounding per add,
                                   where XLA's CPU psum sums in f32 and
                                   rounds once, so bf16 agrees to n - 1
                                   bf16 roundings (2^-8 each) of the
                                   largest partial sum
  int8-sr, randk                   from a torch.Generator, which cannot
                                   give jax.random's bits: held by their
                                   properties (unbiased within 3 sigma over
                                   many draws, error under one scale step)
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch import compression as tc
from kungfu_tpu_torch.compression import error_feedback as tef

NS = (2, 3, 4)
SIZE = 5000  # a multiple of neither block nor n * block


@pytest.fixture(scope="module")
def jc():
    with jax_reference():
        from kungfu_tpu import compression

        yield compression


def _payload(size=SIZE, seed=0, block=256):
    """Normal values of mixed magnitude, one all-zero block and one block
    whose values sit at its absmax (the clamp)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(size) * rng.uniform(0.01, 50.0, size)).astype(np.float32)
    x[block:2 * block] = 0.0
    at_clamp = x[3 * block:4 * block]
    at_clamp[:] = np.where(np.arange(at_clamp.size) % 2, 3.5, -3.5)
    x[5 * block:5 * block + 1] = 1e-30
    return x


_INTS = {1: (np.uint8, torch.uint8), 2: (np.int16, torch.int16), 4: (np.int32, torch.int32)}


def _bits(a) -> np.ndarray:
    """The bit patterns of a numpy, JAX or torch array."""
    if isinstance(a, torch.Tensor):
        return a.view(_INTS[a.element_size()][1]).numpy()
    a = np.asarray(a)
    return a.view(_INTS[a.dtype.itemsize][0])


@pytest.mark.parametrize("block", [256, 64])
@pytest.mark.parametrize("scheme", ["int8", "fp8", "bf16"])
def test_quantize_matches_jax(jc, scheme, block):
    x = _payload(block=block)
    jcfg = jc.CompressionConfig(scheme=scheme, block=block)
    cfg = tc.CompressionConfig(scheme=scheme, block=block)
    padded = np.pad(x, (0, (-x.size) % block))
    jq = jax.jit(lambda v: jc.quantize(v, jcfg))(jnp.asarray(padded))
    q = tc.quantize(torch.from_numpy(padded), cfg)
    np.testing.assert_array_equal(_bits(q.data), _bits(jq.data))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))
    jd = jax.jit(jc.dequantize)(jq)
    np.testing.assert_array_equal(tc.dequantize(q).numpy(), np.asarray(jd))
    jr = jax.jit(lambda v: jc.roundtrip(v, jcfg))(jnp.asarray(x))
    np.testing.assert_array_equal(tc.roundtrip(torch.from_numpy(x), cfg).numpy(),
                                  np.asarray(jr))
    je = jax.jit(lambda v: jc.quantization_error(v, jcfg))(jnp.asarray(x))
    np.testing.assert_allclose(tc.quantization_error(torch.from_numpy(x), cfg).item(),
                               float(je), rtol=1e-5)


def test_quantize_shapes_and_errors(jc):
    cfg = tc.INT8
    assert tc.quant.blocked_shape(5000, 256) == jc.quant.blocked_shape(5000, 256)
    assert tc.pad_to_block(torch.zeros(5), 4).numel() == 8
    q = tc.quantize(torch.zeros(3, 512), cfg)
    assert q.data.shape == (3, 2, 256) and q.scale.shape == (3, 2, 1)
    assert torch.equal(q.scale, torch.ones_like(q.scale))  # all-zero blocks: scale 1
    with pytest.raises(ValueError, match="multiple of block"):
        tc.quantize(torch.zeros(100), cfg)
    with pytest.raises(ValueError, match="not a dense quantizer"):
        tc.quantize(torch.zeros(256), tc.TOPK_1PCT)
    with pytest.raises(ValueError, match="not a sparsifier"):
        tc.sparsify(torch.zeros(256), cfg)


def test_topk_matches_jax(jc):
    x = _payload(1000, seed=1)
    jv, ji = jc.sparsify(jnp.asarray(x), jc.TOPK_1PCT.__class__(scheme="topk", k=0.05))
    v, i = tc.sparsify(torch.from_numpy(x), tc.CompressionConfig(scheme="topk", k=0.05))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    r = tc.roundtrip(torch.from_numpy(x), tc.CompressionConfig(scheme="topk", k=0.05))
    jr = jc.roundtrip(jnp.asarray(x), jc.CompressionConfig(scheme="topk", k=0.05))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_stochastic_int8_is_unbiased_within_a_step():
    """int8-sr: every draw within one scale step of x, and the mean of
    many draws within 3 sigma of x (a draw's variance is at most s^2/4)."""
    x = torch.from_numpy(_payload(1024, seed=2))
    cfg = tc.INT8_SR
    gen = torch.Generator().manual_seed(0)
    draws = 400
    total = torch.zeros_like(x, dtype=torch.float64)
    scale = tc.quantize(x, cfg, gen).scale.expand(-1, cfg.block).reshape(-1)
    for _ in range(draws):
        r = tc.roundtrip(x, cfg, gen)
        assert ((r - x).abs() <= scale * (1 + 1e-6)).all()
        total += r.double()
    sigma = scale.double() / 2 / draws ** 0.5
    assert ((total / draws - x.double()).abs() <= 3 * sigma + 1e-12).float().mean() > 0.99


def test_randk_keeps_k_coordinates_uniformly():
    x = torch.from_numpy(_payload(2000, seed=3))
    cfg = tc.RANDK_1PCT.__class__(scheme="randk", k=0.05)
    gen = torch.Generator().manual_seed(0)
    counts = torch.zeros(2000)
    draws = 300
    for _ in range(draws):
        v, i = tc.sparsify(x, cfg, gen)
        assert i.numel() == 100 and i.unique().numel() == 100
        assert torch.equal(v, x[i.long()])
        counts[i.long()] += 1
    p = cfg.k
    sigma = (draws * p * (1 - p)) ** 0.5
    assert ((counts - draws * p).abs() <= 4 * sigma).float().mean() > 0.99
    r = tc.roundtrip(x, cfg, torch.Generator().manual_seed(1))
    assert (r != 0).sum() <= 100 and torch.equal(r[r != 0], x[r != 0])


@pytest.mark.parametrize("scheme", ["int8", "fp8"])
def test_error_feedback_matches_jax(jc, scheme):
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((37, 11), (1000,), (3, 4, 5))]
    res = [rng.standard_normal(g.shape).astype(np.float32) * 0.01 for g in grads]
    jstate = jc.EFState(residual=[jnp.asarray(r) for r in res])
    state = tc.EFState(residual=[torch.from_numpy(r) for r in res])
    jcorr = jax.jit(jc.error_feedback.correct)([jnp.asarray(g) for g in grads], jstate)
    corr = tef.correct([torch.from_numpy(g) for g in grads], state)
    for a, b in zip(corr, jcorr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jnext = jax.jit(lambda c: jc.error_feedback.residual_update(c, scheme))(jcorr)
    nxt = tef.residual_update(corr, scheme)
    for a, b in zip(nxt.residual, jnext.residual):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    zero = tef.init({"a": torch.ones(3, dtype=torch.bfloat16)})
    assert zero.residual["a"].dtype == torch.float32 and not zero.residual["a"].any()
    assert not tef.residual_update(corr, "none").residual[0].any()


@pytest.mark.parametrize("scheme", ["int8", "fp8", "bf16", "int8-sr"])
def test_error_feedback_in_place_matches_out_of_place(jc, scheme):
    """correct_ and residual_update_, as the compressed S-SGD step runs
    them, give the bits of correct and residual_update (and so of the JAX
    package's, above); a bf16 gradient is widened to f32 as JAX does."""
    rng = np.random.default_rng(5)
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((37, 11), (1000,), (300,))]
    grads[2] = grads[2].to(torch.bfloat16)
    res = [torch.from_numpy(rng.standard_normal(tuple(g.shape)).astype(np.float32)) * 0.01
           for g in grads]
    want_c = tef.correct(grads, tc.EFState(residual=res))
    want_e = tef.residual_update(want_c, scheme, torch.Generator().manual_seed(3))
    state = tc.EFState(residual=[r.clone() for r in res])
    got_c = tef.correct_(grads, state)
    assert all(c is r for c, r in zip(got_c, state.residual))  # in the residuals' memory
    for a, b in zip(got_c, want_c):
        assert torch.equal(a, b)
    got_e = tef.residual_update_(got_c, scheme, torch.Generator().manual_seed(3))
    for a, b, c in zip(got_e.residual, want_e.residual, got_c):
        assert a is c and torch.equal(a, b)
    if scheme == "int8":
        jnext = jax.jit(lambda c: jc.error_feedback.residual_update(c, scheme))(
            [jnp.asarray(c.numpy()) for c in want_c])
        for a, b in zip(got_e.residual, jnext.residual):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_residual_kernel_wrapper_refuses_what_it_cannot_run():
    x = torch.ones(300)
    with pytest.raises(NotImplementedError, match="deterministic int8/fp8"):
        tef.residual_(x, tc.INT8_SR)
    with pytest.raises(NotImplementedError, match="deterministic int8/fp8"):
        tef.residual_(x, tc.BF16)
    with pytest.raises(ValueError, match="contiguous f32"):
        tef.residual_(x.to(torch.bfloat16), tc.INT8)
    with pytest.raises(ValueError, match="contiguous f32"):
        tef.residual_(torch.ones(4, 6).t(), tc.INT8)
    assert tef.EF_RESIDUAL.launches == 0  # the CPU runs the plain version


EF_SIZES = (1, 255, 256, 4099, 0)  # a value, a block short, one block, ragged, empty


def _gradients(sizes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        x = (rng.standard_normal(n) * rng.uniform(0.01, 50.0, n)).astype(np.float32)
        x[256:512] = 0.0  # an all-zero block where there is room
        out.append(torch.from_numpy(x))
    return out


@pytest.mark.parametrize("block", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("scheme", ["int8", "fp8"])
def test_grouped_residual_matches_per_tensor_and_jax(jc, scheme, block):
    """residual_group_ on a list (the compressed step's one call) gives each
    tensor the bits of residual_ alone and of the JAX residual_update."""
    cfg = tc.CompressionConfig(scheme=scheme, block=block)
    xs = _gradients(EF_SIZES, 11 + block)
    grouped = [x.clone() for x in xs]
    got = tef.residual_group_(grouped, cfg)
    assert all(a is b for a, b in zip(got, grouped))  # in place
    jcfg = jc.CompressionConfig(scheme=scheme, block=block)
    nonempty = [x for x in xs if x.numel()]
    jres = jax.jit(lambda cs: jc.error_feedback.residual_update(cs, jcfg))(
        [jnp.asarray(x.numpy()) for x in nonempty]).residual
    for x, g in zip(xs, grouped):
        one = tef.residual_(x.clone(), cfg)
        assert torch.equal(g.view(torch.int32), one.view(torch.int32))
    for g, j in zip([g for g in grouped if g.numel()], jres):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert tef.EF_RESIDUAL.launches == 0  # the CPU runs the plain version


def test_grouped_residual_longer_than_one_table():
    """More tensors than a launch's table holds: every one still gets its
    own residual, and the plan splits them into tables in order."""
    sizes = [(37 * i) % 700 for i in range(2 * tef.EF_TABLE + 13)]
    xs = _gradients(sizes, 3)
    grouped = tef.residual_group_([x.clone() for x in xs], tc.INT8)
    for x, g in zip(xs, grouped):
        assert torch.equal(g, tef.residual_(x.clone(), tc.INT8))
    tables = tef.ef_plan(sizes)
    assert len(tables) == 3 and all(len(t) <= tef.EF_TABLE for t in tables)
    entries = [e for t in tables for e in t]
    assert entries == [(i, 0, n) for i, n in enumerate(sizes) if n]  # empty ones: no entry


def test_ef_plan_splits_a_tensor_past_an_entry():
    """A tensor above EF_PIECE values takes several entries, each from a
    multiple of 256 values (a quantization block of the tensor); a plan
    never refuses."""
    big = 2 * tef.EF_PIECE + 5
    assert tef.EF_PIECE % 256 == 0
    assert tef.ef_plan([3, big, 0, 7]) == [[(0, 0, 3), (1, 0, tef.EF_PIECE),
                                            (1, tef.EF_PIECE, tef.EF_PIECE),
                                            (1, 2 * tef.EF_PIECE, 5), (3, 0, 7)]]
    assert tef.ef_plan([]) == [] and tef.ef_plan([0, 0]) == []


def test_grouped_residual_refuses_what_it_cannot_run():
    x = torch.ones(300)
    with pytest.raises(NotImplementedError, match="deterministic int8/fp8"):
        tef.residual_group_([x], tc.INT8_SR)
    with pytest.raises(ValueError, match="contiguous f32"):
        tef.residual_group_([x, x.to(torch.bfloat16)], tc.INT8)
    with pytest.raises(ValueError, match="not contiguous"):
        tef.residual_group_([x, torch.ones(4, 6).t()], tc.INT8)
    with pytest.raises(ValueError, match="not on one device"):
        tef.residual_group_([x, torch.ones(3, device="meta")], tc.INT8)
    assert torch.equal(x, torch.ones(300))  # a refused list is left as it was
    assert tef.residual_group_([], tc.INT8) == []


def test_config_registry_matches_jax(jc):
    assert sorted(tc.registered()) == sorted(jc.registered())
    for name, cfg in tc.registered().items():
        j = jc.resolve(name)
        assert (cfg.scheme, cfg.block, cfg.stochastic, cfg.k, cfg.error_feedback) == \
            (j.scheme, j.block, j.stochastic, j.k, j.error_feedback)
        assert cfg.describe() == j.describe()
        assert cfg.wire_bytes(5000) == j.wire_bytes(5000)
    assert tc.resolve(None) is tc.NONE and tc.resolve("INT8") is tc.INT8
    with pytest.raises(ValueError, match="unknown compression"):
        tc.resolve("int4")
    with pytest.raises(TypeError):
        tc.resolve(8)
    with pytest.raises(ValueError, match="unknown compression scheme"):
        tc.CompressionConfig(scheme="int4")
    with pytest.raises(ValueError, match="no known axis"):
        tc.validate_axis_keys({"dp ": "int8"}, ("dp",))
    assert tc.resolve_for_axis({"dcn": "int8"}, "ici") is tc.NONE
    ax = tc.AxisConfig.make({"dcn": "int8", "ici": None})
    assert hash(ax) == hash(tc.AxisConfig.make({"ici": None, "dcn": "int8"}))
    assert ax.describe() == jc.AxisConfig.make({"dcn": "int8", "ici": None}).describe()
    x = torch.arange(4.0)  # one rank: each leg a group of one
    assert torch.equal(tc.hierarchical_all_reduce(x, None, None, dcn_config="int8"),
                       tc.all_reduce(x, None, "int8"))


# -- compression.all_reduce on gloo ranks against the JAX shard_map --------

CASES = [(s, op) for s in ("int8", "fp8", "bf16", "none") for op in ("sum", "mean")]


def _rank_inputs(n):
    rng = np.random.default_rng(200 + n)
    return (rng.standard_normal((n, SIZE)) * rng.uniform(0.1, 10, (n, SIZE))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_all_reduce(jc):
    from jax.sharding import Mesh, PartitionSpec as P

    from kungfu_tpu.compat import shard_map  # imported under the jc fixture

    out = {}
    for n in NS:
        mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
        x = jnp.asarray(_rank_inputs(n))
        for scheme, op in CASES:
            fn = jax.jit(shard_map(lambda a: jc.all_reduce(a[0], "dp", scheme, op=op)[None],
                                   mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                                   check_vma=False))
            out[(n, scheme, op)] = np.asarray(fn(x))
    return out


WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from kungfu_tpu_torch import compression, distributed

n, path = int(sys.argv[1]), sys.argv[2]
assert distributed.init_distributed(device="cpu") == n
d = dist.get_rank()
xs = np.load(path + ".in.npy")
out = {}
for scheme in ("int8", "fp8", "bf16", "none"):
    for op in ("sum", "mean"):
        got = compression.all_reduce(torch.from_numpy(xs[d]), None, scheme, op=op)
        out[f"{scheme}/{op}"] = got.numpy()
got = compression.group_all_reduce([torch.from_numpy(xs[d])] * 2, None, "int8")
out["group"] = torch.stack(got).numpy()
np.savez(path + f".{d}.npz", **out)
distributed.shutdown_distributed()
"""


@pytest.fixture(scope="module")
def gloo_all_reduce(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comp")
    procs = {}
    for n in NS:
        np.save(tmp / f"n{n}.in.npy", _rank_inputs(n))
        procs[n] = start_ranks(WORKER, n, [n, tmp / f"n{n}"])
    out = {}
    for n in NS:
        wait_ranks(procs[n])
        files = [np.load(tmp / f"n{n}.{r}.npz") for r in range(n)]
        out[n] = {k: np.stack([f[k] for f in files]) for k in files[0].files}
    return out


@pytest.mark.parametrize("scheme,op", CASES)
@pytest.mark.parametrize("n", NS)
def test_all_reduce_on_gloo_matches_jax(jax_all_reduce, gloo_all_reduce, n, scheme, op):
    got = gloo_all_reduce[n][f"{scheme}/{op}"]
    want = jax_all_reduce[(n, scheme, op)]
    assert (got == got[0]).all()  # every rank holds the same result
    if scheme == "bf16":
        partial = np.abs(np.cumsum(_rank_inputs(n), axis=0)).max()
        atol = (n - 1) * 2.0 ** -8 * partial / (n if op == "mean" else 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_group_all_reduce_on_gloo(gloo_all_reduce):
    got = gloo_all_reduce[2]
    assert np.array_equal(got["group"][:, 0], got["int8/sum"])
    assert np.array_equal(got["group"][:, 1], got["int8/sum"])
