"""The port's ring shift (B11's plain versions) against the JAX package's
`ring_shift`, bit for bit.

The reference is `kungfu_tpu.ops.fused_matmul.ring_shift` under the Pallas
interpreter (KFT_PALLAS=interpret) in shard_map over n virtual CPU devices:
`ring_kernels.make_shift_kernel`'s own body for f32 and bf16, the
`ppermute` it falls back to for int32.  The port runs twice: its stacked
plain version (`_plain_ring_shift`, every rank's payload in one process,
which the card checks hold the kernel against) and its rank-local
`ring_shift` on n gloo ranks in subprocesses.  A shift moves data and
computes nothing, so there is no tolerance: n = 2, 3, 4, shifts +1, -1,
+2, f32, bf16 and int32, payloads of 7 x 143 values.  The VJP (the
gradient of sum(ring_shift(x) * w)) is held the same way, and a K/V pair
through `ring_shift_pair` equals two single shifts.
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

NS = (2, 3, 4)
SHIFTS = (1, -1, 2)
DTYPES = ("float32", "bfloat16", "int32")
SHAPE = (7, 143)  # 1001 values: a multiple of nothing the kernels tile by
PAIR_SHAPE = (5, 3, 11)  # v of the pair: another shape


def _inputs(n: int):
    """Every rank's payload (rank-major, numpy f32) and the cotangent w."""
    rng = np.random.default_rng(200 + n)
    x = rng.standard_normal((n,) + SHAPE).astype(np.float32) * 50
    return x, rng.standard_normal((n,) + SHAPE).astype(np.float32), \
        rng.standard_normal((n,) + PAIR_SHAPE).astype(np.float32)


def _cast(x: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.to(torch.int32) if dtype == "int32" else t.to(getattr(torch, dtype))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _jax_outputs(n: int):
    """{(dtype, shift): (n, ...) outputs} and {shift: (n, ...) VJPs} of
    the JAX package's ring_shift."""
    from jax.sharding import Mesh, PartitionSpec as P

    from kungfu_tpu.compat import shard_map
    from kungfu_tpu.ops.fused_matmul import ring_shift

    x, w, _ = _inputs(n)
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    out, vjp = {}, {}
    for shift in SHIFTS:
        fn = jax.jit(shard_map(lambda a, s=shift: ring_shift(a[0], "sp", s)[None], mesh=mesh,
                               in_specs=P("sp"), out_specs=P("sp"), check_vma=False))
        for dt in DTYPES:
            arg = jnp.asarray(_np(_cast(x, dt))).astype(getattr(jnp, dt))
            out[(dt, shift)] = np.asarray(fn(arg).astype(
                jnp.int32 if dt == "int32" else jnp.float32))
        vjp[shift] = np.asarray(jax.grad(lambda a: (fn(a) * jnp.asarray(w)).sum())(
            jnp.asarray(x)))
    return out, vjp


@pytest.fixture(scope="module")
def ref():
    old = os.environ.get("KFT_PALLAS")
    os.environ["KFT_PALLAS"] = "interpret"
    try:
        with jax_reference():
            yield {n: _jax_outputs(n) for n in NS}
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
    from kungfu_tpu_torch.ops import fused_matmul as FM

    n, path = int(sys.argv[1]), sys.argv[2]
    assert distributed.init_distributed(device="cpu") == n
    d = dist.get_rank()
    data = np.load(path + ".in.npz")
    out = {}
    for dt in ("float32", "bfloat16", "int32"):
        x = torch.from_numpy(data["x"][d])
        x = x.to(torch.int32) if dt == "int32" else x.to(getattr(torch, dt))
        for shift in (1, -1, 2):
            got = FM.ring_shift(x, None, shift)
            out[f"{dt}/{shift}"] = got.float().numpy() if got.is_floating_point() else got.numpy()
    for shift in (1, -1, 2):
        x = torch.from_numpy(data["x"][d]).requires_grad_()
        (FM.ring_shift(x, None, shift) * torch.from_numpy(data["w"][d])).sum().backward()
        out[f"vjp/{shift}"] = x.grad.numpy()
        k = torch.from_numpy(data["x"][d]).to(torch.bfloat16)
        v = torch.from_numpy(data["v"][d])
        k2, v2 = FM.ring_shift_pair(k, v, None, shift)
        out[f"pair_k/{shift}"] = k2.float().numpy()
        out[f"pair_v/{shift}"] = v2.numpy()
        out[f"single_k/{shift}"] = FM.ring_shift(k, None, shift).float().numpy()
        out[f"single_v/{shift}"] = FM.ring_shift(v, None, shift).numpy()
    np.savez(path + f".{d}.npz", **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{n: {key: (n, ...) outputs}} of the rank-local ring_shift on n gloo
    ranks, every n at once."""
    tmp = tmp_path_factory.mktemp("shift")
    procs = []
    for n in NS:
        x, w, v = _inputs(n)
        np.savez(tmp / f"n{n}.in.npz", x=x, w=w, v=v)
        procs += start_ranks(WORKER, n, [n, tmp / f"n{n}"])
    wait_ranks(procs)
    results = {}
    for n in NS:
        files = [np.load(tmp / f"n{n}.{r}.npz") for r in range(n)]
        results[n] = {k: np.stack([f[k] for f in files]) for k in files[0].files}
    return results


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_stacked_plain_matches_jax(ref, n, dtype, shift):
    x = _cast(_inputs(n)[0], dtype)
    np.testing.assert_array_equal(_np(FM._plain_ring_shift(x, shift)), ref[n][0][(dtype, shift)])


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_rank_local_matches_jax(ref, ranks, n, dtype, shift):
    np.testing.assert_array_equal(ranks[n][f"{dtype}/{shift}"], ref[n][0][(dtype, shift)])


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("n", NS)
def test_vjp_matches_jax(ref, ranks, n, shift):
    """The backward shifts the cotangent by -shift, as the JAX VJP does."""
    want = ref[n][1][shift]
    np.testing.assert_array_equal(ranks[n][f"vjp/{shift}"], want)
    w = torch.from_numpy(_inputs(n)[1])
    np.testing.assert_array_equal(FM._plain_ring_shift(w, -shift).numpy(), want)


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("n", NS)
def test_pair_equals_two_single_shifts(ranks, n, shift):
    got = ranks[n]
    np.testing.assert_array_equal(got[f"pair_k/{shift}"], got[f"single_k/{shift}"])
    np.testing.assert_array_equal(got[f"pair_v/{shift}"], got[f"single_v/{shift}"])
    np.testing.assert_array_equal(got[f"pair_v/{shift}"],
                                  np.roll(_inputs(n)[2], shift, axis=0))


def test_one_rank_returns_the_input_and_launches_nothing():
    x = torch.arange(6.0)
    assert FM.ring_shift(x) is x
    k, v = FM.ring_shift_pair(x, x + 1, None, 3)
    assert k is x and torch.equal(v, x + 1)
    assert FM.SHIFT.launches == 0
