"""The fused-codec ring all-reduce of the port (plain versions of the
kernels B7/B8) against the Pallas kernels of the JAX package, bit for bit.

The reference is `kungfu_tpu.ops.pallas_collectives.fused_ring_all_reduce`
under the Pallas interpreter (KFT_PALLAS=interpret), in shard_map over n
virtual CPU devices: the TPU kernels' own bodies (`make_fused_rs_kernel`,
`make_fused_ag_kernel`).  The port runs twice: its stacked plain version
(every rank's input in one process, `ops/collective.py`) and its
rank-local wrapper (`ops/ring_collectives.py`) on n gloo ranks.  Payloads
are random normal floats of mixed magnitude, 5000 values a rank (not a
multiple of n * 1024).  No tolerance: XLA computes each hop's
x + code * scale as one fused multiply-add, and so does the port
(`compression.quant.fma`); the scales are absmax times the f32
reciprocal of the code range and the mean is the sum times 1/n, as XLA
compiles the reference.  bf16 runs the plain ring kernels on bf16.

The same results also lie within the error bound the JAX package's tests
put on its fused ring (`tools.ring_check.fused_tolerance`), and planted
faults (a hop's scales dropped, a block's codes zeroed) fail the bit
comparison.  A stochastic or sparse config, or an op other than sum and
mean, raises under the kernels' wrapper and under
synchronous_sgd(impl="pallas_ring").
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch.compression import CompressionConfig, resolve
from kungfu_tpu_torch.ops import collective as C
from kungfu_tpu_torch.ops import peer_memory
from kungfu_tpu_torch.ops import ring_collectives as RC
from kungfu_tpu_torch.optimizers import adamw, synchronous_sgd
from kungfu_tpu_torch.tools.ring_check import fused_tolerance, planted_fused_faults

NS = (2, 3, 4)
SIZE = 5000
# (name, scheme, block): the presets and a smaller block
CONFIGS = (("int8", "int8", 256), ("fp8", "fp8", 256), ("int8-b64", "int8", 64),
           ("bf16", "bf16", 256))
OPS = ("sum", "mean")


def _inputs(n: int) -> np.ndarray:
    rng = np.random.default_rng(300 + n)
    return (rng.standard_normal((n, SIZE)) * rng.uniform(0.1, 10, (n, SIZE))).astype(np.float32)


def _cfg(scheme: str, block: int) -> CompressionConfig:
    return CompressionConfig(scheme=scheme, block=block)


@pytest.fixture(scope="module")
def ref():
    """{(n, config name, op): (n, SIZE) per-rank outputs} of the Pallas
    fused ring, one program per n."""
    old = os.environ.get("KFT_PALLAS")
    os.environ["KFT_PALLAS"] = "interpret"
    try:
        with jax_reference():
            from jax.sharding import Mesh, PartitionSpec as P

            from kungfu_tpu.compat import shard_map
            from kungfu_tpu.compression import CompressionConfig as JConfig
            from kungfu_tpu.ops import pallas_collectives as PC

            out = {}
            for n in NS:
                def body(x):
                    return {(name, op): PC.fused_ring_all_reduce(
                        x[0], "dp", JConfig(scheme=scheme, block=block), op=op)[None]
                        for name, scheme, block in CONFIGS for op in OPS}

                mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
                fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                                       check_vma=False))
                for key, v in fn(jnp.asarray(_inputs(n))).items():
                    out[(n,) + key] = np.asarray(v)
            yield out
    finally:
        if old is None:
            del os.environ["KFT_PALLAS"]
        else:
            os.environ["KFT_PALLAS"] = old


WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from kungfu_tpu_torch import distributed
from kungfu_tpu_torch.compression import CompressionConfig
from kungfu_tpu_torch.ops import ring_collectives as RC

n, path, configs = int(sys.argv[1]), sys.argv[2], eval(sys.argv[3])
assert distributed.init_distributed(device="cpu") == n
d = dist.get_rank()
x = torch.from_numpy(np.load(path + ".in.npy")[d])
out = {}
for name, scheme, block in configs:
    for op in ("sum", "mean"):
        got = RC.fused_ring_all_reduce(x, None, CompressionConfig(scheme=scheme, block=block), op)
        out[f"{name}/{op}"] = got.numpy()
out["int8 of a 2-d bf16 tensor"] = RC.fused_ring_all_reduce(
    x[:4800].view(48, 100).to(torch.bfloat16), None, "int8").float().numpy()
np.savez(path + f".{d}.npz", **out)
distributed.shutdown_distributed()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fused")
    procs = {}
    for n in NS:
        np.save(tmp / f"n{n}.in.npy", _inputs(n))
        procs[n] = start_ranks(WORKER, n, [n, tmp / f"n{n}", repr(CONFIGS)])
    out = {}
    for n in NS:
        wait_ranks(procs[n])
        files = [np.load(tmp / f"n{n}.{r}.npz") for r in range(n)]
        out[n] = {k: np.stack([f[k] for f in files]) for k in files[0].files}
    return out


def _stacked(n: int, scheme: str, block: int, op: str) -> np.ndarray:
    xs = [torch.from_numpy(r) for r in _inputs(n)]
    return np.stack([t.numpy() for t in C._plain_fused_ring_all_reduce(xs, _cfg(scheme, block),
                                                                       op)])


QUANTIZED = [c for c in CONFIGS if c[1] != "bf16"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name,scheme,block", QUANTIZED)
@pytest.mark.parametrize("n", NS)
def test_stacked_plain_matches_pallas(ref, n, name, scheme, block, op):
    np.testing.assert_array_equal(_stacked(n, scheme, block, op), ref[(n, name, op)])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name,scheme,block", CONFIGS)
@pytest.mark.parametrize("n", NS)
def test_rank_local_ring_matches_pallas(ref, ranks, n, name, scheme, block, op):
    np.testing.assert_array_equal(ranks[n][f"{name}/{op}"], ref[(n, name, op)])


def test_rank_local_ring_keeps_shape_and_dtype(ranks):
    """A bf16 2-d tensor: reduced in f32 through the codec, cast back."""
    got = ranks[2]["int8 of a 2-d bf16 tensor"]
    xs = [torch.from_numpy(r[:4800]).view(48, 100).to(torch.bfloat16) for r in _inputs(2)]
    want = C._plain_fused_ring_all_reduce(xs, resolve("int8"))[0]
    assert want.dtype == torch.bfloat16 and want.shape == (48, 100)
    np.testing.assert_array_equal(got[0], want.float().numpy())


@pytest.mark.parametrize("scheme", ["int8", "fp8"])
@pytest.mark.parametrize("n", NS)
def test_within_the_reference_tolerance(ref, n, scheme):
    xs = [torch.from_numpy(r) for r in _inputs(n)]
    exact = np.sum(_inputs(n).astype(np.float64), axis=0)
    err = np.abs(ref[(n, scheme, "sum")] - exact).max()
    assert err <= fused_tolerance(xs, scheme), (err, fused_tolerance(xs, scheme))


@pytest.mark.parametrize("scheme", ["int8", "fp8"])
@pytest.mark.parametrize("n", NS)
def test_check_rejects_planted_faults(ref, n, scheme):
    xs = [torch.from_numpy(r) for r in _inputs(n)]
    cfg = resolve(scheme)
    good = C._plain_fused_ring_all_reduce(xs, cfg)[0]
    faults = planted_fused_faults(xs, cfg, good)
    assert [name for name, _ in faults] == ["scales of a hop dropped",
                                            "codes of a 256-value block zeroed"]
    for name, bad in faults:
        assert not np.array_equal(bad.numpy(), ref[(n, scheme, "sum")][0]), name


def test_refusals_under_pallas_ring():
    """No ring kernel runs a stochastic or sparse config or another op:
    the wrapper and synchronous_sgd(impl="pallas_ring") raise, naming the
    path that takes them."""
    x = torch.zeros(8)
    for cfg in ("int8-sr", "topk", "randk"):
        with pytest.raises(NotImplementedError, match="impl='pmean'"):
            RC.fused_ring_all_reduce(x, None, cfg)
        with pytest.raises(NotImplementedError, match="impl='pmean'"):
            synchronous_sgd(adamw(1e-3), impl="pallas_ring", compression=cfg)
        synchronous_sgd(adamw(1e-3), impl="pmean", compression=cfg)  # that path takes it
    with pytest.raises(NotImplementedError, match="op 'max'"):
        RC.fused_ring_all_reduce(x, None, "int8", op="max")
    with pytest.raises(ValueError, match="no known axis"):
        synchronous_sgd(adamw(1e-3), impl="pallas_ring", compression={"dcn": "int8"})
    assert RC.fused_ring_all_reduce(x, None, "int8") is x  # one rank: the input
    assert RC.FUSED_RS.launches == RC.FUSED_AG.launches == 0
    assert peer_memory._ERR_KINDS[5] == "fused reduce-scatter data"
    assert peer_memory._ERR_KINDS[8] == "fused all-gather acknowledgement"
