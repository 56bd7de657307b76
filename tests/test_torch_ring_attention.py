"""The port's ring attention against the JAX package's.

The reference is `kungfu_tpu.parallel.ring_attention.ring_attention` in
shard_map over 4 virtual CPU devices (the sp axis), each holding one
chunk of the sequence: impl="einsum" (the online softmax), and
impl="flash" with the Pallas flash kernels interpreted (KFT_PALLAS=
interpret) and its K/V rotation on the interpreted shift kernel.  The
port runs `ring_attention` on 4 gloo ranks in subprocesses, each with its
chunk: the same two impls, the flash one on the port's plain flash
versions, the rotation through `ring_shift_pair`'s rank-local plain
version.  MHA (4 heads) and GQA (2 kv heads), causal and not; the outputs
and dq, dk, dv of sum(out * w) for a random w.

Tolerance, f32: 1e-5 of the largest value of each tensor.  Both sides sum
the same f32 products blockwise in other orders (readings about 1e-7 of
the largest); a block folded with the wrong offset, left out or merged
twice moves some rows by 1e-2 or more.  The port's 4-rank ring is also
held to the same tolerance against its own one-process `full_attention`
over the whole sequence, and merging a skipped block (lse = -1e30) leaves
(o, lse) bit for bit as they were, in both packages.

The port issues the rotation that brings hop s + 1's K/V before it folds
hop s's block (on a card the rotation then runs on a side stream under
the block): each rank records the order of its shifts and blocks, forward
and backward, and every rank's order is held to that schedule.
"""
from __future__ import annotations

import importlib
import os
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference

RA = importlib.import_module("kungfu_tpu_torch.parallel.ring_attention")

N, B, LC, H, D = 4, 2, 16, 4, 16
HKVS = (4, 2)  # MHA, GQA
IMPLS = ("einsum", "flash")
CAUSAL = (True, False)
CONFIGS = [(impl, hkv, causal) for impl in IMPLS for hkv in HKVS for causal in CAUSAL]
OUTS = ("o", "dq", "dk", "dv")
TOL = 1e-5  # of the largest value


def _key(impl, hkv, causal):
    return f"{impl}-hkv{hkv}-{'causal' if causal else 'full'}"


def _inputs(hkv: int):
    """q, k, v and the cotangent w over the whole sequence, numpy f32."""
    rng = np.random.default_rng(300 + hkv)
    L = N * LC
    return (rng.standard_normal((B, L, H, D)).astype(np.float32),
            rng.standard_normal((B, L, hkv, D)).astype(np.float32),
            rng.standard_normal((B, L, hkv, D)).astype(np.float32),
            rng.standard_normal((B, L, H, D)).astype(np.float32))


def _jax_outputs():
    from jax.sharding import Mesh, PartitionSpec as P

    from kungfu_tpu.compat import shard_map
    from kungfu_tpu.parallel.ring_attention import ring_attention

    mesh = Mesh(np.array(jax.devices()[:N]), ("sp",))
    spec = P(None, "sp", None, None)
    out = {}
    for impl, hkv, causal in CONFIGS:
        fn = jax.jit(shard_map(
            lambda q, k, v, i=impl, c=causal: ring_attention(q, k, v, "sp", causal=c, impl=i),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False))
        q, k, v, w = (jnp.asarray(a) for a in _inputs(hkv))
        grads = jax.grad(lambda q, k, v: (fn(q, k, v) * w).sum(), argnums=(0, 1, 2))(q, k, v)
        out[_key(impl, hkv, causal)] = dict(zip(OUTS, map(np.asarray, (fn(q, k, v), *grads))))
    return out


@pytest.fixture(scope="module")
def ref():
    old = os.environ.get("KFT_PALLAS")
    os.environ["KFT_PALLAS"] = "interpret"
    try:
        with jax_reference():
            yield _jax_outputs(), importlib.import_module("kungfu_tpu.parallel.ring_attention")
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
    from kungfu_tpu_torch.parallel.ring_attention import ring_attention

    path, configs, lc = sys.argv[1], eval(sys.argv[2]), int(sys.argv[3])
    n = distributed.init_distributed(device="cpu")
    d = dist.get_rank()
    rows = slice(d * lc, (d + 1) * lc)
    out = {}
    for impl, hkv, causal in configs:
        data = np.load(path + f".hkv{hkv}.npz")
        q, k, v = (torch.from_numpy(data[x][:, rows]).requires_grad_() for x in "qkv")
        o = ring_attention(q, k, v, causal=causal, impl=impl)
        (o * torch.from_numpy(data["w"][:, rows])).sum().backward()
        key = f"{impl}-hkv{hkv}-{'causal' if causal else 'full'}"
        for name, t in zip(("o", "dq", "dk", "dv"), (o, q.grad, k.grad, v.grad)):
            out[f"{key}/{name}"] = t.detach().numpy()
    # the order of the shifts (numbered in the forward) and the blocks
    from kungfu_tpu_torch.ops import fused_matmul as FM
    import importlib
    RA = importlib.import_module("kungfu_tpu_torch.parallel.ring_attention")
    log = []
    fwd, bwd, block = FM._RingShift.forward, FM._RingShift.backward, RA._block_attn_flash
    def forward(ctx, *args):
        ctx.hop = sum(e[0] == "shift" for e in log)
        log.append(("shift", ctx.hop))
        return fwd(ctx, *args)
    def backward(ctx, *gs):
        log.append(("unshift", ctx.hop))
        return bwd(ctx, *gs)
    def traced_block(q, k, v, mode, scale):
        log.append(("block", mode))
        return block(q, k, v, mode, scale)
    FM._RingShift.forward, FM._RingShift.backward = staticmethod(forward), staticmethod(backward)
    RA._block_attn_flash = traced_block
    for causal in (True, False):
        log.clear()
        data = np.load(path + ".hkv2.npz")
        q, k, v = (torch.from_numpy(data[x][:, rows]).requires_grad_() for x in "qkv")
        o = ring_attention(q, k, v, causal=causal, impl="flash")
        out[f"order/{causal}/forward"] = np.array(repr(log))
        log.clear()
        o.sum().backward()
        out[f"order/{causal}/backward"] = np.array(repr(log))
    np.savez(path + f".{d}.npz", **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{config key: {name: whole-sequence tensor}} of the port's ring on N
    gloo ranks, each rank's chunk put back in its place."""
    tmp = tmp_path_factory.mktemp("ring_attention")
    for hkv in HKVS:
        np.savez(tmp / f"in.hkv{hkv}.npz", **dict(zip("qkvw", _inputs(hkv))))
    wait_ranks(start_ranks(WORKER, N, [tmp / "in", repr(CONFIGS), LC]))
    files = [np.load(tmp / f"in.{r}.npz") for r in range(N)]
    out = {_key(*c): {name: np.concatenate([f[f"{_key(*c)}/{name}"] for f in files], axis=1)
                      for name in OUTS} for c in CONFIGS}
    out["order"] = {(r, causal, way): eval(str(f[f"order/{causal}/{way}"]))
                    for r, f in enumerate(files) for causal in CAUSAL
                    for way in ("forward", "backward")}
    return out


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name", OUTS)
@pytest.mark.parametrize("impl,hkv,causal", CONFIGS, ids=[_key(*c) for c in CONFIGS])
def test_ring_matches_jax(ref, ranks, impl, hkv, causal, name):
    key = _key(impl, hkv, causal)
    _close(ranks[key][name], ref[0][key][name])


@pytest.mark.parametrize("impl,hkv,causal", CONFIGS, ids=[_key(*c) for c in CONFIGS])
def test_ring_matches_full_attention(ranks, impl, hkv, causal):
    """The 4-rank ring against one process's full_attention on the whole
    sequence: the output and every gradient."""
    q, k, v, w = (torch.from_numpy(a).requires_grad_() for a in _inputs(hkv))
    o = RA.full_attention(q, k, v, causal=causal)
    (o * w).sum().backward()
    got = ranks[_key(impl, hkv, causal)]
    for name, want in zip(OUTS, (o, q.grad, k.grad, v.grad)):
        _close(got[name], want.detach().numpy())


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("rank", range(N))
def test_rotation_issued_before_the_block(ranks, rank, causal):
    """Rank r's forward: the shift to hop s + 1, then hop s's block (none
    for a skipped hop), n - 1 shifts in all; its backward: the shifts'
    backwards from the last hop's down, the same on every rank."""
    want = []
    for s in range(N):
        if s + 1 < N:
            want.append(("shift", s))
        src = (rank - s) % N
        mode = RA.FULL if not causal or src < rank else RA.DIAG if src == rank else RA.SKIP
        if mode != RA.SKIP:
            want.append(("block", mode))
    order = ranks["order"]
    assert order[(rank, causal, "forward")] == want
    assert order[(rank, causal, "backward")] == [("unshift", s) for s in reversed(range(N - 1))]
    assert all(order[(r, causal, "backward")] == order[(0, causal, "backward")]
               for r in range(N))


def test_skipped_block_merge_is_bit_neutral(ref):
    """Merging the skip branch's block (o = 0, lse = -1e30) into a running
    (o, lse) returns it bit for bit, in both packages; so does merging a
    block into the empty accumulator.  The port skips both merges."""
    jra = ref[1]
    rng = np.random.default_rng(7)
    o = rng.standard_normal((B, LC, H, D)).astype(np.float32)
    lse = (rng.standard_normal((B, H, LC)) * 5).astype(np.float32)
    zo, zl = np.zeros_like(o), np.full_like(lse, RA.NEG_INF)
    for first, second in (((o, lse), (zo, zl)), ((zo, zl), (o, lse))):
        got_o, got_l = RA._merge_blocks(*(torch.from_numpy(a) for a in first + second))
        want_o, want_l = jra._merge_blocks(*(jnp.asarray(a) for a in first + second))
        np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
        np.testing.assert_array_equal(got_o.numpy(), o)
        np.testing.assert_array_equal(got_l.numpy(), lse)
    skip_o, skip_l = RA._block_attn_flash(torch.from_numpy(o), None, None, RA.SKIP, 1.0)
    np.testing.assert_array_equal(skip_o.numpy(), zo)
    np.testing.assert_array_equal(skip_l.numpy(), zl)


def test_one_rank_is_full_attention():
    q, k, v, _ = (torch.from_numpy(a[:, :LC]) for a in _inputs(2))
    want = RA.full_attention(q, k, v).numpy()
    for impl in IMPLS:
        _close(RA.ring_attention(q, k, v, impl=impl).numpy(), want)
    with pytest.raises(ValueError, match="impl"):
        RA.ring_attention(q, k, v, impl="ulysses")
