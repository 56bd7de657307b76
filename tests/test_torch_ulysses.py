"""The port's Ulysses attention against the JAX package's.

The reference is `kungfu_tpu.parallel.ulysses.ulysses_attention` in
shard_map over 4 virtual CPU devices (the sp axis), each holding one
chunk of the sequence; on the CPU its attention over the head group is
`full_attention`.  The port runs `ulysses_attention` on 4 gloo ranks in
subprocesses, each with its chunk, the all_to_all on
`torch.distributed.all_to_all_single` and the head group's attention on
its default, `ops.flash.flash_attention` (the plain version for CPU
tensors).  8 query heads: MHA (8 kv heads), GQA with the kv heads split
over the ranks (4) and repeated first (2, which 4 ranks do not divide),
causal and not; the outputs and dq, dk, dv of sum(out * w) for a random
w.

Tolerance, f32: 1e-5 of the largest value of each tensor, the one of
tests/test_torch_ring_attention.py (`_close`).  Both sides sum the same
f32 products in other orders (the flash plain version blockwise); a head
group that met another group's kv heads, or a chunk put back in the wrong
place, moves values by 1e-1 or more.  The 4-rank output is also held to
that tolerance against one process's `full_attention` over the whole
sequence; the reshard alone is exact (each rank's head group over the
whole sequence, and back), and heads that the ranks do not divide raise.
"""
from __future__ import annotations

import json
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_ranks import start_ranks, wait_ranks
from _torch_reference import jax_reference
from kungfu_tpu_torch.parallel import ulysses as U
from kungfu_tpu_torch.parallel.ring_attention import full_attention
from kungfu_tpu_torch.utils.compare import REL_LIMIT

N, B, LC, H, D = 4, 2, 16, 8, 16
HKVS = (8, 4, 2)  # MHA, GQA split over the ranks, GQA repeated first
CAUSAL = (True, False)
CONFIGS = [(hkv, causal) for hkv in HKVS for causal in CAUSAL]
OUTS = ("o", "dq", "dk", "dv")
TOL = 1e-5  # of the largest value


def _key(hkv, causal):
    return f"hkv{hkv}-{'causal' if causal else 'full'}"


def _inputs(hkv: int):
    """q, k, v and the cotangent w over the whole sequence, numpy f32."""
    rng = np.random.default_rng(500 + hkv)
    L = N * LC
    return (rng.standard_normal((B, L, H, D)).astype(np.float32),
            rng.standard_normal((B, L, hkv, D)).astype(np.float32),
            rng.standard_normal((B, L, hkv, D)).astype(np.float32),
            rng.standard_normal((B, L, H, D)).astype(np.float32))


def _jax_outputs():
    from jax.sharding import Mesh, PartitionSpec as P

    from kungfu_tpu.compat import shard_map
    from kungfu_tpu.parallel.ulysses import ulysses_attention

    mesh = Mesh(np.array(jax.devices()[:N]), ("sp",))
    spec = P(None, "sp", None, None)
    out = {}
    for hkv, causal in CONFIGS:
        fn = jax.jit(shard_map(
            lambda q, k, v, c=causal: ulysses_attention(q, k, v, "sp", causal=c),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
        q, k, v, w = (jnp.asarray(a) for a in _inputs(hkv))
        grads = jax.grad(lambda q, k, v: (fn(q, k, v) * w).sum(), argnums=(0, 1, 2))(q, k, v)
        out[_key(hkv, causal)] = dict(zip(OUTS, map(np.asarray, (fn(q, k, v), *grads))))
    return out


@pytest.fixture(scope="module")
def ref():
    with jax_reference():
        yield _jax_outputs()


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.parallel import ulysses as U

    path, configs, lc = sys.argv[1], eval(sys.argv[2]), int(sys.argv[3])
    n = distributed.init_distributed(device="cpu")
    d = dist.get_rank()
    rows = slice(d * lc, (d + 1) * lc)
    out = {}
    for hkv, causal in configs:
        data = np.load(path + f".hkv{hkv}.npz")
        q, k, v = (torch.from_numpy(data[x][:, rows]).requires_grad_() for x in "qkv")
        o = U.ulysses_attention(q, k, v, causal=causal)
        (o * torch.from_numpy(data["w"][:, rows])).sum().backward()
        key = f"hkv{hkv}-{'causal' if causal else 'full'}"
        for name, t in zip(("o", "dq", "dk", "dv"), (o, q.grad, k.grad, v.grad)):
            out[f"{key}/{name}"] = t.detach().numpy()
    # the reshard alone: this rank's head group over the whole sequence, and back
    q = torch.from_numpy(np.load(path + ".hkv8.npz")["q"])
    heads = q.shape[2] // n
    there = U._seq_to_heads(q[:, rows], None, n)
    out["reshard/there"] = np.array(torch.equal(there, q[:, :, d * heads:(d + 1) * heads]))
    out["reshard/back"] = np.array(torch.equal(U._heads_to_seq(there, None, n), q[:, rows]))
    try:
        U.ulysses_attention(q[:, rows, :6], q[:, rows, :6], q[:, rows, :6])
        out["indivisible"] = np.array("no error")
    except ValueError as e:
        out["indivisible"] = np.array(str(e))
    np.savez(path + f".{d}.npz", **out)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{config key: {name: whole-sequence tensor}} of the port's Ulysses
    attention on N gloo ranks, each rank's chunk put back in its place,
    and each rank's file."""
    tmp = tmp_path_factory.mktemp("ulysses")
    for hkv in HKVS:
        np.savez(tmp / f"in.hkv{hkv}.npz", **dict(zip("qkvw", _inputs(hkv))))
    wait_ranks(start_ranks(WORKER, N, [tmp / "in", repr(CONFIGS), LC]))
    files = [np.load(tmp / f"in.{r}.npz") for r in range(N)]
    out = {_key(*c): {name: np.concatenate([f[f"{_key(*c)}/{name}"] for f in files], axis=1)
                      for name in OUTS} for c in CONFIGS}
    out["files"] = files
    return out


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name", OUTS)
@pytest.mark.parametrize("hkv,causal", CONFIGS, ids=[_key(*c) for c in CONFIGS])
def test_ulysses_matches_jax(ref, ranks, hkv, causal, name):
    key = _key(hkv, causal)
    _close(ranks[key][name], ref[key][name])


@pytest.mark.parametrize("hkv,causal", CONFIGS, ids=[_key(*c) for c in CONFIGS])
def test_ulysses_matches_full_attention(ranks, hkv, causal):
    """The 4-rank Ulysses attention against one process's full_attention
    on the whole sequence: the output and every gradient."""
    q, k, v, w = (torch.from_numpy(a).requires_grad_() for a in _inputs(hkv))
    o = full_attention(q, k, v, causal=causal)
    (o * w).sum().backward()
    got = ranks[_key(hkv, causal)]
    for name, want in zip(OUTS, (o, q.grad, k.grad, v.grad)):
        _close(got[name], want.detach().numpy())


@pytest.mark.parametrize("rank", range(N))
def test_reshard_is_exact(ranks, rank):
    f = ranks["files"][rank]
    assert bool(f["reshard/there"]) and bool(f["reshard/back"])


def test_indivisible_heads_are_refused(ranks):
    for f in ranks["files"]:
        assert "must divide n_heads=6" in str(f["indivisible"])


def test_one_rank_is_flash_attention():
    """Without a group, the attention of the whole sequence (attn_fn
    receives the unsharded heads; a kv-head count is kept for GQA)."""
    q, k, v, _ = (torch.from_numpy(a[:, :LC]) for a in _inputs(4))
    _close(U.ulysses_attention(q, k, v).numpy(), full_attention(q, k, v).numpy())
    seen = []
    U.ulysses_attention(q, k, v, causal=False, scale=0.5,
                        attn_fn=lambda *t, **kw: seen.append(([x.shape[2] for x in t], kw)) or t[0])
    assert seen == [([H, 4, 4], {"causal": False, "scale": 0.5})]


CHECK_WORKER = textwrap.dedent("""
    import json
    import sys
    import torch
    import torch.distributed as dist
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.ops.flash import flash_attention
    from kungfu_tpu_torch.tools import ulysses_check

    path, shape = sys.argv[1], eval(sys.argv[2])
    n = distributed.init_distributed(device="cpu")
    b, l, h, d = shape

    def kv_rolled(q, k, v, **kw):  # each query head meets the next kv head
        return flash_attention(q, k.roll(1, 2), v.roll(1, 2), **kw)

    def chunk_moved(q, k, v, **kw):  # the whole-sequence output a chunk late
        return flash_attention(q, k, v, **kw).roll(l // n, 1)

    out = {}
    for name, hkv, causal, fn in [
            *((f"hkv{hkv}-{'causal' if c else 'full'}", hkv, c, None)
              for hkv in (8, 4, 2) for c in (True, False)),
            ("fault:kv_rolled", h, True, kv_rolled), ("fault:chunk_moved", h, True, chunk_moved)]:
        out[name] = ulysses_check.against_flash(None, b, l, h, hkv, d, seed=3, dtype=torch.float32,
                                                device="cpu", causal=causal, attn_fn=fn)
    with open(path + f".{dist.get_rank()}.json", "w") as f:
        json.dump(out, f)
    distributed.shutdown_distributed()
""")


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    """tools/ulysses_check.against_flash on N gloo ranks at (B, N * LC, H,
    D) in f32: every rank's readings by case."""
    tmp = tmp_path_factory.mktemp("ulysses_check")
    wait_ranks(start_ranks(CHECK_WORKER, N, [tmp / "c", repr((B, N * LC, H, D))]))
    return [json.loads((tmp / f"c.{r}.json").read_text()) for r in range(N)]


@pytest.mark.parametrize("hkv,causal", CONFIGS, ids=[_key(*c) for c in CONFIGS])
def test_check_against_flash_holds(checked, hkv, causal):
    """The card's check of the reshard, here on the plain flash version:
    every rank's output, dq, dk and dv within the f32 gate."""
    for errs in checked:
        assert set(errs[_key(hkv, causal)]) == set(OUTS)
        assert max(errs[_key(hkv, causal)].values()) <= REL_LIMIT[torch.float32], errs


@pytest.mark.parametrize("fault", ["kv_rolled", "chunk_moved"])
def test_check_against_flash_sees_faults(checked, fault):
    """A query head paired with the wrong kv head, or the output put back
    a chunk late, fails the check on every rank."""
    for errs in checked:
        assert errs[f"fault:{fault}"]["o"] > 0.5, errs[f"fault:{fault}"]
