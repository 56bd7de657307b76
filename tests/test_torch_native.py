"""The port's native host library (`kungfu_tpu_torch.native`) against numpy
and against the JAX package's.

* `transform2` for every op and dtype, and `average_f32`, through the
  library built from the root csrc/ against their numpy versions, bit for
  bit (as tests/unit/test_native.py holds the JAX package's);
* `BatchLoader`: the batches, across epochs, and after `reshard`, equal to
  the JAX package's `native.BatchLoader` for one seed, and the native
  stream equal to the numpy one; the loader cases of test_native.py;
* the build: into the port's git-ignored build directory, a failing g++
  raising with its stderr, no g++ running the numpy versions.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

from _torch_reference import jax_reference
from kungfu_tpu_torch import native

DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
          np.uint64, np.int64, np.float32, np.float64, np.float16]
OPS = ["sum", "min", "max", "prod"]


@pytest.fixture(scope="module")
def ref():
    with jax_reference() as kf:
        from kungfu_tpu import native as jnative

        yield jnative


def _operands(dtype, n=1001):
    rng = np.random.RandomState(7)
    if np.issubdtype(dtype, np.floating):
        return rng.randn(n).astype(dtype), rng.randn(n).astype(dtype)
    hi = min(np.iinfo(dtype).max, 11)  # small values so prod doesn't wrap
    return (rng.randint(1, hi, size=n).astype(dtype), rng.randint(1, hi, size=n).astype(dtype))


def test_native_library_builds_in_the_port():
    assert native.available()
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR and os.path.exists(path)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_transform2_matches_numpy(dtype, op):
    y, x = _operands(dtype)
    want = native.plain_transform2(y.copy(), x, op)
    got = native.transform2(y.copy(), x, op)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [1, 33, 100003])
def test_average_f32_matches_numpy(n):
    rng = np.random.RandomState(n)
    y = (rng.randn(n) * rng.uniform(1e-3, 1e3, n)).astype(np.float32)
    x = (rng.randn(n) * rng.uniform(1e-3, 1e3, n)).astype(np.float32)
    want = native.plain_average_f32(y.copy(), x)
    got = native.average_f32(y.copy(), x)
    assert got.tobytes() == want.tobytes()


def test_transform2_inplace_and_checks():
    y = np.ones(8, np.float32)
    out = native.transform2(y, np.full(8, 2.0, np.float32), "sum")
    assert out is y and y[0] == 3.0
    with pytest.raises(ValueError):
        native.transform2(np.ones(3, np.float32), np.ones(4, np.float32))
    with pytest.raises(ValueError):
        native.transform2(y, y.copy(), "avg")
    with pytest.raises(ValueError):
        native.average_f32(np.ones(3), np.ones(3))


def _make(mod, n=64, batch=8, **kw):
    data = np.arange(n, dtype=np.float32).reshape(n, 1)
    labels = np.arange(n, dtype=np.int32)
    return mod.BatchLoader(data, labels, batch, **kw)


@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_loader_order_and_reshard_match_jax(ref, shard):
    """25 batches (across epochs), then reshard(2, 4) and 10 more: the
    same batches as the JAX package's loader, whose library is built from
    the same csrc/."""
    a = _make(native, n=40, batch=4, seed=11, shard_rank=shard[0], shard_size=shard[1])
    b = _make(ref, n=40, batch=4, seed=11, shard_rank=shard[0], shard_size=shard[1])
    assert a._handle is not None and b._handle is not None
    assert a.steps_per_epoch == b.steps_per_epoch
    for step in range(35):
        if step == 25:
            a.reshard(2, 4)
            b.reshard(2, 4)
            assert a.steps_per_epoch == b.steps_per_epoch
        da, la = next(a)
        db, lb = next(b)
        np.testing.assert_array_equal(da, db, err_msg=f"step {step}")
        np.testing.assert_array_equal(la, lb, err_msg=f"step {step}")
    a.close()
    b.close()


def test_loader_native_matches_numpy_stream():
    a = _make(native, n=40, batch=4, seed=11)
    b = _make(native, n=40, batch=4, seed=11)
    b.close()  # the numpy stream
    for _ in range(25):  # crosses an epoch boundary
        da, la = next(a)
        db, lb = next(b)
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)
    a.close()


def test_loader_covers_epoch_once():
    ld = _make(native, n=64, batch=8, seed=3)
    seen = []
    for _ in range(ld.steps_per_epoch):
        d, lab = next(ld)
        assert d.shape == (8, 1) and lab.shape == (8,)
        np.testing.assert_array_equal(d[:, 0].astype(np.int32), lab)
        seen.extend(lab.tolist())
    assert sorted(seen) == list(range(64)) and seen != list(range(64))
    ld.close()


def test_loader_sharding_partitions():
    n, batch = 64, 4
    union = []
    for r in range(4):
        ld = _make(native, n=n, batch=batch, seed=5, shard_rank=r, shard_size=4)
        assert ld.steps_per_epoch == n // 4 // batch
        for _ in range(ld.steps_per_epoch):
            union.extend(next(ld)[1].tolist())
        ld.close()
    assert sorted(union) == list(range(n))


def test_loader_reshard_and_bad_shards():
    ld = _make(native, n=64, batch=8, seed=1, shard_rank=0, shard_size=2)
    next(ld)
    ld.reshard(1, 4)
    assert ld.steps_per_epoch == 2 and next(ld)[0].shape == (8, 1)
    with pytest.raises(ValueError):
        ld.reshard(4, 4)
    ld.close()
    for rank, size in ((4, 4), (-1, 2)):
        with pytest.raises(ValueError):
            _make(native, n=16, batch=4, shard_rank=rank, shard_size=size)


def test_loader_reshard_discards_prefetched_batches():
    ld = _make(native, n=64, batch=4, seed=2, shard_rank=0, shard_size=2, queue_cap=8)
    next(ld)  # prefetch fills with old-shard batches
    ld.reshard(1, 2)
    allowed = set(native._shuffled_perm(2, 0, 64)[1::2].tolist())
    seen = set()
    for _ in range(ld.steps_per_epoch - 1):
        seen.update(int(x) for x in next(ld)[1])
    assert seen <= allowed, f"stale old-shard samples delivered: {seen - allowed}"
    ld.close()


def test_build_failure_raises_with_the_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cpp").write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "CSRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build()
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "build"))


def test_no_compiler_runs_the_numpy_versions(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_no_compiler", False)
    assert native.build() is None and not native.available()
    y = np.full(5, 4.0, np.float32)
    native.average_f32(y, np.full(5, 2.0, np.float32))
    np.testing.assert_array_equal(y, 3.0)
    ld = _make(native, n=16, batch=4, seed=3)
    assert ld._handle is None and next(ld)[0].shape == (4, 1)
