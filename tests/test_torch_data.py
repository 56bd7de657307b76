"""The port's host modules of ROADMAP A.9 against the JAX package's:
`utils.stall`, `datasets`, `data_files`, `platforms` and `info`.

Where the JAX module computes something, the port's result is compared
with it on the same inputs: the synthetic datasets bit for bit, the idx
and CIFAR readers on files written here, the elastic adaptor's stream,
idx files written by either package read by the other, the chunked file
loader's batches against the JAX package's and against the in-memory
loader, cluster discovery from the same environments.  The stall
detector's warnings and its deadline are held as the JAX one's behave.
"""
from __future__ import annotations

import gzip
import json
import struct
import time

import numpy as np
import pytest

from _torch_reference import jax_reference
from kungfu_tpu_torch import data_files as df
from kungfu_tpu_torch import datasets, native, platforms
from kungfu_tpu_torch.info.__main__ import collect, main as info_main
from kungfu_tpu_torch.utils import stall


@pytest.fixture(scope="module")
def ref():
    with jax_reference() as kf:
        from kungfu_tpu import data_files as jdf
        from kungfu_tpu import datasets as jds
        from kungfu_tpu import platforms as jplat
        from kungfu_tpu.utils import stall as jstall

        yield jds, jdf, jplat, jstall


# -- utils.stall ------------------------------------------------------------------

@pytest.mark.parametrize("value", ["", "30", "2.5", "bad"])
def test_deadline_and_enabled_match_jax(ref, monkeypatch, value):
    jstall = ref[3]
    monkeypatch.setenv(stall.DEADLINE_ENV, value)
    monkeypatch.setenv(stall.ENABLED_ENV, "1" if value else "")
    assert stall.deadline_from_env() == jstall.deadline_from_env()
    assert stall.enabled() == jstall.enabled()
    assert stall.STALL_ABORT_EXIT_CODE == jstall.STALL_ABORT_EXIT_CODE == 87


def test_stall_deadline_fires_abort(tmp_path, monkeypatch):
    beat = tmp_path / "beat"
    monkeypatch.setenv(stall.HEARTBEAT_FILE_ENV, str(beat))
    fired = []
    with stall.stall_detector("op", period_s=0.02, deadline_s=0.1,
                              abort=lambda name, waited, dl: fired.append((name, dl))):
        time.sleep(0.4)
    assert fired == [("op", 0.1)] and beat.exists()


def test_stall_detector_off_is_a_plain_block(monkeypatch):
    monkeypatch.delenv(stall.DEADLINE_ENV, raising=False)
    monkeypatch.delenv(stall.ENABLED_ENV, raising=False)
    fired = []
    with stall.stall_detector("op", period_s=0.01, abort=lambda *a: fired.append(a)):
        time.sleep(0.05)
    assert not fired


def test_stall_exit_code_on_deadline(tmp_path):
    """The default abort ends the process with exit code 87."""
    import subprocess
    import sys

    from _torch_ranks import REPO

    code = ("import time\nfrom kungfu_tpu_torch.utils.stall import stall_detector\n"
            "with stall_detector('hang', period_s=0.05, deadline_s=0.2):\n    time.sleep(30)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 87 and "stalled" in proc.stderr


# -- datasets ----------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("synthetic_mnist", dict(n=257, seed=3)),
                                     ("synthetic_mnist", {}),
                                     ("synthetic_cifar10", dict(n=64, seed=9))])
def test_synthetic_datasets_match_jax(ref, name, kw):
    x, y = getattr(datasets, name)(**kw)
    jx, jy = getattr(ref[0], name)(**kw)
    assert x.dtype == jx.dtype and x.shape == jx.shape and x.tobytes() == jx.tobytes()
    assert y.dtype == jy.dtype and y.tobytes() == jy.tobytes()


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx_matches_jax(ref, tmp_path, gz):
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (12, 28, 28), dtype=np.uint8)
    labs = rng.randint(0, 10, 12).astype(np.uint8)
    suffix = ".gz" if gz else ""
    opener = gzip.open if gz else open
    with opener(tmp_path / f"train-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 12, 28, 28) + imgs.tobytes())
    with opener(tmp_path / f"train-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">II", 2049, 12) + labs.tobytes())
    x, y = datasets.mnist(str(tmp_path))
    jx, jy = ref[0].mnist(str(tmp_path))
    assert x.shape == (12, 28, 28, 1)
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
    assert datasets.load_mnist_idx(str(tmp_path / "nope")) is None


def test_cifar10_binary_matches_jax(ref, tmp_path):
    rng = np.random.RandomState(0)
    sub = tmp_path / "cifar-10-batches-bin"
    sub.mkdir()
    for i in range(1, 6):
        labs = rng.randint(0, 10, size=3).astype(np.uint8)
        imgs = rng.randint(0, 256, size=(3, 3 * 32 * 32), dtype=np.uint8)
        record = np.concatenate([labs[:, None], imgs], 1)
        (sub / f"data_batch_{i}.bin").write_bytes(record.tobytes())
    x, y = datasets.cifar10(str(tmp_path))
    jx, jy = ref[0].cifar10(str(tmp_path))
    assert x.shape == (15, 32, 32, 3)
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
    assert datasets.load_cifar10(str(tmp_path / "nope")) is None
    (sub / "data_batch_1.bin").write_bytes(b"\x00" * 10)
    with pytest.raises(ValueError, match="not a CIFAR-10"):
        datasets.load_cifar10(str(tmp_path))


@pytest.mark.parametrize("size,resize_at", [(1, None), (3, 4)])
def test_elastic_adaptor_matches_jax(ref, size, resize_at):
    """The batches of every rank, and after a resize (a new adaptor at the
    consumed offset with another size), equal to the JAX adaptor's."""
    images, labels = datasets.synthetic_mnist(n=50, seed=2)
    for rank in range(size):
        args = dict(images=images, labels=labels, batch_size=4, rank=rank, size=size, seed=5)
        mine, theirs = datasets.ElasticDataAdaptor(**args), ref[0].ElasticDataAdaptor(**args)
        a, b = iter(mine), iter(theirs)
        for step in range(12):
            if step == resize_at:
                args.update(size=2, rank=rank % 2, offset=mine.offset)
                mine = datasets.ElasticDataAdaptor(**args)
                theirs = ref[0].ElasticDataAdaptor(**args)
                a, b = iter(mine), iter(theirs)
            (x, y), (jx, jy) = next(a), next(b)
            assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes(), (rank, step)
        assert mine.offset == theirs.offset
    with pytest.raises(ValueError, match="smaller than global batch"):
        next(iter(datasets.ElasticDataAdaptor(images[:3], labels[:3], batch_size=4)))


# -- data_files --------------------------------------------------------------------

def _write_ds(mod, path, n=50, chunk=16, shape=(8, 8, 3)):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, size=(n, *shape)).astype(np.uint8)
    labels = rng.randint(0, 10, size=n).astype(np.int32)
    mod.write_chunks(str(path), images, labels, samples_per_chunk=chunk)
    return images, labels


@pytest.mark.parametrize("arr", [np.arange(24, dtype=np.uint8).reshape(2, 3, 4),
                                 np.random.RandomState(0).randn(5, 7).astype(np.float32),
                                 np.array([1, -2, 3], np.int32),
                                 np.random.RandomState(1).randn(2, 2).astype(np.float64)])
def test_idx_files_interchange_with_jax(ref, tmp_path, arr):
    jdf = ref[1]
    df.write_idx(str(tmp_path / "p.idx"), arr)
    jdf.write_idx(str(tmp_path / "j.idx"), arr)
    assert (tmp_path / "p.idx").read_bytes() == (tmp_path / "j.idx").read_bytes()
    for path in ("p.idx", "j.idx"):
        path = str(tmp_path / path)
        assert df.read_idx_header(path) == jdf.read_idx_header(path)
        got = np.asarray(df.mmap_idx(path))
        assert got.dtype == arr.dtype and got.shape == arr.shape and got.tobytes() == arr.tobytes()
    with pytest.raises(ValueError, match="no idx code"):
        df.write_idx(str(tmp_path / "x.idx"), np.zeros(2, np.uint16))


def test_file_dataset_chunks_and_take(tmp_path):
    images, labels = _write_ds(df, tmp_path, n=50, chunk=16)
    ds = df.FileDataset(str(tmp_path))
    assert len(ds) == 50 and ds.chunk_sizes == [16, 16, 16, 2] and ds.sample_shape == (8, 8, 3)
    idx = [0, 15, 16, 31, 32, 47, 48, 49]
    d, lab = ds.take(idx)
    np.testing.assert_array_equal(d, images[idx])
    np.testing.assert_array_equal(lab, labels[idx])


def test_file_loader_matches_jax_and_in_ram(ref, tmp_path):
    """The port's chunked loader over files the JAX package wrote: the
    JAX chunked loader's batches, the in-RAM loader's, and its own numpy
    stream's, over 2 epochs and a reshard."""
    jdf = ref[1]
    images, labels = _write_ds(jdf, tmp_path, n=40, chunk=7)
    loaders = [df.FileBatchLoader(df.FileDataset(str(tmp_path)), batch_size=8, seed=3),
               jdf.FileBatchLoader(jdf.FileDataset(str(tmp_path)), batch_size=8, seed=3),
               native.BatchLoader(images, labels, batch_size=8, seed=3),
               df.FileBatchLoader(df.FileDataset(str(tmp_path)), batch_size=8, seed=3)]
    assert loaders[0]._handle is not None
    loaders[3].close()  # the numpy stream
    for step in range(14):
        if step == 10:
            for ld in loaders:
                ld.reshard(1, 2)
        got = [next(ld) for ld in loaders]
        for d, lab in got[1:]:
            np.testing.assert_array_equal(got[0][0], d, err_msg=f"step {step}")
            np.testing.assert_array_equal(got[0][1], lab, err_msg=f"step {step}")
    for ld in loaders:
        ld.close()


def test_file_loader_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        df.FileDataset(str(tmp_path))
    with pytest.raises(ValueError):
        df.write_chunks(str(tmp_path), np.zeros((4, 2, 2), np.uint8), np.zeros(3, np.int32))
    _write_ds(df, tmp_path, n=10, chunk=10)
    ds = df.FileDataset(str(tmp_path))
    with pytest.raises(ValueError):
        df.FileBatchLoader(ds, batch_size=2, shard_rank=3, shard_size=2)
    ld = df.FileBatchLoader(ds, batch_size=2)
    with pytest.raises(ValueError):
        ld.reshard(5, 2)
    ld.close()


# -- platforms and info --------------------------------------------------------------

ENVS = [
    {},
    {"TPU_WORKER_HOSTNAMES": "h0,h1,h2", "TPU_WORKER_ID": "1"},
    {"KFT_HOSTS": "10.0.0.1:2,10.0.0.2:2", "KFT_SELF_HOST": "10.0.0.2"},
    {"KFT_HOSTS": "10.0.0.1:4", "KFT_NP": "3"},
]


@pytest.mark.parametrize("env", ENVS)
def test_discover_matches_jax(ref, env):
    jplat = ref[2]
    got, want = platforms.discover(env), jplat.discover(env)
    if want is None:
        assert got is None
        return
    (cluster, host), (jcluster, jhost) = got, want
    assert host == jhost and cluster.size() == jcluster.size()
    assert [str(p) for p in cluster.workers] == [str(p) for p in jcluster.workers]
    assert [str(p) for p in cluster.runners] == [str(p) for p in jcluster.runners]


def test_discover_refuses_a_bad_worker_id(ref):
    env = {"TPU_WORKER_HOSTNAMES": "h0,h1", "TPU_WORKER_ID": "2"}
    for mod in (platforms, ref[2]):
        with pytest.raises(ValueError, match="out of range"):
            mod.discover(env)


def test_info(capsys, monkeypatch):
    env = {"KFT_HOSTS": "10.0.0.1:2", "KFT_SELF_SPEC": "10.0.0.1:10000", "OTHER": "x"}
    info = collect("cpu", env)
    assert info["framework"] == "kungfu_tpu_torch" and "devices" not in info
    assert info["env"] == {"KFT_HOSTS": "10.0.0.1:2", "KFT_SELF_SPEC": "10.0.0.1:10000"}
    assert info["platform_cluster"] == {"size": 2, "self": "10.0.0.1"}
    monkeypatch.setenv("KFT_X", "1")
    assert info_main(["--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed["env"]["KFT_X"] == "1" and "torch" in printed
