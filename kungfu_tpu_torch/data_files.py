"""File-backed datasets: sharded idx chunks + memory-mapped batch loading
(counterpart of kungfu_tpu.data_files).

Reference role: srcs/python/kungfu/tensorflow/v1/helpers/{mnist,cifar,
imagenet}.py — idx-format loaders feeding the input pipeline.  This module
is the scale-ready redesign: a dataset is a DIRECTORY of idx chunk pairs

    chunk-00000.images.idx   chunk-00000.labels.idx
    chunk-00001.images.idx   chunk-00001.labels.idx
    ...

each a standard idx file (the public MNIST/CIFAR container: big-endian
magic 0x00 0x00 <dtype> <ndim>, then dims, then raw data).  Chunks let
hosts read in parallel, keep per-file sizes bounded, and make the on-disk
layout trivially shardable.  Reading memory-maps every chunk (zero-copy —
the OS page cache is the buffer pool) and hands the mapped spans to the
native chunked BatchLoader (csrc/dataloader.cpp:kft_loader_create_chunked),
whose C++ worker threads gather shuffled batches straight from the maps.

Elastic resharding is inherited from the loader: reshard(rank, size)
re-slices the deterministic per-epoch permutation, so after a cluster
resize every worker continues from the same global sample stream
(reference v1/datasets/adaptor.py:4-33 semantics).
"""
from __future__ import annotations

import ctypes
import os
import re
import struct
from typing import List, Sequence, Tuple

import numpy as np

from . import native
from .utils import get_logger

log = get_logger("kungfu.data")

# idx dtype codes (the public idx spec)
_IDX_DTYPES = {
    0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
    0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64,
}
_IDX_CODES = {np.dtype(v): k for k, v in _IDX_DTYPES.items()}

_CHUNK_RE = re.compile(r"^chunk-(\d+)\.images\.idx$")


def write_idx(path: str, arr: np.ndarray) -> None:
    """Write one array as an idx file."""
    arr = np.ascontiguousarray(arr)
    code = _IDX_CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"dtype {arr.dtype} has no idx code")
    with open(path, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, code, arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def read_idx_header(path: str) -> Tuple[np.dtype, Tuple[int, ...], int]:
    """(dtype, shape, data_offset) of an idx file without reading the data."""
    with open(path, "rb") as f:
        z0, z1, code, ndim = struct.unpack(">BBBB", f.read(4))
        if z0 != 0 or z1 != 0 or code not in _IDX_DTYPES:
            raise ValueError(f"{path}: not an idx file")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.dtype(_IDX_DTYPES[code]), tuple(shape), 4 + 4 * ndim


def mmap_idx(path: str) -> np.ndarray:
    """Memory-map an idx file's data (zero-copy, read-only)."""
    dtype, shape, off = read_idx_header(path)
    return np.memmap(path, dtype=dtype, mode="r", offset=off, shape=shape)


def write_chunks(
    out_dir: str,
    images: np.ndarray,
    labels: np.ndarray,
    samples_per_chunk: int = 4096,
) -> List[str]:
    """Write (images, labels) as a chunked idx dataset directory."""
    if len(images) != len(labels):
        raise ValueError("images/labels length mismatch")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for ci, start in enumerate(range(0, len(images), samples_per_chunk)):
        end = min(start + samples_per_chunk, len(images))
        ip = os.path.join(out_dir, f"chunk-{ci:05d}.images.idx")
        lp = os.path.join(out_dir, f"chunk-{ci:05d}.labels.idx")
        write_idx(ip, images[start:end])
        write_idx(lp, labels[start:end])
        paths.append(ip)
    return paths


class FileDataset:
    """A chunked idx dataset directory, memory-mapped on open."""

    def __init__(self, data_dir: str):
        # numeric sort: lexicographic order breaks on non-uniform digit
        # widths (chunk-2 vs chunk-10) and at the 100000-chunk rollover
        names = sorted(
            (f for f in os.listdir(data_dir) if _CHUNK_RE.match(f)),
            key=lambda f: int(_CHUNK_RE.match(f).group(1)),
        )
        if not names:
            raise FileNotFoundError(f"no chunk-*.images.idx files in {data_dir}")
        self.dir = data_dir
        self.images: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []
        for name in names:
            imgs = mmap_idx(os.path.join(data_dir, name))
            labs = mmap_idx(
                os.path.join(data_dir, name.replace(".images.", ".labels."))
            )
            if len(imgs) != len(labs):
                raise ValueError(f"{name}: images/labels length mismatch")
            self.images.append(imgs)
            self.labels.append(labs)
        first = self.images[0]
        self.sample_shape = first.shape[1:]
        self.sample_dtype = first.dtype
        self.label_shape = self.labels[0].shape[1:]
        self.label_dtype = self.labels[0].dtype
        for imgs, labs in zip(self.images, self.labels):
            if imgs.shape[1:] != self.sample_shape or imgs.dtype != self.sample_dtype:
                raise ValueError("inconsistent image chunk shapes/dtypes")
            if labs.shape[1:] != self.label_shape or labs.dtype != self.label_dtype:
                raise ValueError("inconsistent label chunk shapes/dtypes")
        self.chunk_sizes = [len(c) for c in self.images]
        self.n = sum(self.chunk_sizes)
        self._starts = np.cumsum([0] + self.chunk_sizes)

    def __len__(self) -> int:
        return self.n

    def take(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """Gather samples by global index (python path; the native loader
        does this in C++)."""
        ci = np.searchsorted(self._starts, np.asarray(indices), side="right") - 1
        imgs = np.stack(
            [self.images[c][i - self._starts[c]] for c, i in zip(ci, indices)]
        )
        labs = np.stack(
            [self.labels[c][i - self._starts[c]] for c, i in zip(ci, indices)]
        )
        return imgs, labs


class FileBatchLoader(native.StreamLoaderBase):
    """Threaded shuffled-gather batches straight from a FileDataset's maps.

    Same stream semantics as native.BatchLoader (shared StreamLoaderBase:
    identical splitmix64 Fisher-Yates plan, deterministic delivery order,
    generation-fenced reshard) — batches are bit-identical between the
    native chunked loader and the python fallback.
    """

    def __init__(
        self,
        dataset: FileDataset,
        batch_size: int,
        seed: int = 0,
        shard_rank: int = 0,
        shard_size: int = 1,
        threads: int = 4,
        queue_cap: int = 8,
    ):
        self._init_stream(batch_size, seed, shard_rank, shard_size)
        self.ds = dataset
        self._sample_bytes = int(
            dataset.sample_dtype.itemsize * np.prod(dataset.sample_shape or (1,))
        )
        self._label_bytes = int(
            dataset.label_dtype.itemsize * np.prod(dataset.label_shape or (1,))
        )
        lib = native._load()
        if lib is not None:
            nchunks = len(dataset.images)
            DataPtrs = ctypes.c_void_p * nchunks
            datas = DataPtrs(*[c.ctypes.data for c in dataset.images])
            labels = DataPtrs(*[c.ctypes.data for c in dataset.labels])
            ns = (ctypes.c_int64 * nchunks)(*dataset.chunk_sizes)
            h = lib.kft_loader_create_chunked(
                datas, labels, ns, nchunks,
                self._sample_bytes, self._label_bytes, batch_size, seed,
                shard_rank, shard_size, threads, queue_cap,
            )
            self._handle = h or None
        if self._handle is None:
            log.info("file loader: gathering in numpy")

    @property
    def _n(self) -> int:
        return self.ds.n

    def _alloc(self) -> Tuple[np.ndarray, np.ndarray]:
        ds = self.ds
        return (
            np.empty((self.batch_size, *ds.sample_shape), ds.sample_dtype),
            np.empty((self.batch_size, *ds.label_shape), ds.label_dtype),
        )

    def _take(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        return self.ds.take(indices)
