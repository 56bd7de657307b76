"""Datasets: idx-format loaders + synthetic fallbacks + elastic adaptor
(counterpart of kungfu_tpu.datasets; the same arrays from the same seeds).

Reference: srcs/python/kungfu/tensorflow/v1/helpers/{mnist,cifar,imagenet}.py
(idx-format loaders) and the elastic BaseDatasetAdaptor
(v1/datasets/adaptor.py:4-33: skip -> batch -> shard driven by named state).

Nothing is downloaded: `synthetic_mnist` generates a deterministic
linearly-separable classification problem with MNIST shapes, so
convergence tests still mean something (accuracy rises above chance only
if the whole train loop works).  `load_mnist_idx` and `load_cifar10` read
local copies of the public files if they exist.
"""
from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


def _synthetic_images(
    shape: Tuple[int, ...], n: int, num_classes: int, seed: int, noise: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic classification data: per-class templates + noise."""
    rng = np.random.RandomState(seed)
    dim = int(np.prod(shape))
    templates = rng.randn(num_classes, dim).astype(np.float32)
    labels = rng.randint(0, num_classes, size=n)
    images = templates[labels] + noise * rng.randn(n, dim).astype(np.float32)
    return images.reshape((n,) + shape).astype(np.float32), labels.astype(np.int32)


def synthetic_mnist(
    n: int = 8192, num_classes: int = 10, seed: int = 42, noise: float = 0.35
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic 28x28 classification data: class templates + noise."""
    return _synthetic_images((28, 28, 1), n, num_classes, seed, noise)


def load_mnist_idx(data_dir: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Read train-images-idx3-ubyte(.gz) if present; else None."""

    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")

    for images_name in ("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"):
        ip = os.path.join(data_dir, images_name)
        lp = ip.replace("images-idx3", "labels-idx1")
        if not (os.path.exists(ip) and os.path.exists(lp)):
            continue
        with _open(ip) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols, 1)
        with _open(lp) as f:
            magic, n = struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), np.uint8).astype(np.int32)
        return images.astype(np.float32) / 255.0, labels
    return None


def mnist(data_dir: str = "./data") -> Tuple[np.ndarray, np.ndarray]:
    got = load_mnist_idx(data_dir)
    return got if got is not None else synthetic_mnist()


def load_cifar10(data_dir: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Read the public CIFAR-10 binary batches if present, else None.

    Reference helper parity (srcs/python/kungfu/tensorflow/v1/helpers/
    cifar): each record in data_batch_{1..5}.bin is 1 label byte + 3072
    CHW image bytes.  Returns NHWC float32 in [0, 1] + int32 labels.
    For ImageNet-scale data use the chunked idx directories in
    data_files (memory-mapped, file-sharded, elastic reshard).
    """
    names = [f"data_batch_{i}.bin" for i in range(1, 6)]
    paths = [os.path.join(data_dir, n) for n in names]
    # also accept the cifar-10-batches-bin subdir layout of the tarball
    sub = os.path.join(data_dir, "cifar-10-batches-bin")
    if not all(os.path.exists(p) for p in paths) and os.path.isdir(sub):
        paths = [os.path.join(sub, n) for n in names]
    if not all(os.path.exists(p) for p in paths):
        return None
    record = 1 + 3072
    images, labels = [], []
    for p in paths:
        with open(p, "rb") as f:
            raw = np.frombuffer(f.read(), np.uint8)
        if raw.size % record:
            raise ValueError(f"{p}: not a CIFAR-10 binary batch")
        raw = raw.reshape(-1, record)
        labels.append(raw[:, 0].astype(np.int32))
        chw = raw[:, 1:].reshape(-1, 3, 32, 32)
        images.append(chw.transpose(0, 2, 3, 1))  # -> NHWC
    return (
        np.concatenate(images).astype(np.float32) / 255.0,
        np.concatenate(labels),
    )


def synthetic_cifar10(n: int = 8192, seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-shaped synthetic data (same template trick as synthetic_mnist)."""
    return _synthetic_images((32, 32, 3), n, 10, seed, 0.35)


def cifar10(data_dir: str = "./data") -> Tuple[np.ndarray, np.ndarray]:
    got = load_cifar10(data_dir)
    return got if got is not None else synthetic_cifar10()


@dataclass
class ElasticDataAdaptor:
    """skip -> shard -> batch, resumable by global sample offset.

    Reference BaseDatasetAdaptor (v1/datasets/adaptor.py:4-33): after an
    elastic resize, training resumes from the allreduce-max'd trained-sample
    count; each worker then reads its rank-strided shard.
    """

    images: np.ndarray
    labels: np.ndarray
    batch_size: int  # per-worker batch
    rank: int = 0
    size: int = 1
    offset: int = 0  # global samples already consumed
    seed: int = 0

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.images)
        global_batch = self.batch_size * self.size
        usable = (n // global_batch) * global_batch  # whole batches per epoch
        if usable == 0:
            raise ValueError(f"dataset ({n}) smaller than global batch ({global_batch})")
        while True:
            # epoch/pos derived from the global offset, and the permutation
            # seeded per-epoch — a resumed iterator (same offset, any worker)
            # continues the exact same sample stream; if the global batch
            # changed across a resize, resume is approximate (offset rounds
            # into the new epoch geometry), matching the reference adaptor's
            # skip-based semantics (v1/datasets/adaptor.py:4-33)
            epoch = self.offset // usable
            pos = self.offset % usable
            pos -= pos % global_batch  # re-align after a batch-geometry change
            if pos + global_batch > usable:
                epoch += 1
                pos = 0
                self.offset = epoch * usable
            perm = np.random.RandomState((self.seed + epoch) & 0x7FFFFFFF).permutation(n)
            idx = perm[pos + self.rank * self.batch_size : pos + (self.rank + 1) * self.batch_size]
            yield self.images[idx], self.labels[idx]
            self.offset += global_batch
