"""ctypes bindings to the native host library (counterpart of
kungfu_tpu.native), built from the repository's root `csrc/`
(`transform2.cpp`, `dataloader.cpp`).

The host-side hot loops, with numpy plain versions of the same results:

  * ``transform2``  elementwise y <- y OP x (SUM/MIN/MAX/PROD), the blob
    store's aggregation without a round trip through torch,
  * ``average_f32`` the gossip model-average kernel,
  * ``BatchLoader`` threaded shuffled-gather batches with a deterministic
    order and elastic resharding (splitmix64 Fisher-Yates in both).

The library is compiled with g++ on first use, never at import, into
`kungfu_tpu_torch/_build/` (listed in .gitignore) under a name that
carries a hash of the sources, the flags and the host (`-march=native`
code must not run on another CPU), and under a file lock, so ranks that
start together build it once.  Without g++ (or with KUNGFU_NO_NATIVE
set) every entry point runs its numpy version; with g++ a failed build
raises with the compiler's output rather than falling back quietly.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from .utils import get_logger

log = get_logger("kungfu.native")

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-march=native"]

_OPS = {"sum": 0, "min": 1, "max": 2, "prod": 3}
_NP_OPS = {"sum": np.add, "min": np.minimum, "max": np.maximum, "prod": np.multiply}

_DTYPES = {
    np.dtype(np.uint8): 0, np.dtype(np.int8): 1,
    np.dtype(np.uint16): 2, np.dtype(np.int16): 3,
    np.dtype(np.uint32): 4, np.dtype(np.int32): 5,
    np.dtype(np.uint64): 6, np.dtype(np.int64): 7,
    np.dtype(np.float32): 8, np.dtype(np.float64): 9,
    np.dtype(np.float16): 10,
}

_P, _I, _I64, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
# (restype, argtypes) of every exported function
_SIGNATURES = {
    "kft_transform2": (_I, [_P, _P, _I64, _I, _I]),
    "kft_average_f32": (_I, [_P, _P, _I64]),
    "kft_loader_create": (_P, [_P, _P, _I64, _I64, _I64, _I64, _U64, _I, _I, _I, _I]),
    "kft_loader_create_chunked": (_P, [ctypes.POINTER(_P), ctypes.POINTER(_P),
                                       ctypes.POINTER(_I64), _I, _I64, _I64, _I64, _U64,
                                       _I, _I, _I, _I]),
    "kft_loader_next": (_I, [_P, _P, _P]),
    "kft_loader_steps_per_epoch": (_I64, [_P]),
    "kft_loader_reshard": (_I, [_P, _I, _I]),
    "kft_loader_destroy": (None, [_P]),
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_no_compiler = False


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cpp"))


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS + [platform.machine(), platform.node()]).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libkungfu_host-{h.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """Compile csrc/*.cpp into the build directory unless built already;
    the library's path, or None without g++.  Raises if g++ fails."""
    path = _lib_path()
    if os.path.exists(path):
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):  # another process built it meanwhile
            return path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([gxx, *GXX_FLAGS, *_sources(), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed to build the native host library "
                               f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None without g++ or with
    KUNGFU_NO_NATIVE set (the numpy versions run)."""
    global _lib, _no_compiler
    if _lib is not None or _no_compiler or os.environ.get("KUNGFU_NO_NATIVE"):
        return _lib
    with _lib_lock:
        if _lib is None and not _no_compiler:
            path = build()
            if path is None:
                log.warning("g++ not found: the native host library runs its numpy versions")
                _no_compiler = True
                return None
            lib = ctypes.CDLL(path)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


# --- transform2 ---------------------------------------------------------------


def plain_transform2(y: np.ndarray, x: np.ndarray, op: str = "sum") -> np.ndarray:
    """numpy's y <- y OP x, in place."""
    return _NP_OPS[op](y, x, out=y)


def plain_average_f32(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """numpy's y <- 0.5 * (y + x), in place."""
    y += x
    y *= 0.5
    return y


def transform2(y: np.ndarray, x: np.ndarray, op: str = "sum") -> np.ndarray:
    """In-place y <- y OP x.  Arrays must share shape and dtype."""
    if y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError(f"shape/dtype mismatch: {y.shape}/{y.dtype} vs {x.shape}/{x.dtype}")
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; want one of {sorted(_OPS)}")
    lib = _load()
    code = _DTYPES.get(y.dtype)
    if lib is not None and code is not None and y.flags.c_contiguous and x.flags.c_contiguous:
        if lib.kft_transform2(y.ctypes.data, x.ctypes.data, y.size, code, _OPS[op]) == 0:
            return y
    return plain_transform2(y, x, op)


def average_f32(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """In-place y <- 0.5 * (y + x), float32 (the gossip blob-average kernel)."""
    if y.dtype != np.float32 or x.dtype != np.float32:
        raise ValueError("average_f32 needs float32")
    if y.shape != x.shape:
        raise ValueError(f"shape mismatch: {y.shape} vs {x.shape}")
    lib = _load()
    if lib is not None and y.flags.c_contiguous and x.flags.c_contiguous:
        if lib.kft_average_f32(y.ctypes.data, x.ctypes.data, y.size) == 0:
            return y
    return plain_average_f32(y, x)


# --- loader -------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _splitmix64_stream(state: int):
    while True:
        state = (state + 0x9E3779B97F4A7C15) & _MASK64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        yield z ^ (z >> 31)


def _shuffled_perm(seed: int, epoch: int, n: int) -> np.ndarray:
    """Fisher-Yates with splitmix64, bit-identical to csrc/dataloader.cpp."""
    perm = np.arange(n, dtype=np.int64)
    stream = _splitmix64_stream((seed * 0x9E3779B97F4A7C15 + epoch + 1) & _MASK64)
    for i in range(n - 1, 0, -1):
        j = next(stream) % (i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    return perm


class StreamLoaderBase:
    """Shared stream semantics of the batch loaders: a deterministic
    splitmix64 plan a epoch, rank-strided sharding, generation-fenced
    reshard, the same batches from the native loader and the numpy one.

    Subclasses set ``self._handle`` (native loader or None) in __init__
    and provide ``_n`` (dataset size), ``_alloc()`` (batch output arrays)
    and ``_take(indices)`` (the numpy gather)."""

    batch_size: int
    seed: int
    shard_rank: int
    shard_size: int
    _handle = None
    _seq: int = 0
    _plan_cache: Optional[Tuple[int, np.ndarray]] = None

    def _init_stream(self, batch_size: int, seed: int, shard_rank: int,
                     shard_size: int) -> None:
        if not (0 <= shard_rank < shard_size):
            raise ValueError(f"bad shard {shard_rank}/{shard_size}")
        self.batch_size = batch_size
        self.seed = seed
        self.shard_rank = shard_rank
        self.shard_size = shard_size
        self._handle = None
        self._seq = 0
        self._plan_cache = None

    @property
    def _n(self) -> int:
        raise NotImplementedError

    def _alloc(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _take(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    @property
    def steps_per_epoch(self) -> int:
        if self._handle is not None:
            return int(_load().kft_loader_steps_per_epoch(self._handle))
        n = self._n
        shard_n = n // self.shard_size + (1 if (n % self.shard_size) > self.shard_rank else 0)
        return shard_n // self.batch_size

    def reshard(self, shard_rank: int, shard_size: int) -> None:
        if not (0 <= shard_rank < shard_size):
            raise ValueError(f"bad shard {shard_rank}/{shard_size}")
        self.shard_rank, self.shard_size = shard_rank, shard_size
        self._plan_cache = None
        if self._handle is not None:
            if _load().kft_loader_reshard(self._handle, shard_rank, shard_size) != 0:
                raise ValueError(f"bad shard {shard_rank}/{shard_size}")

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        out_d, out_l = self._alloc()
        if self._handle is not None:
            if _load().kft_loader_next(self._handle, out_d.ctypes.data, out_l.ctypes.data) != 0:
                raise StopIteration
            return out_d, out_l
        spe = max(self.steps_per_epoch, 1)
        epoch, step = divmod(self._seq, spe)
        self._seq += 1
        plan = self._plain_plan(epoch)
        idx = [plan[(step * self.batch_size + b) % len(plan)] for b in range(self.batch_size)]
        out_d[...], out_l[...] = self._take(idx)
        return out_d, out_l

    def __iter__(self):
        return self

    def _plain_plan(self, epoch: int) -> np.ndarray:
        if self._plan_cache is not None and self._plan_cache[0] == epoch:
            return self._plan_cache[1]
        perm = _shuffled_perm(self.seed, epoch, self._n)
        plan = perm[self.shard_rank::self.shard_size]
        if len(plan) == 0:
            plan = np.zeros(1, np.int64)
        self._plan_cache = (epoch, plan)
        return plan

    def close(self) -> None:
        if self._handle is not None:
            _load().kft_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - gc-time best effort, nothing to report to
            pass


class BatchLoader(StreamLoaderBase):
    """Deterministic shuffled-gather batch stream with threaded prefetch.

    Feeds (data, labels) numpy batches.  With the native library the
    gathering and prefetch run in C++ worker threads; otherwise the same
    stream in numpy.  ``reshard(rank, size)`` re-slices the epoch's
    permutation after an elastic resize (reference v1/datasets/adaptor.py)."""

    def __init__(self, data: np.ndarray, labels: np.ndarray, batch_size: int, seed: int = 0,
                 shard_rank: int = 0, shard_size: int = 1, threads: int = 2,
                 queue_cap: int = 4):
        if len(data) != len(labels):
            raise ValueError("data/labels length mismatch")
        self._init_stream(batch_size, seed, shard_rank, shard_size)
        self.data = np.ascontiguousarray(data)
        self.labels = np.ascontiguousarray(labels)
        self._sample_shape = self.data.shape[1:]
        self._label_shape = self.labels.shape[1:]
        self._sample_bytes = int(self.data.dtype.itemsize * np.prod(self._sample_shape or (1,)))
        self._label_bytes = int(self.labels.dtype.itemsize * np.prod(self._label_shape or (1,)))
        lib = _load()
        if lib is not None:
            h = lib.kft_loader_create(self.data.ctypes.data, self.labels.ctypes.data,
                                      len(self.data), self._sample_bytes, self._label_bytes,
                                      batch_size, seed, shard_rank, shard_size, threads,
                                      queue_cap)
            self._handle = h or None

    @property
    def _n(self) -> int:
        return len(self.data)

    def _alloc(self) -> Tuple[np.ndarray, np.ndarray]:
        return (np.empty((self.batch_size, *self._sample_shape), self.data.dtype),
                np.empty((self.batch_size, *self._label_shape), self.labels.dtype))

    def _take(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        return self.data[indices], self.labels[indices]
