"""Build and load the package's CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` into its own shared library
with a plain C interface, loaded with ctypes.  The libraries land in
`kungfu_tpu_torch/_build/` (listed in .gitignore) under a name that
carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  The first call builds every
source at once, one `nvcc` process each.  Processes that start together
(the ranks of one host) build one at a time under a file lock, so the
first builds and the others load what it built.  Nothing is built at
import: the CPU has no compiler and needs none.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _U = ctypes.c_longlong, ctypes.c_ulonglong
_PP = ctypes.POINTER(ctypes.c_void_p)
_LP = ctypes.POINTER(ctypes.c_longlong)
# own, right, n, rank, max_blocks, slots, slot_bytes, chunk, blocks, seq, ack_want,
# timeout_ns, err, stream (csrc/ring_common.cuh KFT_RING_PARAMS)
_RING = [_P, _P, _I, _I, _I, _L, _L, _L, _I, _U, _U, _U, _P, _P]
# C signature of every exported function: (argtypes, source stem); each
# returns a CUDA error code unless RESTYPES says otherwise
SIGNATURES = {
    "kft_flash_fwd": (
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P], "flash_fwd"),
    "kft_flash_bwd_dq": (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P], "flash_bwd"),
    "kft_flash_bwd_dkv": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P], "flash_bwd"),
    "kft_flash_bwd_dkv_gqa": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P], "flash_bwd"),
    "kft_ring_rs": ([_LP, _I, _I] + _RING, "ring"),
    "kft_ring_ag": ([_LP, _I, _I] + _RING, "ring"),
    "kft_ring_frs": ([_P, _L, _P, _I, _I, _F] + _RING, "ring"),
    "kft_ring_fag": ([_P, _P, _L, _I, _I, _F] + _RING, "ring"),
    "kft_ring_shift": ([_P, _P, _L, _P, _P, _L, _I] + _RING, "ring"),
    "kft_ef_residual": ([_LP, _I, _I, _I, _F, _P], "ring"),
    "kft_ag_matmul": ([_P, _P, _P, _I, _I, _I, _I] + _RING, "fused_matmul"),
    "kft_matmul_rs": ([_P, _P, _P, _I, _I, _I, _I] + _RING, "fused_matmul"),
    "kft_mm_product": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], "fused_matmul"),
    "kft_ring_header_bytes": ([_I, _I], "ring"),
    "kft_ws_alloc": ([_I, _L, _PP, _P], "ring"),
    "kft_ws_open": ([_I, _P, _PP], "ring"),
    "kft_ws_close": ([_I, _P], "ring"),
    "kft_ws_free": ([_I, _P], "ring"),
    "kft_host_alloc": ([_L, _PP], "ring"),
    "kft_host_free": ([_P], "ring"),
}
RESTYPES = {"kft_ring_header_bytes": _L}
SOURCES = sorted({stem for _, stem in SIGNATURES.values()})

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[str, object] = {}  # name -> the C function, its types set
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _lib_path(stem: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name == f"{stem}.cu" or name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns {source stem: library path}.  The compiler's resource report
    (`-Xptxas -v`) is kept beside each library as `<lib>.log`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {stem: _lib_path(stem) for stem in SOURCES}
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        _build_missing(paths)
    return paths


def _build_missing(paths: Dict[str, str]) -> None:
    todo = {s: p for s, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return
    nvcc = _nvcc()
    procs = {}
    for stem, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    failed = []
    for stem, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        build_seconds[stem] = time.perf_counter() - t0
        with open(paths[stem] + ".log", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{stem}.cu (exit {proc.returncode}):\n{out[-4000:]}")
        else:
            os.replace(tmp, paths[stem])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def function(name: str):
    """The exported C function `name`, building its library on first use."""
    fn = _functions.get(name)
    if fn is not None:
        return fn
    argtypes, stem = SIGNATURES[name]
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            for s, path in build_all().items():
                _libs[s] = ctypes.CDLL(path)
            lib = _libs[stem]
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
        _functions[name] = fn
    return fn
