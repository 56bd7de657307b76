"""Checkpoint integrity manifests: never trust bytes that do not checksum
(counterpart of kungfu_tpu.resilience.manifest).

After a step directory is written, the primary writes
``<dir>/<N>/kft_manifest.json`` through a temporary file and an atomic
``os.replace``; the manifest is the real finalization marker:

    {"version": 1, "step": N, "cluster_version": V, "structure": <sha256 of
     the tree's skeleton>, "leaves": [{"path", "dtype", "shape", "bytes",
     "crc32"}, ...], "meta": {...}, "t_wall": ...}

Checksums are zlib.crc32 over each leaf's C-order host bytes.  The leaves,
their paths and their order are the JAX package's: a dict's entries in
sorted key order, a list's or tuple's by index, a namedtuple's by field
name, path entries joined by "/"; a leaf is an array (a torch tensor or a
numpy array) or a Python scalar, and None is an empty subtree.  So for
the same leaves under the same paths a manifest is the JAX package's
byte for byte, `t_wall` aside, and either package verifies the other's.
A tensor's record is that of its numpy array; a bfloat16 tensor, which
numpy has no type for, is recorded as the JAX package records a bfloat16
array (ml_dtypes' bfloat16, dtype string "<V2"): its dtype string, and
its 16-bit patterns as its bytes.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MANIFEST_VERSION = 1
MANIFEST_NAME = "kft_manifest.json"
BF16_DTYPE_STR = "<V2"  # numpy's dtype.str of ml_dtypes.bfloat16


class CheckpointIntegrityError(RuntimeError):
    """Restored bytes disagree with the step's manifest."""


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(path entry, child) pairs of a container node in the JAX package's
    flatten order; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the deterministic flatten order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix: Tuple[str, ...]):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append(("/".join(prefix), node))
            return
        for key, child in kids:
            walk(child, prefix + (key,))

    walk(tree, ())
    return out


def host_bytes(leaf: Any) -> Tuple[str, List[int], bytes]:
    """(dtype string, shape, C-order bytes) of a leaf as numpy records it."""
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return BF16_DTYPE_STR, list(t.shape), t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf, order="C")
    return arr.dtype.str, list(arr.shape), arr.tobytes()


def _leaf_record(path: str, leaf: Any) -> Dict[str, Any]:
    dtype, shape, data = host_bytes(leaf)
    return {"path": path, "dtype": dtype, "shape": shape, "bytes": len(data),
            "crc32": zlib.crc32(data) & 0xFFFFFFFF}


def _skeleton_dtype(leaf: Any) -> Tuple[str, tuple]:
    """(dtype string, shape) of a leaf as numpy records it, without a copy."""
    import torch

    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return BF16_DTYPE_STR, tuple(leaf.shape)
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype.str, tuple(leaf.shape)
    arr = np.asarray(leaf)
    return arr.dtype.str, tuple(arr.shape)


def structure_hash(tree: Any) -> str:
    """sha256 of the tree's skeleton (paths, dtypes and shapes, not values)."""
    parts = []
    for path, leaf in flatten_with_paths(tree):
        dtype, shape = _skeleton_dtype(leaf)
        parts.append(f"{path}:{dtype}:{shape}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def build_manifest(step: int, host_state: Any, meta: Optional[Dict[str, Any]] = None,
                   cluster_version: Optional[int] = None) -> Dict[str, Any]:
    """The integrity manifest of one checkpoint step: one crc pass over the
    host state the writer holds."""
    return {
        "version": MANIFEST_VERSION,
        "step": int(step),
        "cluster_version": cluster_version,
        "structure": structure_hash(host_state),
        "leaves": [_leaf_record(p, leaf) for p, leaf in flatten_with_paths(host_state)],
        "meta": dict(meta or {}),
        "t_wall": round(time.time(), 6),
    }


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, str(step), MANIFEST_NAME)


def write_manifest(directory: str, manifest: Dict[str, Any]) -> str:
    """Commit a manifest through a temporary file and an atomic rename: a
    crash before the rename leaves a step with arrays and no manifest,
    detectably torn, never silently trusted."""
    path = manifest_path(directory, manifest["step"])
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_manifest(directory: str, step: int) -> Optional[Dict[str, Any]]:
    """The step's manifest, or None when missing or unparseable (torn)."""
    try:
        with open(manifest_path(directory, step), encoding="utf-8") as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(m, dict) or m.get("version") != MANIFEST_VERSION:
        return None
    if int(m.get("step", -1)) != int(step) or "leaves" not in m:
        return None
    return m


def verify_manifest(manifest: Dict[str, Any], restored: Any) -> List[str]:
    """Recompute the checksums of `restored` against `manifest`: [] when
    every leaf matches, else readable problems (missing or extra leaves,
    shape or dtype drift, crc mismatches naming the path).  Never raises
    on malformed input."""
    problems: List[str] = []
    want = {rec["path"]: rec for rec in manifest.get("leaves", [])}
    got = dict(flatten_with_paths(restored))
    for path in want:
        if path not in got:
            problems.append(f"leaf {path} missing from restored state")
    for path in got:
        if path not in want:
            problems.append(f"unexpected leaf {path} in restored state")
    for path, rec in want.items():
        if path not in got:
            continue
        have = _leaf_record(path, got[path])
        for key in ("dtype", "shape", "bytes"):
            if have[key] != rec[key]:
                problems.append(f"leaf {path} {key} mismatch: manifest {rec[key]} != "
                                f"restored {have[key]}")
                break
        else:
            if have["crc32"] != rec["crc32"]:
                problems.append(f"leaf {path} checksum mismatch: manifest {rec['crc32']:#010x}"
                                f" != restored {have['crc32']:#010x}")
    return problems
