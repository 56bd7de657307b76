"""Checkpoint integrity (counterpart of kungfu_tpu.resilience): the
per-step manifests that the checkpoint manager commits and verifies
(`manifest.py`).  The buddy snapshots and the recovery ladder of the
self-healing path wait for ROADMAP A.5b."""
from .manifest import (
    MANIFEST_NAME,
    CheckpointIntegrityError,
    build_manifest,
    manifest_path,
    read_manifest,
    structure_hash,
    verify_manifest,
    write_manifest,
)

__all__ = [
    "MANIFEST_NAME",
    "CheckpointIntegrityError",
    "build_manifest",
    "manifest_path",
    "read_manifest",
    "structure_hash",
    "verify_manifest",
    "write_manifest",
]
