"""Recovery ladder subsystem (counterpart of kungfu_tpu.resilience):
peer-redundant RAM snapshots, checkpoint integrity manifests, and the
tiered restore path the elastic heal climbs.

  buddy.py     ring-offset buddy assignment (plan.PeerList.ring_buddies) and
               host-RAM snapshots shipped over the p2p blob store
  manifest.py  per-step integrity manifests (per-leaf crc32, structure hash,
               atomic-rename commit) and their verification
  ladder.py    the climb: buddy RAM -> latest verified disk step -> older
               verified steps, with journaled demotions
"""
from .buddy import (
    BUDDY_ENV,
    BuddySnapshots,
    buddy_enabled,
    pack_snapshot,
    unpack_snapshot,
)
from .ladder import RecoveryOutcome, climb
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
    "BUDDY_ENV",
    "BuddySnapshots",
    "buddy_enabled",
    "pack_snapshot",
    "unpack_snapshot",
    "RecoveryOutcome",
    "climb",
    "MANIFEST_NAME",
    "CheckpointIntegrityError",
    "build_manifest",
    "manifest_path",
    "read_manifest",
    "structure_hash",
    "verify_manifest",
    "write_manifest",
]
