"""Buddy snapshots: peer-redundant in-memory copies of the train state
(counterpart of kungfu_tpu.resilience.buddy).

The common recovery case is a single worker loss, and a disk round trip is
the wrong tier for it: every rank keeps its latest snapshot in host RAM
and ships a copy to a buddy rank on another host (ring-offset assignment,
`PeerList.ring_buddies`), so the state survives any single host loss in
memory.  On a heal the recovery ladder (ladder.py) resyncs from this tier,
a local read or one peer fetch, and falls to disk only when it has nothing.

Transport is the p2p blob store (store.py): a snapshot lands in the
buddy's StoreServer RAM under one slot per origin (``kft-snap:<origin
host:port>``), so holding w wards costs w snapshots.

The JAX package pickles a pytree of numpy arrays.  The port's state is
torch tensors (bf16 among them, which numpy has no dtype for), so it packs
its own blob, read only by the port: the magic ``KFTSNAP1``, the header's
length, a JSON header (the counters and the tree as `checkpoint._encode`
records it), then every array leaf's bytes at a 64-byte aligned offset.
Each leaf keeps its dtype and its bits.  The blob is this rank's own
snapshot too (one host copy a rank): `update` copies each tensor straight
from the card into its place in the blob, and `unpack_snapshot` gives
tensors that view it.

Shipping is best-effort under a short deadline: a dead or slow buddy costs
``ship_timeout_s`` once a snapshot, never a training stall; the gap is
journaled (`buddy_ship_failed`), as a failed checkpoint write is.  The
monitoring counters of the JAX package wait for ROADMAP A.8.  ``KFT_BUDDY=0``
removes the tier (recovery then climbs straight to verified disk).
"""
from __future__ import annotations

import json
import os
import struct
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..monitor.journal import journal_event
from ..utils import get_logger

log = get_logger("kungfu.resilience")

SNAP_NAME_PREFIX = "kft-snap:"
BUDDY_ENV = "KFT_BUDDY"
DEFAULT_SHIP_TIMEOUT_S = 5.0
MAGIC = b"KFTSNAP1"
_ALIGN = 64


def buddy_enabled() -> bool:
    """The in-memory recovery tier is on unless KFT_BUDDY=0/false/off/no."""
    return os.environ.get(BUDDY_ENV, "").lower() not in ("0", "false", "off", "no")


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)


def pack_snapshot(step: int, offset: int, state: Dict[str, Any], origin_rank: int,
                  cluster_version: int) -> np.ndarray:
    """One snapshot as a flat uint8 blob for the store.  Tensors may live on
    the card: each is copied into its place in the blob, once."""
    from ..checkpoint import _encode

    leaves: List[Any] = []
    tree = _encode(state, leaves)
    offsets, end = [], 0
    for leaf in leaves:
        offsets.append(end)
        end += -(-_nbytes(leaf) // _ALIGN) * _ALIGN
    header = json.dumps({"step": int(step), "offset": int(offset),
                         "origin_rank": int(origin_rank),
                         "cluster_version": int(cluster_version), "tree": tree,
                         "leaves": offsets}).encode()
    base = -(-(len(MAGIC) + 8 + len(header)) // _ALIGN) * _ALIGN
    blob = np.zeros(base + end, np.uint8)
    blob[:len(MAGIC)] = np.frombuffer(MAGIC, np.uint8)
    blob[len(MAGIC):len(MAGIC) + 8] = np.frombuffer(struct.pack(">Q", len(header)), np.uint8)
    blob[len(MAGIC) + 8:len(MAGIC) + 8 + len(header)] = np.frombuffer(header, np.uint8)
    for leaf, off in zip(leaves, offsets):
        n = _nbytes(leaf)
        if not n:
            continue
        dst = blob[base + off:base + off + n]
        if isinstance(leaf, torch.Tensor):
            src = leaf.detach().contiguous().reshape(-1)
            torch.from_numpy(dst).copy_(src.view(torch.uint8))
        else:
            dst[:] = np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)
    return blob


def unpack_snapshot(blob) -> Optional[Dict[str, Any]]:
    """Inverse of pack_snapshot, its tensors viewing `blob`; None for a blob
    that does not decode (a torn or foreign blob reads as a miss, never as
    a crash mid-heal)."""
    from ..checkpoint import _decode_tree, _leaf_from

    try:
        raw = np.asarray(blob, dtype=np.uint8).reshape(-1)
        if bytes(raw[:len(MAGIC)]) != MAGIC:
            return None
        (hlen,) = struct.unpack(">Q", bytes(raw[len(MAGIC):len(MAGIC) + 8]))
        head = json.loads(bytes(raw[len(MAGIC) + 8:len(MAGIC) + 8 + hlen]).decode())
        base = -(-(len(MAGIC) + 8 + hlen) // _ALIGN) * _ALIGN
        offsets = head["leaves"]

        def leaf(rec):
            i = rec.get("tensor", rec.get("ndarray"))
            width = (torch.empty(0, dtype=getattr(torch, rec["dtype"])).element_size()
                     if "tensor" in rec else np.dtype(rec["dtype"]).itemsize)
            n = int(np.prod(rec["shape"], dtype=np.int64)) * width
            lo = base + offsets[i]
            if lo + n > raw.size:
                raise ValueError("snapshot blob is shorter than its header says")
            return _leaf_from(rec, raw[lo:lo + n])

        state = _decode_tree(head["tree"], leaf)
        if not isinstance(state, dict):
            return None
        return {"step": int(head["step"]), "offset": int(head["offset"]),
                "origin_rank": int(head["origin_rank"]),
                "cluster_version": int(head["cluster_version"]), "state": state}
    except Exception:  # noqa: BLE001 - untrusted bytes by definition
        return None


class BuddySnapshots:
    """This rank's half of the buddy protocol, bound to one cluster shape.

    Owns (1) the local latest snapshot (the rolling last-known-good copy the
    heal path rolls back to) and (2) the shipping of that snapshot to the
    assigned buddy's store.  Rebuild after every resize and heal: the
    assignment is a function of the peer list, and ranks shift.
    """

    def __init__(self, peer, ship_timeout_s: float = DEFAULT_SHIP_TIMEOUT_S):
        self.peer = peer
        self.rank = peer.rank
        self.buddies: List[int] = peer.config.peers.ring_buddies()
        self.buddy_rank: int = self.buddies[self.rank] if self.buddies else -1
        self._ship_timeout = ship_timeout_s
        self._own: Optional[np.ndarray] = None  # this rank's packed snapshot
        self._name = f"{SNAP_NAME_PREFIX}{peer.self_id}"
        self._client = None  # a short-deadline client, made on first use
        #: (step, seconds, bytes, shipped) of every ship, for the record
        self.ships: List[tuple] = []
        # a whole-host loss must never destroy a snapshot and its only copy
        peers = peer.config.peers
        self.cross_host = self.buddy_rank >= 0 and peers[self.buddy_rank].host != peer.self_id.host
        if self.buddy_rank >= 0 and peers.host_count() > 1 and not self.cross_host:
            log.error("buddy for rank %d is CO-LOCATED on %s: a host loss can take the "
                      "snapshot and its copy together", self.rank, peer.self_id.host)
            journal_event("buddy_colocated", rank=self.rank, buddy=self.buddy_rank,
                          host=peer.self_id.host)

    # -- write side (the step loop) ---------------------------------------------------

    def update(self, step: int, offset: int, params: Any, opt: Any) -> None:
        """Refresh the local snapshot and ship a copy to the buddy.

        `params` and `opt` are state dicts (their tensors may be on the
        card).  The local copy always lands; the ship is best-effort under
        a deadline and its failure is journaled, not raised."""
        self._own = None  # the old blob goes before the new one is made
        self._own = blob = pack_snapshot(step, offset, {"params": params, "opt": opt},
                                         self.rank, self.peer.cluster_version)
        if self.buddy_rank < 0:
            return
        t0 = time.perf_counter()
        try:
            # a client of its own with a short deadline: the peer's gossip
            # client retries connects long enough to stall the step loop on
            # a dead buddy
            if self._client is None:
                from ..store import StoreClient

                self._client = StoreClient(retries=2, retry_interval=0.05,
                                           op_timeout=self._ship_timeout)
            self._client.save(self.peer.config.peers[self.buddy_rank], self._name, blob)
            self.ships.append((int(step), time.perf_counter() - t0, blob.nbytes, True))
        except Exception as e:  # noqa: BLE001 - a durability gap, not fatal
            dt = time.perf_counter() - t0
            self.ships.append((int(step), dt, blob.nbytes, False))
            journal_event("buddy_ship_failed", step=step, buddy=self.buddy_rank,
                          error=str(e)[:200])
            log.warning("buddy ship to rank %d failed in %.2fs: %s", self.buddy_rank, dt,
                        str(e)[:200])

    # -- read side (the recovery ladder) ----------------------------------------------

    def latest(self) -> Optional[Dict[str, Any]]:
        """This rank's own in-RAM snapshot (source "self")."""
        return None if self._own is None else unpack_snapshot(self._own)

    def fetch(self, timeout_s: float = 10.0) -> Optional[Dict[str, Any]]:
        """Pull back the copy we shipped to our buddy (source "peer:<r>"):
        the path for a rank whose own RAM copy is unusable.  A miss (None)
        on any failure; the ladder then demotes to disk."""
        if self.buddy_rank < 0:
            return None
        try:
            blob = self.peer.request(self.buddy_rank, self._name, wait=False,
                                     timeout=timeout_s)
        except Exception as e:  # noqa: BLE001
            log.warning("buddy fetch from rank %d failed: %s", self.buddy_rank, str(e)[:200])
            return None
        return None if blob is None else unpack_snapshot(blob)

    def held_wards(self) -> List[str]:
        """Origin identities whose snapshots this rank holds (who loses
        redundancy if we die)."""
        srv = getattr(self.peer, "_store_server", None)
        if srv is None:
            return []
        return [n[len(SNAP_NAME_PREFIX):] for n in srv.store.names()
                if n.startswith(SNAP_NAME_PREFIX)]

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None
