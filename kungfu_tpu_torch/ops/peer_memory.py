"""Peer workspace of the ring kernels: where one rank's kernel stores into
its right neighbour's memory.

The Pallas ring kernels address a peer by device id and let the TPU's DMA
engines move the bytes (`make_async_remote_copy`); nothing of theirs needs
this module.  On CUDA a kernel can store straight into another process's
memory once that process has exported it (`cudaIpcGetMemHandle`) and this
one has mapped it (`cudaIpcOpenMemHandle` with
`cudaIpcMemLazyEnablePeerAccess`): over NVLink between cards, and to the
same device memory when the ranks share a card.

One `Workspace` per process group, symmetric across its ranks:

  header     flag words, one per (hop, block) for each kind of call, an
             acknowledgement counter per kind and the error claim
             (csrc/ring.cu, `header_bytes`)
  rs slots   n-1 receive slots of the reduce-scatter (B5), one per hop
  ag slots   n-1 landing slots of the all-gather (B6), one per hop
  frs slots  n-1 slots of the fused-codec reduce-scatter (B7): codes, then
             one f32 scale per quantization block
  fag slots  n-1 slots of the fused-codec all-gather (B8), the same layout

The four kinds ("rs", "ag", "frs", "fag") have their own flags, counters
and slots, so calls of any kinds and sizes interleave safely: a kernel
waits only on the flags and acknowledgements of its own kind.

It is allocated with `cudaMalloc` (an IPC handle names a whole
allocation, not a slice of torch's caching allocator), its plain and fused
slots each sized for the largest call of theirs so far and grown on
demand, which every rank does at the
same call because every rank makes the same calls.  The handles are
exchanged over the process group when the workspace is made or grown,
never per call.  `close_all` (from `distributed.shutdown_distributed`)
frees it once no rank can still touch it.

The kernels' error record lives in mapped host memory: a wait that
expires writes (kind, hop, block, seq) there, and `Workspace.check`
raises it.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..utils import get_logger

log = get_logger("kungfu.peer_memory")

IPC_HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t)
SLOT_ALIGN = 4096
KINDS = ("rs", "ag", "frs", "fag")  # csrc/ring.cu `Kind`, in order
_KIND_NAMES = ("reduce-scatter", "all-gather", "fused reduce-scatter", "fused all-gather")
# csrc/ring.cu records 1 + 2 * kind for a data wait, 2 + 2 * kind for an ack
_ERR_KINDS = {1 + 2 * i + a: f"{name} {'acknowledgement' if a else 'data'}"
              for i, name in enumerate(_KIND_NAMES) for a in (0, 1)}


def _timeout_ns() -> int:
    """Bound on every wait inside a ring kernel (KFT_RING_TIMEOUT_S, 30 s)."""
    return int(float(os.environ.get("KFT_RING_TIMEOUT_S", "30")) * 1e9)


def _call(name: str, *args) -> None:
    from . import _build

    err = _build.function(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")


class RingError(RuntimeError):
    """A ring kernel gave up waiting for a peer."""


class Workspace:
    """This rank's side of the symmetric ring workspace of one group."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.device = device
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.left = (self.rank - 1) % self.n
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        # every rank must agree on the grid and the flag layout
        counts = [None] * self.n
        dist.all_gather_object(counts, sms, group=group)
        self.max_blocks = min(counts)
        from . import _build

        self.header = _build.function("kft_ring_header_bytes")(self.n, self.max_blocks)
        self.cap = 0  # bytes per slot of the plain kernels
        self.fcap = 0  # bytes per slot of the fused kernels
        self.own: Optional[int] = None
        self.right: Optional[int] = None
        self._fresh_counts()
        err = ctypes.c_void_p()
        _call("kft_host_alloc", 32, ctypes.byref(err))
        self.err_ptr = err.value
        self.err = (ctypes.c_uint64 * 4).from_address(self.err_ptr)

    @property
    def nbytes(self) -> int:
        return self.header + 2 * (self.n - 1) * (self.cap + self.fcap)

    def reserve(self, slot_bytes: int = 0, fused_slot_bytes: int = 0) -> None:
        """Grow every rank's workspace to plain slots of at least
        `slot_bytes` and fused slots of at least `fused_slot_bytes`.
        Collective: every rank of the group must call it with the same
        sizes, as the ring wrappers do."""
        if slot_bytes <= self.cap and fused_slot_bytes <= self.fcap:
            return
        cap = max(self.cap, -(-slot_bytes // SLOT_ALIGN) * SLOT_ALIGN)
        fcap = max(self.fcap, -(-fused_slot_bytes // SLOT_ALIGN) * SLOT_ALIGN)
        self._release()
        self.cap, self.fcap = cap, fcap
        dev = self.device.index
        own = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        _call("kft_ws_alloc", dev, self.nbytes, ctypes.byref(own), handle)
        self.own = own.value
        handles = [None] * self.n
        dist.all_gather_object(handles, handle.raw, group=self.group)
        right = ctypes.c_void_p()
        _call("kft_ws_open", dev, ctypes.create_string_buffer(
            handles[(self.rank + 1) % self.n], IPC_HANDLE_BYTES), ctypes.byref(right))
        self.right = right.value
        self._fresh_counts()  # the fresh flags and counters are zero
        log.info("rank %d/%d: ring workspace %.1f MiB on %s (slots of %.1f MiB, fused %.1f MiB)",
                 self.rank, self.n, self.nbytes / 2**20, self.device, self.cap / 2**20,
                 self.fcap / 2**20)

    def _fresh_counts(self) -> None:
        self.seq = dict.fromkeys(KINDS, 0)
        self.blocks_done = dict.fromkeys(KINDS, 0)

    def next_call(self, kind: str, blocks: int):
        """(sequence number, blocks of the earlier calls) of the next call
        of `kind` (one of KINDS) on a grid of `blocks`."""
        self.seq[kind] += 1
        done = self.blocks_done[kind]
        self.blocks_done[kind] += blocks
        return self.seq[kind], done

    def _release(self) -> None:
        """Unmap the neighbour's workspace and free ours, once no kernel of
        any rank can still touch either (a device sync, then a barrier
        before each step)."""
        if self.own is None:
            return
        dev = self.device.index
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        _call("kft_ws_close", dev, self.right)
        dist.barrier(group=self.group)
        _call("kft_ws_free", dev, self.own)
        self.own = self.right = None
        self.cap = self.fcap = 0

    def close(self) -> None:
        self._release()
        if self.err_ptr is not None:
            _call("kft_host_free", self.err_ptr)
            self.err_ptr = None

    def raise_if_failed(self) -> None:
        """Raise the error a finished ring kernel recorded, if any (no sync)."""
        kind = int(self.err[0]) if self.err_ptr is not None else 0
        if kind:
            hop, block, seq = (int(v) for v in self.err[1:4])
            raise RingError(
                f"rank {self.rank}/{self.n}: ring kernel gave up after "
                f"{_timeout_ns() / 1e9:g} s waiting for the {_ERR_KINDS.get(kind, kind)} "
                f"of hop {hop}, block {block}, call {seq} (left neighbour rank "
                f"{self.left}, right neighbour rank {(self.rank + 1) % self.n})")

    def check(self) -> None:
        """Wait for the kernels queued so far, then raise their error, if any."""
        torch.cuda.current_stream(self.device).synchronize()
        self.raise_if_failed()


_WORKSPACES: Dict[int, Workspace] = {}


def workspace(group, device: torch.device) -> Workspace:
    """The group's workspace on `device`, made on first use (collective)."""
    group = group if group is not None else dist.group.WORLD
    ws = _WORKSPACES.get(id(group))
    if ws is None:
        ws = _WORKSPACES[id(group)] = Workspace(group, device)
    elif ws.device != device:
        raise ValueError(f"ring workspace of this group lives on {ws.device}, not {device}")
    return ws


def check_all() -> None:
    """`Workspace.check` for every workspace of this process."""
    for ws in _WORKSPACES.values():
        ws.check()


def close_all() -> None:
    """Free every workspace (collective over each group)."""
    while _WORKSPACES:
        _, ws = _WORKSPACES.popitem()
        ws.close()
