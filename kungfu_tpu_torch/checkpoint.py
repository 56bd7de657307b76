"""Checkpoint and resume: durable training state (counterpart of
kungfu_tpu.checkpoint).

The reference has no checkpoint subsystem (SURVEY.md §5): an elastic
resize keeps state alive only in memory.  The JAX package closes that gap
with an orbax-backed manager; this is the same manager with the same API
and semantics, writing a step directory of its own (orbax is not a
dependency of the port, so neither package reads the other's steps):

    <dir>/<step>/state/tree.json   the tree: its containers, its Python
                                   scalars, and a record per array leaf
    <dir>/<step>/state/<i>.bin     array leaf i's C-order host bytes
    <dir>/<step>/meta.json         the metadata (step, trained samples, ...)
    <dir>/<step>/kft_manifest.json the integrity manifest

Saves are primary-only and asynchronous: `save` copies the state to the
host and queues it; one writer thread writes the step under a temporary
name, renames it to `<step>` (the step is then finalized) and commits
its manifest by an atomic rename (resilience/manifest.py): the manifest is
the real finalization marker, so a crash between the two (the chaos
harness's `crash_in_save` fault fires there) leaves a detectably torn
step.  `max_to_keep` finalized steps are kept.  A write
that fails is journaled as `checkpoint_save_failed` at the next drain point
(save, wait, finalize_manifests, release) and never raises into training.

The read path lists finalized steps and reads them on every process, with
no collective.  `restore` re-checksums what it read against the manifest;
`restore_latest_verified` walks steps newest to oldest and demotes torn,
corrupt and manifest-less ones with a journaled `checkpoint_demoted`.
Across a resize the primary `release()`s its writer before the group is
torn down, and the new rank 0 takes over through `set_primary`.
"""
from __future__ import annotations

import importlib
import json
import os
import queue
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .monitor.journal import journal_event
from .resilience.manifest import (CheckpointIntegrityError, build_manifest, read_manifest,
                                  verify_manifest, write_manifest)
from .utils import get_logger, trace_scope

log = get_logger("kungfu.checkpoint")

STATE_DIR = "state"
TREE_NAME = "tree.json"
META_NAME = "meta.json"


def _host_copy(x: Any) -> Any:
    """A host copy of every array of the tree that later training cannot
    touch: tensors copied to the CPU, numpy arrays copied."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return t.to("cpu", copy=True) if t.device.type != "cpu" else t.clone()
    if isinstance(x, np.ndarray):
        return np.array(x, copy=True)
    if isinstance(x, dict):
        return {k: _host_copy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host_copy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_host_copy(v) for v in x)
    return x


def _encode(x: Any, blobs: List[Any]) -> Any:
    """The JSON form of the tree; array leaves go to `blobs`, by index."""
    if isinstance(x, torch.Tensor):
        blobs.append(x)
        return {"tensor": len(blobs) - 1, "dtype": str(x.dtype).split(".")[1],
                "shape": list(x.shape)}
    if isinstance(x, (np.ndarray, np.generic)):
        blobs.append(np.asarray(x, order="C"))
        return {"ndarray": len(blobs) - 1, "dtype": np.asarray(x).dtype.str,
                "shape": list(np.shape(x))}
    if isinstance(x, dict):
        return {"dict": [[k, _encode(v, blobs)] for k, v in x.items()]}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        cls = type(x)
        return {"ntuple": f"{cls.__module__}:{cls.__qualname__}",
                "fields": [[f, _encode(getattr(x, f), blobs)] for f in x._fields]}
    if isinstance(x, tuple):
        return {"tuple": [_encode(v, blobs) for v in x]}
    if isinstance(x, list):
        return {"list": [_encode(v, blobs) for v in x]}
    if x is None or isinstance(x, (bool, int, float, str)):
        return {"value": x}
    raise TypeError(f"checkpoint: cannot save a leaf of type {type(x).__name__}")


def _leaf_bytes(leaf: Any) -> bytes:
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return leaf.tobytes()


def _namedtuple(spec: str, fields: Dict[str, Any]) -> Any:
    """An instance of the saved namedtuple class, or a dict of its fields
    when the class cannot be imported (the manifest's paths are the same)."""
    mod, _, qual = spec.partition(":")
    try:
        cls = importlib.import_module(mod)
        for part in qual.split("."):
            cls = getattr(cls, part)
        return cls(**fields)
    except (ImportError, AttributeError, TypeError):
        return fields


def _leaf_from(x: Dict[str, Any], raw) -> Any:
    """The array leaf of record `x` over the buffer `raw` (writable: the
    tensor shares its memory)."""
    if "ndarray" in x:
        return np.frombuffer(raw, dtype=np.dtype(x["dtype"])).reshape(x["shape"])
    dtype = getattr(torch, x["dtype"])
    store = torch.int16 if dtype == torch.bfloat16 else dtype
    t = torch.frombuffer(raw, dtype=store) if len(raw) else torch.empty(0, dtype=store)
    return t.view(dtype).reshape(x["shape"])


def _decode_tree(x: Any, leaf: Callable[[Dict[str, Any]], Any]) -> Any:
    """The tree `_encode` encoded; `leaf(record)` gives each array leaf."""
    if "tensor" in x or "ndarray" in x:
        return leaf(x)
    if "dict" in x:
        return {k: _decode_tree(v, leaf) for k, v in x["dict"]}
    if "ntuple" in x:
        return _namedtuple(x["ntuple"], {f: _decode_tree(v, leaf) for f, v in x["fields"]})
    if "tuple" in x:
        return tuple(_decode_tree(v, leaf) for v in x["tuple"])
    if "list" in x:
        return [_decode_tree(v, leaf) for v in x["list"]]
    return x["value"]


def _decode(x: Any, state_dir: str) -> Any:
    def leaf(rec):
        with open(os.path.join(state_dir, f"{rec.get('tensor', rec.get('ndarray'))}.bin"),
                  "rb") as f:
            return _leaf_from(rec, bytearray(f.read()))

    return _decode_tree(x, leaf)


def _place_like(x: Any, like: Any) -> Any:
    """`x` with each tensor on the device of the tensor at its place in
    `like`; a `like` of another structure raises ValueError."""
    if like is None:
        return x
    if isinstance(like, torch.Tensor):
        if not isinstance(x, torch.Tensor) or tuple(x.shape) != tuple(like.shape):
            raise ValueError(f"restored leaf {type(x).__name__} does not match the template's "
                             f"tensor of shape {tuple(like.shape)}")
        return x.to(like.device)
    if isinstance(like, dict):
        if not isinstance(x, dict) or set(x) != set(like):
            raise ValueError("restored tree does not match the template's keys")
        return {k: _place_like(x[k], like[k]) for k in x}
    if isinstance(like, (list, tuple)) and not hasattr(like, "_fields"):
        if not isinstance(x, (list, tuple)) or len(x) != len(like):
            raise ValueError("restored tree does not match the template's sequence")
        return type(x)(_place_like(a, b) for a, b in zip(x, like))
    return x


class CheckpointManager:
    """Asynchronous checkpoints of (train state, metadata).

    Pass ``is_primary=(rank == 0)``: only the primary writes; everyone may
    restore.  The state is replicated over the data-parallel ranks, so one
    writer loses nothing.
    """

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval_steps: int = 1,
                 is_primary: bool = True, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        self.is_primary = is_primary
        self._max_to_keep = max_to_keep
        self._save_interval_steps = save_interval_steps
        self._async_save = async_save
        os.makedirs(self.directory, exist_ok=True)
        self._cv = threading.Condition()
        self._pending: List[int] = []  # steps queued and not yet finalized
        self._failures: List[Tuple[int, BaseException]] = []  # surfaced at drain points
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if is_primary:
            self._start_writer()

    # -- write path ---------------------------------------------------------------

    def _start_writer(self) -> None:
        self._queue = queue.Queue()
        self._thread = threading.Thread(target=self._writer, args=(self._queue,), daemon=True,
                                        name="kft-checkpoint-writer")
        self._thread.start()

    @property
    def writes(self) -> bool:
        """True when save() on this process writes (callers can skip
        snapshotting state when this is False)."""
        return self._thread is not None

    def _should_save(self, step: int, force: bool) -> bool:
        with self._cv:
            queued = list(self._pending)
        known = set(self.all_steps()) | set(queued)
        if step in known:
            return False
        if force:
            return True
        latest = max(known) if known else None
        if latest is not None and latest >= step:
            return False
        return latest is None or step % max(1, self._save_interval_steps) == 0

    def save(self, step: int, state: Any, meta: Optional[Dict[str, Any]] = None,
             force: bool = False) -> bool:
        """Queue a save of `state` at `step`; True if it was accepted (a
        non-primary, a step within the save interval or a step not after
        the latest is not).  The state is copied to the host here, so
        training may go on changing it at once."""
        if not self.writes:
            return False
        self._surface_failures()
        if not self._should_save(int(step), force):
            return False
        host_state = _host_copy(state)
        meta = dict(meta or {})
        with self._cv:
            self._pending.append(int(step))
        self._queue.put((int(step), host_state, meta))
        log.info("checkpoint step %d queued to %s", step, self.directory)
        if not self._async_save:
            self.wait()
        return True

    def _writer(self, q: queue.Queue) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            step, host_state, meta = item
            try:
                with trace_scope(f"checkpoint-save-{step}"):
                    self._write_step(step, host_state, meta)
            except Exception as e:  # noqa: BLE001 - surfaced at the next drain point
                with self._cv:
                    self._failures.append((step, e))
            finally:
                with self._cv:
                    self._pending.remove(step)
                    self._cv.notify_all()

    def _write_step(self, step: int, host_state: Any, meta: Dict[str, Any]) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        state_dir = os.path.join(tmp, STATE_DIR)
        os.makedirs(state_dir)
        blobs: List[Any] = []
        tree = _encode(host_state, blobs)
        for i, leaf in enumerate(blobs):
            with open(os.path.join(state_dir, f"{i}.bin"), "wb") as f:
                f.write(_leaf_bytes(leaf))
                f.flush()
                os.fsync(f.fileno())
        for name, doc in ((os.path.join(state_dir, TREE_NAME), tree),
                          (os.path.join(tmp, META_NAME), meta)):
            with open(name, "w", encoding="utf-8") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
        manifest = build_manifest(step, host_state, meta=meta,
                                  cluster_version=meta.get("cluster_version"))
        os.replace(tmp, final)  # the step is finalized
        # the chaos harness's crash_in_save fault fires here, between the
        # leaves and the manifest: the torn step the restore ladder demotes
        from .chaos.inject import maybe_crash_in_save

        maybe_crash_in_save(step)
        write_manifest(self.directory, manifest)  # and committed
        for old in self.all_steps()[:-self._max_to_keep] if self._max_to_keep else []:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def _on_save_failed(self, step: Optional[int], e: BaseException) -> None:
        log.error("checkpoint save failed (step %s): %s: %s", step, type(e).__name__,
                  str(e)[:300])
        journal_event("checkpoint_save_failed", step=step,
                      error=f"{type(e).__name__}: {str(e)[:300]}")

    def _surface_failures(self) -> bool:
        """Journal the writes that failed since the last drain point;
        True if there were none."""
        with self._cv:
            failures, self._failures = self._failures, []
        for step, e in failures:
            self._on_save_failed(step, e)
        return not failures

    def wait(self, deadline_s: Optional[float] = None) -> bool:
        """Block until the queued saves are finalized; False if one failed
        or, with `deadline_s`, if a save was still in flight when the
        deadline expired.  Never raises for a write that failed."""
        if not self.writes:
            return True
        with self._cv:
            done = self._cv.wait_for(lambda: not self._pending, timeout=deadline_s)
        if not done:
            log.warning("checkpoint flush still in flight after %.1fs deadline", deadline_s)
            return False
        return self._surface_failures()

    def finalize_manifests(self) -> None:
        """Surface the writes that finished since the last drain point.  The
        writer commits each manifest as soon as its step is finalized, so
        this is cheap; the elastic loop calls it every step."""
        self._surface_failures()

    # -- elastic transitions --------------------------------------------------------

    def release(self) -> None:
        """Flush the queued saves and stop the writer.  Called before the
        process group is torn down (a resize, a detach); pair it with
        `set_primary` after the new group forms."""
        if self._thread is not None:
            self.wait()
            self._queue.put(None)
            self._thread.join()
            self._thread = self._queue = None

    def set_primary(self, is_primary: bool) -> None:
        """Adopt the primariness of this process's new rank: the new rank 0
        takes over writing, every other process stops."""
        self.is_primary = is_primary
        if is_primary and self._thread is None:
            self._start_writer()
        elif not is_primary:
            self.release()

    # -- read path (every process, no collective) -----------------------------------

    def all_steps(self) -> List[int]:
        """The finalized steps, oldest first."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verified_steps(self) -> List[int]:
        """Steps with a readable integrity manifest (a cheap check; the
        checksums are verified at restore)."""
        return [s for s in self.all_steps() if read_manifest(self.directory, s) is not None]

    def restore(self, step: Optional[int] = None, like: Any = None,
                verify: bool = True) -> Tuple[Any, Dict[str, Any]]:
        """(state, meta) of `step` (the latest when None, retried on a
        fresher step if retention deletes it mid-read).  Tensors come back
        on the CPU, or on the devices of the tensors of `like`, a template
        tree of the same structure.  With `verify` the bytes read are
        re-checksummed against the step's manifest: a mismatch raises
        CheckpointIntegrityError; a step without a manifest restores with a
        warning."""
        auto = step is None
        for attempt in range(3):
            s = self.latest_step() if auto else step
            if s is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
            try:
                state, meta = self._restore_step(s, like)
            except FileNotFoundError:
                if not auto or attempt == 2:
                    raise
                log.warning("checkpoint step %d vanished mid-restore; retrying with the latest "
                            "step", s)
                continue
            if verify:
                self._verify_restored(s, state, strict=True)
            journal_event("checkpoint_restored", step=s, verified=verify)
            return state, meta
        raise AssertionError("unreachable")

    def _verify_restored(self, step: int, state: Any, strict: bool) -> bool:
        manifest = read_manifest(self.directory, step)
        if manifest is None:
            log.warning("checkpoint step %d has no integrity manifest; restored WITHOUT "
                        "verification", step)
            return False
        problems = verify_manifest(manifest, state)
        if problems:
            msg = (f"checkpoint step {step} failed integrity verification: "
                   + "; ".join(problems[:5]))
            if strict:
                raise CheckpointIntegrityError(msg)
            log.error("%s", msg)
            return False
        return True

    def restore_latest_verified(
            self, like: Any = None) -> Optional[Tuple[Any, Dict[str, Any], int, List[Dict]]]:
        """Walk the steps newest to oldest and return the first whose bytes
        verify against its manifest, as (state, meta, step, demotions).
        Torn, corrupt and manifest-less steps are demoted (journaled as
        `checkpoint_demoted` with the reason) and skipped, never raised.
        None when no step verifies."""
        demotions: List[Dict[str, Any]] = []

        def demote(step: int, reason: str) -> None:
            demotions.append({"candidate": f"step:{step}", "reason": reason})
            journal_event("checkpoint_demoted", step=step, reason=reason)
            log.warning("checkpoint step %d demoted: %s", step, reason)

        for s in sorted(self.all_steps(), reverse=True):
            if read_manifest(self.directory, s) is None:
                demote(s, "manifest missing or unreadable (torn step)")
                continue
            try:
                state, meta = self._restore_step(s, like)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 - demote, never raise mid-recovery
                demote(s, f"restore failed: {type(e).__name__}: {str(e)[:160]}")
                continue
            if not self._verify_restored(s, state, strict=False):
                demote(s, "checksum mismatch (corrupt arrays)")
                continue
            journal_event("checkpoint_restored", step=s, verified=True,
                          demotions=len(demotions))
            return state, meta, s, demotions
        return None

    def _restore_step(self, step: int, like: Any) -> Tuple[Any, Dict[str, Any]]:
        root = os.path.join(self.directory, str(step))
        state_dir = os.path.join(root, STATE_DIR)
        with trace_scope(f"checkpoint-restore-{step}"):
            with open(os.path.join(state_dir, TREE_NAME), encoding="utf-8") as f:
                state = _decode(json.load(f), state_dir)
            with open(os.path.join(root, META_NAME), encoding="utf-8") as f:
                meta = json.load(f)
        log.info("restored checkpoint step %d from %s", step, self.directory)
        return _place_like(state, like), dict(meta or {})

    def close(self) -> None:
        self.release()

