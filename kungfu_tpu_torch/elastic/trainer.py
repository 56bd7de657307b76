"""Elastic training loop: resize the cluster mid-training (counterpart of
kungfu_tpu.elastic.trainer, its planned resize).

The reference's signature flow (SURVEY.md §3.5; peer/peer.go:227-263,
experimental/hook/elastic.py:51-118), as the JAX package redesigned it:

  reference                             here
  ---------                             ----
  worker GETs config server             same (HTTP, elastic/config_client.py)
  BytesConsensus over own TCP           consensus on (version, document
  collectives until all agree           digest) over the current group: an
                                        elementwise min and max until agree
  notify runners via Control conns      runners poll the config server
  token-fenced reconnect + barrier      the process group is re-made at a
                                        version-derived rendezvous port
                                        (peer.coordinator_port): the
                                        rendezvous is the barrier, and a
                                        stale peer cannot reach the new port
  allreduce-max trained samples +       sync_state: the max of the counters
  BroadcastGlobalVariables              and the state broadcast from rank 0

A resize is: snapshot the state to the host, flush the checkpoint writer,
leave the old group (its ring workspaces, the Session's groups, the
process group), `Peer.update_cluster` at the new version, rebuild the
trainer, sync the state.  Survivors keep their state; joiners start fresh
and receive rank 0's in the sync.  Rank 0 survives any shrink
(Cluster.resize keeps a prefix: the reference's "new root must be an old
worker" guard, peer.go:211-222, holds by construction).

A torch optimizer builds its state at its first step, where optax builds
it at init, so a joiner's fresh optimizer holds no moments when the
survivors send theirs.  `sync_state` therefore first makes every rank's
tree whole: rank 0 sends the tree's skeleton (its paths, its scalars, each
array's dtype and shape) and a rank whose tree differs builds rank 0's
with zero arrays, which the broadcast then fills.  Each try of the
consensus is bounded by the collective's own wait, so a consensus that
never forms ends in TimeoutError instead of blocking.

SIGTERM is a preemption notice: at the step boundary a final checkpoint,
self-removal from the cluster document, a DETACHED line and a clean exit.

Self-healing: under a `-heal` launcher (KFT_HEAL) the loop also survives an
unplanned failure.  A step that dies because a peer vanished (a gloo
"Connection closed", a consensus that times out, or a ring kernel that gave
up waiting for its neighbour: `peer_memory.RingError`, by its type) enters
the recovery path: climb the recovery ladder (resilience/: the live state when the
failed step left it intact, then this rank's rolling snapshot, then the
copy shipped to its buddy, then the newest verified disk step), save a
state that is not yet durable, tear the group down without touching the
dead peer (`Peer.close(graceful=False)`), wait for the healer's document
(touching the heartbeat file; exit HEAL_WAIT_EXIT_CODE past
`heal_timeout_s`), rejoin at its fenced port, sync from rank 0, free the
dead group's ring workspaces, and go on at the new size.  The JAX
package's state is functional and a failed step never assigns it; here
the model and optimizer change in place, so the live rung is taken only
while the optimizer says its state is the one from before the failed step
(`OptimizerWrapper.live_dirty`).  Faults come from KFT_FAULT_PLAN
(chaos/), keyed on the launch rank; rank 0 publishes its progress under
KFT_PROGRESS_BEACON.  The monitoring counters and the anomaly watchdog
(KFT_CONFIG_ENABLE_MONITORING) wait for ROADMAP A.8.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import inspect
import math
import os
import signal
import sys
import time
import traceback
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..monitor.journal import journal_event
from ..utils import get_logger
from ..utils import trace as tracing
from ..utils.stall import stall_detector
from .config_client import ConfigClient, propose_new_size
from .schedule import StepBasedSchedule

log = get_logger("kungfu.elastic")

# env -> the ROADMAP item that ports what it arms
UNPORTED_ENV = {"KFT_CONFIG_ENABLE_MONITORING": "A.8"}

# exit code when the suspected-dead-peer path finds no healed document in
# time: distinct from crash codes, so the healer's logs show why we died
HEAL_WAIT_EXIT_CODE = 86


@dataclasses.dataclass
class ElasticConfig:
    total_samples: int
    batch_size: int  # per rank
    schedule: str = ""  # "size:steps,..." -> rank 0 proposes resizes
    check_every: int = 5  # steps between config polls (the resize latency knob)
    per_replica: bool = False
    consensus_timeout_s: float = 60.0
    # with a dir set, rank 0 saves every checkpoint_every steps and a
    # restarted job resumes from the latest verified checkpoint
    checkpoint_dir: str = ""
    checkpoint_every: int = 50
    # how long the suspected-dead-peer path waits for the healer's shrunk
    # document before giving up (exit HEAL_WAIT_EXIT_CODE)
    heal_timeout_s: float = 120.0
    # heal-armed jobs keep a rolling snapshot of the train state every this
    # many steps (shipped to the buddy rank): a heal that cannot take the
    # live state loses at most this many steps.  0 = check_every
    snapshot_every: int = 0


@dataclasses.dataclass(frozen=True)
class _ArraySpec:
    """An array leaf of a state skeleton."""
    dtype: torch.dtype
    shape: Tuple[int, ...]


class _GroupPrograms:
    """The consensus and state-sync collectives over the current group."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        # heal-armed jobs run the consensus and the sync under a forced
        # stall watchdog: its ticks keep the launcher-facing heartbeat fresh
        # (blocked on a hung peer reads as alive, not as a second hang)
        self._stall_force = bool(os.environ.get("KFT_HEAL"))
        # NCCL carries only tensors on the card; gloo those on the host
        nccl = self.world > 1 and dist.get_backend() == "nccl"
        self.device = trainer.device if nccl else torch.device("cpu")

    @staticmethod
    def _wait(work, timeout_s: float, what: str) -> None:
        try:
            work.wait(timeout=datetime.timedelta(seconds=max(1.0, timeout_s)))
        except RuntimeError as e:
            raise TimeoutError(f"{what}: no answer from every rank in {timeout_s:.0f}s "
                               f"({str(e)[:200]})") from e

    def agree_vec(self, values: Tuple[int, ...], timeout_s: float = 60.0,
                  refresh: Optional[Callable[[], Tuple[int, ...]]] = None) -> Tuple[int, ...]:
        """Block until every rank reports the same int vector: the
        BytesConsensus retry loop (peer.go:245-254) as an elementwise min
        and max over the group, retried with `refresh`'s values until they
        agree; TimeoutError past `timeout_s`."""
        with stall_detector("elastic_consensus", force=self._stall_force):
            return self._agree_vec(values, timeout_s, refresh)

    def _agree_vec(self, values, timeout_s, refresh) -> Tuple[int, ...]:
        t0 = time.monotonic()
        v = tuple(int(x) for x in values)
        n = len(v)
        while True:
            if self.world == 1:
                return v
            both = torch.tensor([*v, *(-x for x in v)], dtype=torch.int64, device=self.device)
            work = dist.all_reduce(both, op=dist.ReduceOp.MAX, async_op=True)
            self._wait(work, timeout_s - (time.monotonic() - t0), "elastic consensus")
            hi, lo = both[:n].tolist(), [-x for x in both[n:].tolist()]
            if lo == hi:
                return tuple(hi)
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"no consensus: min={lo} max={hi}")
            time.sleep(0.05)
            if refresh is not None:
                v = tuple(int(x) for x in refresh())

    def agree_int(self, value: int, timeout_s: float = 60.0,
                  refresh: Optional[Callable[[], int]] = None) -> int:
        r = None if refresh is None else (lambda: (refresh(),))
        return self.agree_vec((value,), timeout_s, r)[0]

    def _whole(self, host_tree: Any) -> Any:
        """This rank's tree, or rank 0's skeleton filled with zero arrays
        where this rank's differs (a joiner's optimizer before its first
        step): every rank then holds the same leaves, with the same paths,
        dtypes and shapes, in the same order."""
        mine = _map_leaves(host_tree, lambda x: _ArraySpec(x.dtype, tuple(x.shape))
                           if isinstance(x, torch.Tensor) else x)
        got = [mine]
        dist.broadcast_object_list(got, src=0)
        if got[0] == mine:
            return host_tree
        log.info("sync_state: taking rank 0's state skeleton")
        return _map_leaves(got[0], lambda x: torch.zeros(x.shape, dtype=x.dtype)
                           if isinstance(x, _ArraySpec) else x)

    def sync_state(self, counters: Tuple[int, ...], host_tree: Any) -> Tuple[Tuple[int, ...], Any]:
        """The max of the progress counters over the group, and the state
        broadcast from rank 0: every array's bits, whatever its dtype
        (integer leaves keep theirs).  `host_tree` is this rank's state
        (nested dicts, lists and tuples of tensors and Python scalars);
        returns (synced counters, rank 0's tree)."""
        if self.world == 1:
            return tuple(int(c) for c in counters), host_tree
        with stall_detector("elastic_state_sync", force=self._stall_force):
            return self._sync_state(counters, host_tree)

    def _sync_state(self, counters, host_tree):
        off = torch.tensor(list(counters), dtype=torch.int64, device=self.device)
        dist.all_reduce(off, op=dist.ReduceOp.MAX)
        tree = self._whole(host_tree)
        rank = dist.get_rank()

        def bcast(x):
            if not isinstance(x, torch.Tensor):
                return x
            buf = x.detach().to(self.device).contiguous()
            if buf.numel():
                dist.broadcast(buf.reshape(-1).view(torch.uint8), src=0)
            return buf if rank else x

        return tuple(int(c) for c in off.tolist()), _map_leaves(tree, bcast)


def _map_leaves(tree: Any, fn: Callable[[Any], Any]) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _to_host(tree: Any) -> Any:
    """A host copy of every tensor of the tree."""
    return _map_leaves(tree, lambda x: x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else x)


def _suspected_peer_failure(e: BaseException) -> bool:
    """Does this exception look like a peer's death rather than a bug?

    The JAX package's markers: gloo surfaces a dead peer as "... Connection
    closed by peer", the runtime as RuntimeError with UNAVAILABLE or
    heartbeat text, and a consensus that never converges as TimeoutError.
    A ring kernel that gave up waiting for its neighbour raises
    `peer_memory.RingError`, taken by its type, not its text."""
    from ..ops.peer_memory import RingError

    if isinstance(e, (TimeoutError, OSError, RingError)):
        return True
    text = f"{type(e).__name__}: {e}"
    markers = (
        "Gloo", "gloo", "Connection", "connection closed", "closed by peer",
        "UNAVAILABLE", "DEADLINE_EXCEEDED", "heartbeat", "Heartbeat",
        "coordination", "Coordination", "Socket", "socket", "distributed_runtime",
        "preempted",
    )
    return isinstance(e, (RuntimeError, ValueError)) and any(m in text for m in markers)


def _optimizers(opt):
    """The optimizer and every wrapper's inner one, outermost first."""
    while opt is not None:
        yield opt
        opt = getattr(opt, "inner", None)


def _live_state(state) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(parameters, optimizer state dict) of the live state, the recovery
    ladder's "live" source: the state before the failed step, read in
    place.  Raises when the step may already have changed it (a wrapper's
    step began and did not show its failure point came first, the
    optimizer stepped, or a compressed reduction wrote its residuals) or
    when a resize had dropped it."""
    if state is None:
        raise RuntimeError("no live state: the failure came mid-resize")
    why = next((o.live_dirty for o in _optimizers(state.opt_state)
                if getattr(o, "live_dirty", None)), None)
    if why:
        raise RuntimeError(f"the live state is past the step's start: {why}")
    return dict(state.params.state_dict()), state.opt_state.state_dict()


def _mark_live(opt) -> None:
    """A step completed: the live state is the next step's start."""
    for o in _optimizers(opt):
        if getattr(o, "live_dirty", None):
            o.live_dirty = None


def _drop_frames(e: Optional[BaseException]) -> None:
    """Clear the locals of the finished frames in `e`'s tracebacks (and its
    causes'), so nothing of a failed collective outlives the teardown."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        traceback.clear_frames(e.__traceback__)
        e = e.__cause__ or e.__context__


def _touch(path: str) -> None:
    try:
        os.utime(path, None)
    except FileNotFoundError:
        try:
            with open(path, "w"):
                pass
        except OSError:
            pass
    except OSError:
        pass


def _refuse_unported() -> None:
    for name, item in UNPORTED_ENV.items():
        if os.environ.get(name, "").strip() not in ("", "0"):
            raise NotImplementedError(f"run_elastic under {name} is not ported yet "
                                      f"(ROADMAP {item})")


def run_elastic(
    make_loss: Callable[[], Callable],
    init_params: Callable[[], torch.nn.Module],
    make_tx: Callable[..., Callable],
    make_data: Callable[[int, int, int], Iterator],
    cfg: ElasticConfig,
    device=None,
) -> Dict[str, Any]:
    """Elastic data-parallel training under the launcher's watch mode.

    Args:
      make_loss: () -> loss_fn(model, batch), rebuilt after each resize.
      init_params: () -> the model (an nn.Module), the same on every rank.
      make_tx: () -> an optimizer factory (params -> optimizer, e.g.
        `synchronous_sgd(adamw(...))`).  A parameter named `axes` (or
        `axis_name`) receives the group to reduce over: None for the flat
        data-parallel group, or the ("dcn", "ici") mesh of a cluster of
        several hosts with several ranks each; one named `impl` receives the
        reduction the cluster's Strategy selects.
      make_data: (rank, size, offset_samples) -> iterator of this rank's
        batches (tensors, placed on the trainer's device each step).
      cfg: ElasticConfig.
      device: "cpu" or "cuda"; None takes the peer's (the launcher's
        KFT_PLATFORM, else the card).

    Returns the final metrics (on the ranks that survive to the end).
    """
    from .. import peer as peer_mod
    from ..chaos import injector_from_env, set_launch_rank
    from ..checkpoint import CheckpointManager
    from ..ops import peer_memory
    from ..plan import Impl, impl_of, make_hierarchical_mesh
    from ..resilience import BuddySnapshots, buddy_enabled
    from ..resilience import ladder
    from ..train import DataParallelTrainer, TrainState

    _refuse_unported()
    if device is not None and peer_mod._default_peer is None:
        peer_mod.set_default_peer(peer_mod.Peer(device=device).start())
    peer = peer_mod.default_peer()
    client = ConfigClient(peer.config.config_server) if peer.config.config_server else None
    schedule = StepBasedSchedule(cfg.schedule)
    resizes = 0
    # per-resize latency (the reference's resize profiler,
    # experimental/hook/elastic.py:12-48): snapshot -> ckpt_release ->
    # teardown -> reinit (the rendezvous at the new version's port) ->
    # rebuild -> sync -> first_step
    resize_events: List[Dict[str, Any]] = []
    first_step_after_resize = False
    last_propose: Dict[str, Any] = {}
    preempted = {"flag": False}

    # -- self-healing state: armed by the -heal launcher (KFT_HEAL); without
    # a healer publishing shrunk documents, waiting for one would only delay
    # the failure the supervisor needs to see
    heal_armed = bool(os.environ.get("KFT_HEAL")) and client is not None
    heal_events: List[Dict[str, Any]] = []
    pending_heal: Optional[Dict[str, Any]] = None
    chaos = injector_from_env()
    # faults key on the LAUNCH rank: ranks shift when the cluster heals, and
    # a drill's victim must stay the same process; the checkpoint writer's
    # crash_in_save has no rank of its own, so it is registered here
    chaos_rank = peer.rank
    set_launch_rank(chaos_rank)
    hb_file = os.environ.get("KFT_HEARTBEAT_FILE", "")
    beacon_armed = bool(os.environ.get("KFT_PROGRESS_BEACON")) and client is not None

    def on_sigterm(signum, frame):  # noqa: ARG001
        preempted["flag"] = True
        log.warning("SIGTERM received: will checkpoint and detach at the step boundary")

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:  # not the main thread
        prev_sigterm = None

    try:
        tx_names = set(inspect.signature(make_tx).parameters)
    except (TypeError, ValueError):
        tx_names = set()
    axes_kw = next((k for k in ("axes", "axis_name") if k in tx_names), None)

    def call_make_tx(axes, impl):
        kw = {}
        if axes_kw is not None:
            kw[axes_kw] = axes
        if "impl" in tx_names:
            kw["impl"] = impl
        return make_tx(**kw)

    def build():
        """The trainer for the current cluster: the hierarchical (dcn x ici)
        mesh on several hosts with several ranks each (when make_tx takes
        the axes), else the flat group; the Strategy picks the reduction,
        and the Pallas strategies fall to pmean, as in the JAX package (a
        make_tx that wants the ring kernels picks impl="pallas_ring")."""
        host_count = peer.host_count
        if host_count > 1 and peer.local_size > 1 and axes_kw is not None:
            axes = make_hierarchical_mesh(host_count)
            shape = {"dcn": host_count, "ici": peer.size // host_count}
        else:
            axes = None
            shape = {"dp": peer.size}
        impl = {Impl.HIERARCHICAL: "hierarchical", Impl.RS_AG: "rs_ag",
                Impl.RING: "ring"}.get(impl_of(peer.config.strategy, host_count), "pmean")
        if impl == "hierarchical" and axes is None:
            impl = "pmean"  # no dcn/ici split on a flat group
        if impl == "ring" and axes is not None:
            impl = "rs_ag"
        trainer = DataParallelTrainer(make_loss(), call_make_tx(axes, impl),
                                      per_replica_params=cfg.per_replica, device=peer.device)
        return trainer, _GroupPrograms(trainer), shape

    def place(synced, step):
        """TrainState of the model holding the synced parameters and a
        fresh optimizer holding the synced optimizer state."""
        with torch.no_grad():
            model.load_state_dict(synced["params"])
        opt = trainer.tx(model.parameters())
        opt.load_state_dict(synced["opt"])
        return TrainState(params=model, opt_state=opt, step=step)

    def snap(state):
        return (_to_host(dict(state.params.state_dict())),
                _to_host(state.opt_state.state_dict()))

    trainer, programs, mesh_shape = build()
    model = init_params().to(trainer.device)  # the one model, across every resize
    state = TrainState(params=model, opt_state=trainer.tx(model.parameters()), step=0)
    offset = 0
    step = 0  # the optimizer's step count (kept across resizes by the sync)
    sp, so = snap(state)

    ckpt = None
    if cfg.checkpoint_dir:
        # save_interval_steps=1: the loop's modulo gate is the only cadence
        ckpt = CheckpointManager(cfg.checkpoint_dir, save_interval_steps=1,
                                 is_primary=peer.rank == 0)
        if ckpt.latest_step() is not None:
            # load on every rank; the initial sync then makes the state
            # bit-identical everywhere.  Torn, corrupt and manifest-less
            # steps are demoted; with no verified step the job starts fresh
            got = ckpt.restore_latest_verified()
            if got is None:
                log.warning("checkpoint dir %s has steps but none verify; starting from "
                            "scratch (see checkpoint_demoted journal events)",
                            cfg.checkpoint_dir)
                journal_event("checkpoint_resume_skipped", directory=cfg.checkpoint_dir)
            else:
                restored, meta, ckpt_step, _ = got
                offset = int(meta.get("trained_samples", 0))
                step = int(meta.get("step", 0))
                sp, so = restored["params"], restored["opt"]
                journal_event("resume", step=step, trained_samples=offset, ckpt_step=ckpt_step)
                log.info("resumed from checkpoint: step %d, %d samples (verified ckpt step %d)",
                         step, offset, ckpt_step)

    # the initial sync: identical at version 0, but a worker joining a
    # running cluster (spawned at version N) gets the survivors' state here;
    # it pairs with the survivors' sync in their resize path
    (offset, step), synced = programs.sync_state((offset, step), {"params": sp, "opt": so})
    state = place(synced, step)
    del sp, so, synced
    data = make_data(peer.rank, peer.size, offset)
    # the sync is this step's rendezvous: nobody re-checks at this step, so
    # every rank's next collective is the train step
    skip_check_at = step
    t_start = time.monotonic()
    metrics: Dict[str, Any] = {"loss": torch.tensor(float("nan"))}

    # the buddy tier: a rolling snapshot every snapshot_every steps, shipped
    # to a ring-offset buddy rank (another host when one exists); rebuilt on
    # every membership change (ranks shift)
    snapshot_every = cfg.snapshot_every or max(1, cfg.check_every)
    buddy: Optional[BuddySnapshots] = None

    def update_buddy() -> None:
        buddy.update(step, offset, dict(state.params.state_dict()),
                     state.opt_state.state_dict())

    def rebuild_buddy(seed: bool) -> None:
        """(Re-)derive the buddy assignment for the current peer list; with
        `seed`, stash and ship a snapshot at once, so the recovery ladder
        never finds the tier empty."""
        nonlocal buddy
        if buddy is not None:
            buddy.close()
            buddy = None
        if not heal_armed:
            return
        buddy = BuddySnapshots(peer)
        if seed and buddy_enabled():
            update_buddy()

    rebuild_buddy(seed=True)

    def save_ckpt(force: bool = False) -> None:
        if ckpt is None or not ckpt.writes:
            return
        ckpt.save(step, {"params": dict(state.params.state_dict()),
                         "opt": state.opt_state.state_dict()},
                  meta={"trained_samples": offset, "step": step, "cluster_size": peer.size,
                        "cluster_version": peer.cluster_version}, force=force)

    def detach_preempted() -> None:
        """SIGTERM: a durable checkpoint, self-removal from the cluster
        document (the survivors see a planned detach), DETACHED, exit 0."""
        log.warning("preemption: final checkpoint + detach at step %d", step)
        tracing.flush_dump("preempt")
        flush_completed = None
        if ckpt is not None:
            deadline = float(os.environ.get("KFT_PREEMPT_FLUSH_DEADLINE_S", "") or 30.0)
            try:
                save_ckpt(force=True)
                flush_completed = ckpt.wait(deadline_s=deadline)
                if flush_completed:
                    ckpt.close()
                else:  # close() would wait without bound; exit reaps the writer
                    log.warning("preemption: checkpoint flush missed the %.0fs deadline; "
                                "detaching with a durable-state gap", deadline)
            except Exception as e:  # noqa: BLE001 - the exit path must not throw
                flush_completed = False
                log.warning("preemption checkpoint failed: %s", e)
        if client is not None:
            from ..plan import Cluster, PeerList

            try:
                got = client.get_cluster()
                if got is not None and got[0].workers.rank(peer.self_id) is not None:
                    cl, v = got
                    rest = PeerList(p for p in cl.workers if p != peer.self_id)
                    client.put_cluster(Cluster(runners=cl.runners, workers=rest), version=v)
            except OSError as e:
                log.warning("preemption self-removal failed: %s", e)
        journal_event("preemption", step=step, trained_samples=offset,
                      flush_completed=flush_completed)
        print(f"DETACHED: preempted at step {step} ({offset} samples trained)", flush=True)
        sys.exit(0)

    def put_suspect(reason: str) -> None:
        """Best-effort `suspect/<self>` KV report on entering recovery: the
        launchers' remote-host judgment reads these to tell a partition
        from a host death."""
        try:
            client.kv_put(f"suspect/{peer.self_id}",
                          {"reason": reason, "step": int(step),
                           "cluster_version": peer.cluster_version})
        except Exception as e:  # noqa: BLE001 - a control-plane brownout
            log.debug("suspect report failed: %s", e)

    def clear_suspect() -> None:
        try:
            client.kv_delete(f"suspect/{peer.self_id}")
        except Exception as e:  # noqa: BLE001
            log.debug("suspect clear failed: %s", e)

    def beacon() -> None:
        """Rank 0 publishes its progress every check_every steps for
        step-keyed faults applied from outside the workers."""
        if not beacon_armed or peer.rank != 0 or step % cfg.check_every:
            return
        try:
            client.kv_put("progress", {"step": int(step), "size": peer.size,
                                       "cluster_version": peer.cluster_version})
        except Exception as e:  # noqa: BLE001
            log.debug("progress beacon failed: %s", e)

    def teardown_dirty() -> None:
        """Leave a group with a dead rank in it; the watchdog keeps the
        launcher-facing heartbeat fresh through the teardown's waits."""
        with stall_detector("heal_teardown", force=True):
            peer.close(graceful=False)

    def recover(cause: BaseException) -> None:
        """The suspected-dead-peer path: ladder -> save -> dirty teardown ->
        wait for the healer's document -> rejoin -> resync."""
        nonlocal trainer, programs, mesh_shape, state, data, offset, step, skip_check_at
        nonlocal pending_heal, metrics
        t_detect = time.perf_counter()
        m_detect = time.monotonic()
        old_size = peer.size
        reason = type(cause).__name__
        log.warning("suspected peer failure (%s: %s); entering recovery", reason,
                    str(cause)[:200])
        journal_event("peer_failure_suspected", reason=reason, detail=str(cause)[:200],
                      step=step, old_size=old_size)
        put_suspect(reason)
        phases: Dict[str, float] = {}
        # the ladder: the live state, this rank's rolling snapshot, the
        # buddy's copy, then verified disk steps; every demotion journaled
        outcome = ladder.climb(live_fn=lambda: _live_state(state), buddy=buddy, ckpt=ckpt,
                               step=step, offset=offset)
        if outcome is None:
            journal_event("recovery_exhausted", step=step, reason=reason)
            log.critical("recovery ladder exhausted; re-raising the failure")
            raise cause
        snap_params, snap_opt = outcome.params, outcome.opt
        if outcome.source != "live":
            log.warning("recovering from %s/%s: rolling back to step %d (%d samples)",
                        outcome.rung, outcome.source, outcome.step, outcome.offset)
        step, offset = outcome.step, outcome.offset
        phases["state_source_s"] = outcome.elapsed_s
        if ckpt is not None:
            try:
                # a best-effort durable point for the chosen state: the
                # primary alone, no collective (a disk source is durable)
                if ckpt.writes and not outcome.already_durable:
                    ckpt.save(step, {"params": snap_params, "opt": snap_opt},
                              meta={"trained_samples": offset, "step": step,
                                    "cluster_size": peer.size,
                                    "cluster_version": peer.cluster_version}, force=True)
                ckpt.release()
            except Exception as e:  # noqa: BLE001
                log.warning("recovery checkpoint failed: %s", e)
        # drop every reference into the dead group before the teardown: a
        # process group kept alive (by the failed step's frames, in the
        # exception's traceback) keeps its sockets open, and a peer blocked
        # opposite this rank then never sees the reset that sends it into
        # its own recovery.  The model keeps its tensors (they hold the
        # live state when the ladder took it).
        _drop_frames(cause)
        state = data = trainer = programs = None
        metrics = {"loss": torch.tensor(float("nan"))}
        gc.collect()
        m_td0 = time.monotonic()
        tracing.record_span("heal:detect", m_detect, m_td0, cat="heal", args={"reason": reason})
        phases["detect_s"] = round(m_td0 - m_detect, 4)
        teardown_dirty()
        m_rdv0 = time.monotonic()
        tracing.record_span("heal:teardown", m_td0, m_rdv0, cat="heal")
        phases["teardown_s"] = round(m_rdv0 - m_td0, 4)
        while True:
            deadline = time.monotonic() + cfg.heal_timeout_s
            got = None
            while time.monotonic() < deadline:
                if preempted["flag"]:
                    detach_preempted()
                if hb_file:
                    _touch(hb_file)  # waiting on the healer is liveness too
                g = client.poll_cluster()
                if g is not None and g[1] > peer.cluster_version:
                    got = g
                    break
                time.sleep(0.25)
            if got is None:
                log.critical("no healed cluster document within %.0fs; exiting so the "
                             "supervisor can act", cfg.heal_timeout_s)
                sys.exit(HEAL_WAIT_EXIT_CODE)
            cluster, version = got
            try:
                try:
                    with stall_detector("heal_re_rendezvous", force=True):
                        joined = peer.update_cluster(cluster, version)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:  # noqa: BLE001 - a rejoin is retryable
                    # a member of this document may be dead too: any init
                    # failure means "this document did not convene"
                    raise TimeoutError(f"re-rendezvous at v{version} failed: "
                                       f"{type(e).__name__}: {str(e)[:200]}") from e
                if not joined:
                    # the healer decided we were the dead one (a hang that
                    # came back after the heartbeat timeout): bow out
                    print(f"DETACHED: rank left cluster at version {version}", flush=True)
                    sys.exit(0)
                trainer, programs, mesh_shape = build()
                if ckpt is not None:
                    ckpt.set_primary(peer.rank == 0)
                m_sync0 = time.monotonic()
                # the rejoin spans teardown end -> the new group's rebuild,
                # failed attempts at older documents included
                tracing.record_span("heal:re_rendezvous", m_rdv0, m_sync0, cat="heal",
                                    args={"version": version})
                phases["re_rendezvous_s"] = round(m_sync0 - m_rdv0, 4)
                (offset, step), synced = programs.sync_state(
                    (offset, step), {"params": snap_params, "opt": snap_opt})
                m_sync1 = time.monotonic()
                tracing.record_span("heal:resync", m_sync0, m_sync1, cat="heal")
                phases["resync_s"] = round(m_sync1 - m_sync0, 4)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 - vetted below
                if not _suspected_peer_failure(e):
                    raise
                # another peer died between the healer's PUT and our rejoin
                # or sync: update_cluster advanced the version, so the wait
                # above takes only a strictly newer document
                log.warning("recovery attempt at v%d failed (%s: %s); waiting for a newer "
                            "cluster document", version, type(e).__name__, str(e)[:200])
                put_suspect(type(e).__name__)
                _drop_frames(e)
                trainer = programs = None
                gc.collect()
                m_rt0 = time.monotonic()
                teardown_dirty()
                tracing.record_span("heal:teardown", m_rt0, cat="heal", args={"retry": True})
                continue
            break
        tracing.record_span("heal", m_detect, cat="heal", args={
            "version": version, "old_size": old_size, "new_size": peer.size, "reason": reason})
        state = place(synced, step)
        del snap_params, snap_opt, synced
        # the healed group has met: the dead group's ring workspaces go
        reaped = peer_memory.reap_orphans(peer.config.peers)
        data = make_data(peer.rank, peer.size, offset)
        skip_check_at = step
        # new ranks: re-derive the buddy ring and seed it, so a second
        # failure right after this one still finds the RAM tier
        rebuild_buddy(seed=True)
        clear_suspect()
        pending_heal = {
            "version": version, "old_size": old_size, "new_size": peer.size,
            "reason": reason, "t_detect": t_detect,
            "recovery_rung": outcome.rung, "recovery_source": outcome.source,
            "recovery_demotions": len(outcome.demotions),
            "workspace_bytes_freed": reaped["freed"],
            "workspace_bytes_leaked": reaped["leaked"],
            "phases": dict(phases),
        }
        log.info("recovered onto %d-worker cluster at v%d from %s/%s; resuming at step %d",
                 peer.size, version, outcome.rung, outcome.source, step)

    def resize(cluster, version: int) -> None:
        """Snapshot, flush the checkpoint writer, leave the old group,
        rejoin at `version` (or exit if removed), rebuild, sync."""
        nonlocal trainer, programs, mesh_shape, state, data, offset, step, skip_check_at
        nonlocal resizes, first_step_after_resize, last_propose
        log.info("resizing to version %d: %d workers", version, cluster.size())
        leaving = cluster.workers.rank(peer.self_id) is None
        if leaving:
            # announce before the slow teardown: the watcher reconciles off
            # the config server and may SIGTERM this worker at any moment
            print(f"DETACHED: rank left cluster at version {version}", flush=True)
        ev = {"version": version, "old_size": peer.size, "new_size": cluster.size(),
              "phases": {}}
        if last_propose.get("size") == cluster.size():
            ev["propose_to_start_s"] = round(time.perf_counter() - last_propose["t"], 4)
        # cleared on every applied resize: a stale stamp would mis-attribute
        # a later same-size resize
        last_propose = {}
        t = [time.perf_counter()]

        def phase(name):
            now = time.perf_counter()
            ev["phases"][name] = round(now - t[0], 4)
            t[0] = now

        m_resize0 = time.monotonic()
        # a leaving rank needs no snapshot: it only takes part in the teardown
        snap_params, snap_opt = (None, None) if leaving else snap(state)
        state = None  # the old optimizer's state lives on in the snapshot only
        phase("snapshot")
        if ckpt is not None:
            ckpt.release()  # a detaching primary must not abandon queued saves
            phase("ckpt_release")
        peer.close()
        phase("teardown")
        if not peer.update_cluster(cluster, version):
            sys.exit(0)
        phase("reinit")
        trainer, programs, mesh_shape = build()
        phase("rebuild")
        if ckpt is not None:
            ckpt.set_primary(peer.rank == 0)  # primariness follows the new rank
        (offset, step), synced = programs.sync_state(
            (offset, step), {"params": snap_params, "opt": snap_opt})
        del snap_params, snap_opt
        state = place(synced, step)
        del synced
        phase("sync")
        data = make_data(peer.rank, peer.size, offset)
        skip_check_at = step
        # membership changed: the buddy ring is stale; re-derive and re-seed
        rebuild_buddy(seed=True)
        resizes += 1
        resize_events.append(ev)
        tracing.record_span("resize", m_resize0, cat="elastic",
                            args={"version": version, "old_size": ev["old_size"],
                                  "new_size": ev["new_size"]})
        first_step_after_resize = True

    def step_once() -> None:
        nonlocal state, metrics, offset, step, first_step_after_resize, last_propose
        nonlocal pending_heal

        if hb_file:
            _touch(hb_file)  # liveness for the healer's hang detection
        beacon()
        if chaos is not None:
            # ckpt_dir arms the checkpoint-integrity faults (corrupt_ckpt)
            chaos.on_step(step, chaos_rank, ckpt_dir=cfg.checkpoint_dir)

        # schedule-driven proposal (rank 0; reference hooks/elastic.py:14-88)
        if client is not None and schedule and peer.rank == 0:
            want = schedule.size_at(step)
            if want is not None and want != peer.size and propose_new_size(peer, want):
                last_propose = {"t": time.perf_counter(), "size": want}

        # resize check, every check_every steps
        if client is not None and step % cfg.check_every == 0 and step != skip_check_at:
            last_got: Dict[str, Any] = {}

            def observe() -> Tuple[int, int]:
                """(version, 31-bit document digest): every rank holds the
                same document, not just the same version, before anyone
                acts (the reference's consensus on the cluster's bytes)."""
                got = client.poll_cluster()  # an outage is None: keep training
                if got is None:
                    return peer.cluster_version, 0
                last_got["cluster"], last_got["version"] = got
                return got[1], int(got[0].digest()[:7], 16) & 0x7FFFFFFF

            version, _ = programs.agree_vec(observe(), timeout_s=cfg.consensus_timeout_s,
                                            refresh=observe)
            if version > peer.cluster_version:
                if last_got.get("version") == version:
                    resize(last_got["cluster"], version)
                else:  # unreachable given the digest consensus
                    log.warning("agreed version %d but no matching doc cached", version)
        # a SIGTERM acts after the resize check: the watcher's stop of a
        # removed worker must not keep it from the consensus and teardown
        # its group is waiting for
        if preempted["flag"]:
            detach_preempted()

        with tracing.trace_scope("step:data", cat="train", args={"step": step}):
            batch = trainer.shard_batch(next(data))
        t_fs = time.perf_counter()
        first = first_step_after_resize or pending_heal is not None
        with stall_detector("elastic_train_step", force=heal_armed):
            with tracing.trace_scope("step:train", cat="train",
                                     args={"step": step, "first_after_resize": first}):
                state, metrics = trainer.train_step(state, batch)
                if first:
                    float(metrics["loss"])  # the step's work inside its time
        _mark_live(state.opt_state)
        if first_step_after_resize:
            ev = resize_events[-1]
            ev["phases"]["first_step"] = round(time.perf_counter() - t_fs, 4)
            ev["total_s"] = round(sum(ev["phases"].values()), 4)
            if "propose_to_start_s" in ev:
                # propose -> config server -> poll -> consensus -> resize -> first step
                ev["propose_to_done_s"] = round(ev["propose_to_start_s"] + ev["total_s"], 4)
            journal_event("resize", version=ev["version"], old_size=ev["old_size"],
                          new_size=ev["new_size"], phases=ev["phases"], total_s=ev["total_s"])
            first_step_after_resize = False
        if pending_heal is not None:
            # MTTR: failure detection -> the first completed step after the heal
            hev = dict(pending_heal)
            now = time.perf_counter()
            hev["mttr_s"] = round(now - hev.pop("t_detect"), 4)
            hev.setdefault("phases", {})["first_step_s"] = round(now - t_fs, 4)
            heal_events.append(hev)
            journal_event("heal", **hev)
            log.info("healed %d -> %d workers from %s/%s: mttr %.2fs", hev["old_size"],
                     hev["new_size"], hev["recovery_rung"], hev["recovery_source"],
                     hev["mttr_s"])
            pending_heal = None
        offset += cfg.batch_size * trainer.world
        step += 1
        if buddy is not None and buddy_enabled() and step % snapshot_every == 0:
            update_buddy()
        if ckpt is not None and ckpt.writes:
            if step % max(1, cfg.checkpoint_every) == 0:
                with tracing.trace_scope("step:checkpoint", cat="train", args={"step": step}):
                    save_ckpt()
            else:
                ckpt.finalize_manifests()

    while offset < cfg.total_samples:
        m_step0 = time.monotonic()
        step_before = step
        try:
            step_once()
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 - vetted below
            if not (heal_armed and _suspected_peer_failure(e)):
                raise
            recover(e)
        else:
            tracing.record_span("step", m_step0, cat="train", args={"step": step_before})

    if prev_sigterm is not None:
        signal.signal(signal.SIGTERM, prev_sigterm)
    if buddy is not None:
        buddy.close()
    if ckpt is not None:
        ckpt.wait()  # settle queued saves: latest_step lists finalized steps only
        if ckpt.writes and ckpt.latest_step() != step:
            save_ckpt(force=True)
        ckpt.close()

    loss = float(metrics["loss"])
    dt = time.monotonic() - t_start
    totals = sorted(e.get("total_s", sum(e["phases"].values())) for e in resize_events)

    def pct(p: float) -> Optional[float]:
        # nearest rank: ceil(p * n) - 1
        if not totals:
            return None
        return round(totals[max(0, math.ceil(p * len(totals)) - 1)], 4)

    return {
        "loss": loss,
        "trained_samples": offset,
        "resizes": resizes,
        "final_size": peer.size,
        "seconds": dt,
        "resize_events": resize_events,
        "resize_p50_s": pct(0.50),
        "resize_p95_s": pct(0.95),
        "heals": len(heal_events),
        "heal_events": heal_events,
        "mttr_s": heal_events[-1]["mttr_s"] if heal_events else None,
        "mesh": mesh_shape,
        "state": state,
        "trainer": trainer,
    }


__all__ = ["ElasticConfig", "HEAL_WAIT_EXIT_CODE", "run_elastic"]
