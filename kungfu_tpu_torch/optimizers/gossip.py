"""Gossip (pair averaging): AD-PSGD (counterpart of
kungfu_tpu.optimizers.gossip).

Reference: PairAveragingOptimizer (srcs/python/kungfu/tensorflow/optimizers/
async_sgd.py:73-140): each worker picks a peer, *pulls* that peer's model,
averages halves, and applies its local gradients.  The pull is directed:
the requester averages, the target does not.

Three forms, as in the JAX package:

  pair_averaging    directed ring gossip in step with the group: each step
                    every rank i pulls rank (i + s) mod n's parameters, s
                    drawn from a shift set S (the powers of two below n,
                    hypercube gossip) by a generator every rank seeds
                    alike, and its MAX over the group taken, so every rank
                    shifts by the same s.  The pull is a ring shift of the
                    parameters packed into flat buffers of at most
                    CHUNK_BYTES: `ops.fused_matmul.ring_shift`, B11 over
                    CUDA IPC on a card (gloo has no GPU send/recv; ranks
                    sharing a card must use gloo), its plain
                    `batch_isend_irecv` on the CPU.
  HostPairAveraging the reference's asynchronous form over the host blob
                    store (`store.py`): a random peer's latest published
                    model, averaged on the host (`native.average_f32`).
  OverlappedHostPairAveraging  the same with the store's traffic and the
                    model's copies on a worker thread.

Where the port differs from the JAX package (ROADMAP "Differences kept on
purpose"):
- the random selector's index and the randk / int8-sr wire draw from a
  `torch.Generator`, not `jax.random`: the same on every rank, other bits;
- each step sets every parameter to its mixed value, then steps the inner
  optimizer: the result is `mixed + u`, where the JAX package adds
  `u + (mixed - params)` to `params`, which rounds apart in the last bit;
- the host blob starts with a digest of the float leaves' shapes and
  dtypes, and `mix()` skips a pull whose digest is not its own (the JAX
  package compares element counts only);
- `OverlappedHostPairAveraging.close()` first waits, bounded, for a
  queued publish to reach the store.
"""
from __future__ import annotations

import hashlib
import threading
import time
import weakref
from typing import Callable, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import compression as Comp
from ..compression.collectives import pair_mix, pair_shift, pair_wire, shift_wire
from ..utils import get_logger
from .sync import OptimizerWrapper, _world

log = get_logger("kungfu.gossip")

CHUNK_BYTES = 256 << 20  # a pull's packed buffers: B11's slot grows to the largest call
_ALIGN = 16  # bytes: each tensor's place in a packed buffer (B11 moves 16-byte vectors)


class GossipState(NamedTuple):
    generator: torch.Generator  # the shift index's and the wire's draws; alike on every rank
    step: int


def _shift_set(n: int) -> Tuple[int, ...]:
    """Powers of two < n (hypercube schedule), always including 1."""
    s, k = [], 1
    while k < n:
        s.append(k)
        k *= 2
    return tuple(s) if s else (0,)


def _round_up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _pack(wires: Sequence[Tuple[torch.Tensor, ...]]) -> List[torch.Tensor]:
    """One uint8 buffer per wire stream (the first tensors of every wire,
    then the second ones), each tensor at a 16-byte-aligned place."""
    out = []
    for k in range(len(wires[0])):
        views = [w[k].reshape(-1).view(torch.uint8) for w in wires]
        buf = torch.zeros(sum(_round_up(v.numel()) for v in views), dtype=torch.uint8,
                          device=views[0].device)
        off = 0
        for v in views:
            buf[off:off + v.numel()].copy_(v)
            off += _round_up(v.numel())
        out.append(buf)
    return out


def _unpack(bufs: Sequence[torch.Tensor], wires: Sequence[Tuple[torch.Tensor, ...]]
            ) -> List[Tuple[torch.Tensor, ...]]:
    """The received wires: views of `bufs` laid out as `_pack` laid out `wires`."""
    out = [[] for _ in wires]
    for k, buf in enumerate(bufs):
        off = 0
        for i, w in enumerate(wires):
            nb = w[k].numel() * w[k].element_size()
            out[i].append(buf[off:off + nb].view(w[k].dtype).view(w[k].shape))
            off += _round_up(nb)
    return [tuple(o) for o in out]


def _chunks(params: Sequence[torch.Tensor], wire_of: Callable):
    """(leaves, their wires) in consecutive groups of at most CHUNK_BYTES
    of wire (a larger leaf alone), each wire made as its group fills."""
    leaves, wires, size = [], [], 0
    for p in params:
        w = wire_of(p)
        nb = sum(_round_up(t.numel() * t.element_size()) for t in w)
        if leaves and size + nb > CHUNK_BYTES:
            yield leaves, wires
            leaves, wires, size = [], [], 0
        leaves.append(p)
        wires.append(w)
        size += nb
    if leaves:
        yield leaves, wires


def pull_mix_(params: Sequence[torch.Tensor], group, shift: int, config=None,
              generator: Optional[torch.Generator] = None) -> None:
    """Average every tensor of `params` in place with the same tensor of
    the rank `shift` places after this one (rank i pulls rank i + shift),
    its wire under `config` (`compression.pair_wire`, each leaf quantized
    or sparsified on its own, as the JAX package maps the pull over the
    tree).  The wires are packed into flat buffers of at most CHUNK_BYTES
    and each chunk is one ring shift (one or two buffers: B11 moves bytes,
    so codes and scales, or values and indices, go in one call).  A shift
    is a copy, so the bits equal a pull leaf by leaf."""
    cfg = Comp.resolve(config)
    with torch.no_grad():
        for leaves, wires in _chunks(params, lambda p: pair_wire(p, cfg, generator)):
            sent = _pack(wires)
            received = shift_wire(sent, group, -shift)
            for p, got in zip(leaves, _unpack(received, wires)):
                p.copy_(pair_mix(p, got, cfg))


class PairAveragingOptimizer(OptimizerWrapper):
    """Directed ring gossip, then the inner optimizer on the local gradients."""

    def __init__(self, inner, group=None, shifts: Optional[Sequence[int]] = None,
                 selector: str = "random", seed: int = 0, compression=None):
        super().__init__(inner, group)
        if selector not in ("random", "roundrobin"):
            raise ValueError(f"selector must be 'random' or 'roundrobin', got {selector!r}")
        n = _world(group)
        self.shifts = tuple(shifts) if shifts is not None else _shift_set(n)
        for s in self.shifts:  # i receives from i + s
            pair_shift([((i + s) % n, i) for i in range(n)], n)
        self.selector = selector
        self.config = Comp.resolve(compression) if compression is not None else Comp.NONE
        self.state = GossipState(torch.Generator().manual_seed(seed), 0)

    def _wire_generator(self, device) -> Optional[torch.Generator]:
        """This step's generator of the randk subset or the stochastic
        rounding, seeded from the state's generator (alike on every rank)."""
        cfg = self.config
        if cfg.scheme != "randk" and not (cfg.is_quantized and cfg.stochastic):
            return None
        seed = int(torch.randint(2**62, (), generator=self.state.generator))
        return torch.Generator(device=device).manual_seed(seed)

    def select(self) -> int:
        """This step's shift: the selector's index into the shift set,
        MAX-folded over the group (the JAX package's `lax.pmax`), so every
        rank shifts alike even if their generators drifted."""
        s = self.state
        if self.selector == "roundrobin":
            idx = s.step % len(self.shifts)
        else:
            idx = int(torch.randint(len(self.shifts), (), generator=s.generator))
        if _world(self.group) > 1:
            t = torch.tensor(idx, dtype=torch.int64, device=self.params()[0].device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
            idx = int(t.item())
        return self.shifts[idx]

    def step(self) -> None:
        params = self.params()
        if _world(self.group) > 1 and self.shifts != (0,):
            shift = self.select()
            pull_mix_(params, self.group, shift, self.config,
                      self._wire_generator(params[0].device))
        self.inner.step()
        self.state = GossipState(self.state.generator, self.state.step + 1)


def pair_averaging(inner: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer],
                   group: Optional[dist.ProcessGroup] = None,
                   shifts: Optional[Sequence[int]] = None, selector: str = "random",
                   seed: int = 0, compression=None, analyze: Optional[bool] = None
                   ) -> Callable[[Iterable[torch.nn.Parameter]], PairAveragingOptimizer]:
    """PairAveragingOptimizer factory: directed randomized gossip + local
    gradients.  Each step rank i pulls rank (i + s) mod n's parameters,
    s from `shifts` (default: the powers of two below n) by `selector`
    ("random": drawn from a generator seeded `seed` on every rank;
    "roundrobin": step mod |S|), sets each parameter to the average, then
    steps `inner(params)` on its local gradients:

        p <- (p + p_partner) / 2 + inner's update at the mixed parameters

    Every shift's pairing is validated as the JAX package validates it
    (`plan.graph.validate_permutation`, here through
    `compression.collectives.pair_shift`).  `compression` diets
    the pull's wire: bf16/int8/fp8 quantize the pulled model (the average
    in f32), topk/randk exchange only k·n coordinates of each leaf.
    The ranks' models differ between steps; run it under
    `DataParallelTrainer(per_replica_params=True)`.  `analyze` (kf-lint)
    needs ROADMAP A.8 and raises if set."""
    if analyze:
        raise NotImplementedError(
            "pair_averaging(analyze=True): the kf-lint hook needs the analysis package, "
            "not ported yet (ROADMAP A.8)")
    if compression is not None:
        Comp.resolve(compression)

    def make(params: Iterable[torch.nn.Parameter]) -> PairAveragingOptimizer:
        return PairAveragingOptimizer(inner(params), group, shifts, selector, seed, compression)

    return make


# -- the host variants over the blob store --------------------------------------

HEADER = 4  # f32 words of the blob's layout digest


def _mixable(t: torch.Tensor) -> bool:
    # only float leaves participate in averaging; integer state (step
    # counters, index tables) must not be fractionally mixed
    return t.is_floating_point()


def layout_digest(params: Sequence[torch.Tensor]) -> np.ndarray:
    """The float leaves' shapes and dtypes as HEADER uint32 words."""
    text = ";".join(f"{t.dtype}:{tuple(t.shape)}" for t in params if _mixable(t))
    return np.frombuffer(hashlib.sha256(text.encode()).digest()[:4 * HEADER], np.uint32)


class HostPairAveraging:
    """Asynchronous pair averaging over the host-side p2p blob store.

    The reference's AD-PSGD (optimizers/async_sgd.py:73-140): each step
    the worker (1) picks a random peer (`np.random.RandomState(seed +
    rank)`, as in the JAX package), (2) pulls that peer's fused model from
    its blob store (possibly a stale version; no lockstep), (3) averages
    halves with the native kernel, (4) applies local gradients.  `peer`
    is a `peer.Peer` (or any object with rank, size, save and request).

    The blob is f32: HEADER words of `layout_digest`, then every float
    tensor's values in order.  `mix()` skips a pulled blob whose digest is
    not its own (another model, or one mid-resize)."""

    NAME = "gossip-model"

    def __init__(self, peer, seed: int = 0):
        self.peer = peer
        self.rng = np.random.RandomState(seed + peer.rank)
        self._published = False

    def _fuse(self, params: Sequence[torch.Tensor]) -> np.ndarray:
        """The blob of `params`: one host copy (device to host per tensor)."""
        leaves = [p.detach() for p in params if _mixable(p)]
        flat = torch.empty(HEADER + sum(p.numel() for p in leaves), dtype=torch.float32)
        out = flat.numpy()
        out[:HEADER].view(np.uint32)[:] = layout_digest(params)
        off = HEADER
        for p in leaves:
            flat[off:off + p.numel()].copy_(p.reshape(-1))
            off += p.numel()
        return out

    @staticmethod
    def _defuse_(flat, params: Sequence[torch.Tensor]) -> None:
        """Write the body of a blob (a numpy or torch f32 vector) into the
        float tensors of `params`, in place."""
        flat = torch.as_tensor(flat)
        off = HEADER
        with torch.no_grad():
            for p in params:
                if _mixable(p):
                    p.copy_(flat[off:off + p.numel()].view(p.shape))
                    off += p.numel()

    def _random_peer(self) -> int:
        n = self.peer.size
        r = int(self.rng.randint(0, n - 1))
        return r if r < self.peer.rank else r + 1  # skip self (async_sgd.py:73)

    def _matches(self, other, params) -> bool:
        got = np.asarray(other[:HEADER]).view(np.uint32)
        if other.size >= HEADER and np.array_equal(got, layout_digest(params)):
            return True
        log.warning("skipping pulled model: layout digest %s != local %s",
                    got.tobytes().hex(), layout_digest(params).tobytes().hex())
        return False

    def mix(self, params: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        """One gossip pull + average into `params` (in place); returns them.

        Call BEFORE the local gradient step, then `publish` the
        post-gradient parameters: the reference saves the model after
        applying local gradients (async_sgd.py:127-140), so peers always
        pull a model that includes the owner's latest local step."""
        from .. import native

        params = list(params)
        mine = self._fuse(params)
        if not self._published:
            # step 0: publish before the first pull (async_sgd.py:105-110)
            self.peer.save(self.NAME, mine)
            self._published = True
        if self.peer.size > 1:
            # non-blocking: a peer that has not published yet is skipped
            other = self.peer.request(self._random_peer(), self.NAME, wait=False)
            if other is not None:
                other = other.reshape(-1)
                if self._matches(other, params):
                    body = other[HEADER:].astype(np.float32, copy=False)
                    native.average_f32(mine[HEADER:], body)
                    self._defuse_(mine, params)
        return params

    def publish(self, params: Sequence[torch.Tensor]) -> None:
        """Save the POST-gradient model to the blob store (the reference's
        SaveVariable, async_sgd.py:138-140)."""
        self.peer.save(self.NAME, self._fuse(list(params)))
        self._published = True


def _overlap_worker(ref, wake) -> None:
    """Worker loop of OverlappedHostPairAveraging.  Module-level, holding
    only a weakref and the event: a bound-method target would pin the
    instance (the thread is a GC root); the bounded wait lets the thread
    notice the instance is gone and exit."""
    while True:
        wake.wait(timeout=1.0)
        wake.clear()
        self = ref()
        if self is None or self._stop:
            return
        self._worker_iteration()
        del self


class OverlappedHostPairAveraging(HostPairAveraging):
    """HostPairAveraging with every host round-trip off the critical path.

      publish()  clones the parameters on the device and hands the clones
                 to the worker thread, which copies them to the host and
                 saves the blob while the next step runs.
      thread     pulls a random peer's blob and places its body on the
                 device on a side CUDA stream, recording an event.
      mix()      takes the latest completed pull, makes the current stream
                 wait for its event, and averages on the device in f32.

    Cost: one step more staleness (a pull started at step k mixes at step
    k + 1), which AD-PSGD tolerates by design, and one device copy of the
    parameters per publish.  `close()` first flushes a queued publish
    (bounded by `flush()`'s timeout), then stops the thread; an abandoned
    instance is collectable and `__del__` closes it."""

    def __init__(self, peer, seed: int = 0):
        super().__init__(peer, seed)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._pull = None  # latest completed pull: (digest words, body on the device, event)
        self._publish_req = None  # latest publish request: (clones, event after them)
        self._publish_inflight = False  # popped, save() not done
        self._publish_error = None  # last publish failure, cleared by publish()
        self._device = None  # where the parameters live (set by mix/publish)
        self._side = None  # the side stream of the pulls' host-to-device copies
        self._thread = threading.Thread(target=_overlap_worker,
                                        args=(weakref.ref(self), self._wake),
                                        name="gossip-overlap", daemon=True)
        self._thread.start()

    def _place(self, body: np.ndarray):
        """(the body on the parameters' device, the event after its copy)."""
        dev = self._device
        if dev is None or dev.type != "cuda":
            return torch.from_numpy(body), None
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._side):
            out = torch.from_numpy(body).to(dev)
            done = torch.cuda.Event()
            done.record(self._side)
        return out, done

    def _worker_iteration(self) -> None:
        with self._lock:
            req, self._publish_req = self._publish_req, None
            if req is not None:
                self._publish_inflight = True
        try:
            if req is not None:
                clones, ready = req
                try:
                    if ready is not None:
                        ready.synchronize()  # the clones are made
                    self.peer.save(self.NAME, self._fuse(clones))
                    self._published = True
                except Exception as e:
                    with self._lock:
                        self._publish_error = e
                    raise
                finally:
                    with self._lock:
                        self._publish_inflight = False
            if self.peer.size > 1 and self._published:
                other = self.peer.request(self._random_peer(), self.NAME, wait=False)
                if other is not None:
                    other = other.reshape(-1).astype(np.float32, copy=False)
                    body, done = self._place(other[HEADER:])
                    with self._lock:
                        self._pull = (other[:HEADER].copy(), body, done)
        except Exception as e:  # a lost partner never fails the training step
            log.warning("overlap worker: %s", e)

    def mix(self, params: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        params = list(params)
        self._device = params[0].device
        if not self._published:
            # the step-0 publish stays synchronous: peers must find a model
            self.peer.save(self.NAME, self._fuse(params))
            self._published = True
        with self._lock:
            pull, self._pull = self._pull, None
        if pull is not None and self._matches(pull[0], params):
            _, body, done = pull
            if done is not None:
                cur = torch.cuda.current_stream(body.device)
                cur.wait_event(done)
                body.record_stream(cur)
            off = 0
            with torch.no_grad():
                for p in params:
                    if _mixable(p):
                        other = body[off:off + p.numel()].view(p.shape)
                        p.copy_(((p.float() + other) / 2).to(p.dtype))
                        off += p.numel()
        self._wake.set()  # start the next pull now
        return params

    def publish(self, params: Sequence[torch.Tensor]) -> None:
        params = list(params)
        self._device = params[0].device
        # a device copy first: the next step updates the parameters in
        # place while the worker thread is still reading them
        with torch.no_grad():
            clones = [p.detach().clone() for p in params]
        ready = None
        if self._device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        with self._lock:
            self._publish_req = (clones, ready)  # latest wins
            self._publish_error = None
        self._wake.set()

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until the queued publish (if any) has reached the store.
        False if the timeout expired with a publish pending or it failed."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._publish_error is not None:
                    return False
                if self._publish_req is None and not self._publish_inflight:
                    return True
            self._wake.set()
            time.sleep(0.005)
        return False

    def close(self) -> None:
        if self._thread.is_alive() and not self._stop:
            self.flush()
        self._stop = True
        self._wake.set()
        if self._thread.is_alive() and self._thread is not threading.current_thread():
            self._thread.join(timeout=5)

    def __del__(self):  # gc-time: stop the thread, wait for nothing
        self._stop = True
        self._wake.set()
