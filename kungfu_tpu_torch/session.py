"""Session: the collective engine bound to one mesh and a strategy
(counterpart of kungfu_tpu/session.py).

Re-design of the reference Session (srcs/go/kungfu/session/session.go:
21-37): the reference holds a PeerList with reduce/broadcast graphs and
runs message passing; the JAX Session holds a mesh and compiles each
collective with XLA.  This one holds the port's `Mesh` (one
torch.distributed group an axis) and a Strategy, and a strategy swap
(`set_strategy`, the SetGlobalStrategy analog, session/adaptation.go:8-20)
switches the route later calls take.

Convention: one process is one rank with one card.  Every method takes
this rank's tensor and returns this rank's result; tensors stay on their
device.  `all_reduce` returns the reduction, `all_gather` (n, ...) in
rank order, `gather` (n, ...) on the root and zeros elsewhere, `reduce`
the reduction on the root and zeros elsewhere, `consensus` a bool every
rank agrees on.  The JAX Session is single-controller and stacks every
rank's value on a leading dim (`lift`, `local_row`, the stacked-shape
check); none of those exists here.

The route table.  A route is chosen before the call, by the strategy's
`Impl`, the op, the dtype and the wire format, never by payload size and
never after a failure; `route()` returns it, and the span of every
collective carries it as `collective_impl`.  `all_reduce_route` and
`run_route` are the one table: `optimizers.sync` takes its gradient
reductions from them too, by the `Impl` its `impl=` names.


  ring_kernels             B5 then B6 (ops/ring_collectives.ring_all_reduce):
                           PALLAS_RING, PALLAS_FUSED_MATMUL and
                           PALLAS_RING_FUSED without a quantized wire, on
                           f32 or bf16 with sum or mean (a bf16 wire: the
                           kernels on the bf16 cast, `fused_ring_all_reduce`)
  fused_ring_kernels       B7 then B8 (ring_collectives.fused_ring_all_reduce):
                           a Pallas strategy with a deterministic int8/fp8
                           wire, sum or mean
  ring                     the ring of ops/collective.py over point-to-point:
                           RING's sum, and a Pallas strategy's sum or mean of
                           a dtype the kernels do not take (the JAX wrapper's
                           own route, pallas_collectives.py:207-210; the mean
                           is the sum times 1/n)
  rs_ag                    reduce-scatter + all-gather (CLIQUE, MULTI_STAR): sum
  hierarchical             ici reduce-scatter, dcn all-reduce, ici all-gather
                           (BINARY_TREE_STAR on a dcn x ici mesh)
  compressed               compression.all_reduce: a wire on a non-Pallas
                           strategy, and what B7/B8 do not run (a stochastic
                           config, an op other than sum and mean)
  compressed_hierarchical  compression.hierarchical_all_reduce: a per-leg wire,
                           or a wire on a dcn x ici mesh (the dcn leg)
  one_shot                 torch.distributed's all_reduce (prod: all_gather,
                           then the product in rank order): STAR, TREE,
                           BINARY_TREE, the ops the rings do not take, and
                           every other kind (reduce, broadcast, all_gather,
                           gather, cross_all_reduce, barrier, consensus)

On a CPU tensor the kernel routes run their kernels' plain versions over
the group, and the tag says so (`ring_kernels_plain`,
`fused_ring_kernels_plain`); on a CUDA tensor they launch the kernels or
raise.  No route catches a kernel's failure, and none moves a tensor to
another device except through host memory on a gloo group
(ops/collective.py), which the ring kernels never need.

Each collective waits for its work (the stream's synchronize, and for the
ring kernels `peer_memory.check_all`, which raises a kernel's timeout)
before its time lands in `stats`, so `throughput` is bytes over the
collective's time, not the host's issue time.  `analyze=True` (or
KUNGFU_ANALYZE=1) and `program_for` need kf-lint and the planner (ROADMAP
A.8) and raise; the byte and latency counters of `monitor.counters`
(the JAX Session's `_byte_counters`) are not kept until A.8 ports them.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import compat
from . import compression as Comp
from .ops import collective as C
from .ops import peer_memory
from .ops import ring_collectives as RC
from .plan import PALLAS_IMPLS, Impl, Mesh, Strategy, impl_of, make_mesh
from .utils import get_logger
from .utils.stall import stall_detector

log = get_logger("kungfu.session")

KERNEL_DTYPES = (torch.float32, torch.bfloat16)  # what B5/B6 reduce
KERNEL_OPS = ("sum", "mean")  # what B5-B8 compute
KERNEL_ROUTES = ("ring_kernels", "fused_ring_kernels")


def all_reduce_route(impl: Impl, op: str, dtype: torch.dtype, cfg,
                     hierarchical: bool = False) -> str:
    """The all_reduce route (module docstring) of an impl, op, dtype and
    effective wire (None, a CompressionConfig or a per-leg AxisConfig);
    `hierarchical`: the ranks form a dcn x ici mesh."""
    if isinstance(cfg, Comp.AxisConfig):
        return "compressed_hierarchical"
    if cfg is not None:
        if impl in PALLAS_IMPLS and op in KERNEL_OPS:
            if cfg.scheme in ("none", "bf16"):
                return "ring_kernels"
            if cfg.is_quantized and not cfg.stochastic:
                return "fused_ring_kernels"
        return ("compressed_hierarchical" if hierarchical and impl not in PALLAS_IMPLS
                else "compressed")
    if impl in PALLAS_IMPLS:
        if op in KERNEL_OPS:
            return "ring_kernels" if dtype in KERNEL_DTYPES else "ring"
        return "one_shot"
    if impl is Impl.HIERARCHICAL:
        return "hierarchical"
    if op == "sum" and impl in (Impl.RING, Impl.RS_AG):
        return "ring" if impl is Impl.RING else "rs_ag"
    return "one_shot"


def run_route(route: str, x: torch.Tensor, group, op: str = "sum", cfg=None,
              mesh: Optional[Mesh] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Run one all_reduce route on this rank's x over `group`; the
    hierarchical routes run over `mesh`'s ici and dcn groups, and
    `generator` drives a compressed route's stochastic rounding."""
    if route == "ring_kernels":
        if cfg is not None:  # a bf16 wire: B5/B6 on the cast
            return RC.fused_ring_all_reduce(x, group, cfg, op)
        return RC.ring_all_reduce(x, group, op)
    if route == "fused_ring_kernels":
        return RC.fused_ring_all_reduce(x, group, cfg, op)
    if route == "ring":
        out = C.ring_all_reduce(x, group, "sum")
        return out * (1.0 / C._world(group)) if op == "mean" else out
    if route == "rs_ag":
        return C.rs_ag_all_reduce(x, group, op)
    if route == "hierarchical":
        return C.hierarchical_all_reduce(x, mesh.group("ici"), mesh.group("dcn"), op)
    if route == "compressed":
        return Comp.all_reduce(x, group, cfg, op=op, generator=generator)
    if route == "compressed_hierarchical":
        legs = (cfg.get("ici"), cfg.get("dcn")) if isinstance(cfg, Comp.AxisConfig) \
            else (None, cfg)
        return Comp.hierarchical_all_reduce(x, mesh.group("ici"), mesh.group("dcn"), *legs,
                                            op=op, generator=generator)
    return C.all_reduce(x, group, op)


class OpStats:
    """Per-named-op throughput accounting (reference session/strategy.go:22-56).

    The first call per op name is excluded from throughput, as in the JAX
    package (there it pays the compile; here a ring workspace's first
    allocation).
    """

    def __init__(self):
        self.calls: Dict[str, List[Tuple[int, float]]] = {}
        self._warmed: set = set()

    def record(self, name: str, nbytes: int, seconds: float) -> None:
        if name not in self._warmed:
            self._warmed.add(name)
            return
        self.calls.setdefault(name, []).append((nbytes, seconds))

    def throughput(self, name: Optional[str] = None) -> float:
        """Bytes/sec over recorded calls (all ops if name is None)."""
        items = (
            self.calls.get(name, [])
            if name is not None
            else [x for v in self.calls.values() for x in v]
        )
        total_b = sum(b for b, _ in items)
        total_s = sum(s for _, s in items)
        return total_b / total_s if total_s > 0 else 0.0

    def reset(self) -> None:
        self.calls.clear()


class Session:
    """Collective session over the ranks of a mesh.

    Args:
      mesh: the rank mesh; default `make_mesh(dp=-1)`, every rank on "dp".
      strategy: initial collective strategy (AUTO resolves by host count).
      host_count: number of hosts backing the mesh (drives AUTO and the
        hierarchical strategies).
      analyze: the kf-lint hook; True (or None with KUNGFU_ANALYZE=1)
        raises until ROADMAP A.8.
      device: where `barrier` makes its tensor ("cuda" unless "cpu").
    """

    def __init__(self, mesh: Optional[Mesh] = None, strategy: Strategy = Strategy.AUTO,
                 host_count: int = 1, analyze: Optional[bool] = None, device=None):
        from .utils.envflag import analyze_enabled

        if analyze_enabled(analyze):
            raise NotImplementedError("Session(analyze=True): kf-lint is not ported yet "
                                      "(ROADMAP A.8)")
        self.mesh = mesh if mesh is not None else make_mesh(dp=-1)
        self.device = compat.resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())  # this rank's card
        self.strategy = strategy
        self.host_count = host_count
        self.stats = OpStats()
        # the installed default wire (a CompressionConfig or a per-leg
        # AxisConfig; None = full precision): all_reduce(compression=None)
        # reads it, the wire analog of set_strategy
        self.compression = None
        self.tree = None
        names = self.mesh.axis_names
        self._hierarchical_axes = ("ici", "dcn") if ("ici" in names and "dcn" in names) else None
        self._axes: Tuple[str, ...] = tuple(names)
        # the group over all the session's axes: the axis's own, or the world
        # (a mesh covers every rank)
        self._group = self.mesh.group(names[0]) if len(names) == 1 else None

    # -- properties -------------------------------------------------------------------

    @property
    def size(self) -> int:
        return self.mesh.size

    def set_strategy(self, strategy: Strategy) -> None:
        """Runtime strategy swap (SetGlobalStrategy analog)."""
        from .monitor.journal import journal_event

        log.info("strategy swap: %s -> %s", self.strategy.name, strategy.name)
        journal_event("strategy_switch", old=self.strategy.name, new=strategy.name)
        self.strategy = strategy

    def set_compression(self, compression) -> None:
        """Install the session-default wire format: a CompressionConfig, a
        registered name, a {leg: config} mapping ("ici"/"dcn" per-leg wire
        dtypes on a hierarchical mesh), or None for full precision.  Later
        all_reduce calls that pass no compression take it."""
        from .monitor.journal import journal_event

        new = self._resolve_compression(compression)
        old = self.compression
        desc = lambda c: "none" if c is None else c.describe()  # noqa: E731
        log.info("wire swap: %s -> %s", desc(old), desc(new))
        journal_event("compression_switch", old=desc(old), new=desc(new), source="session")
        self.compression = new

    def _resolve_compression(self, compression):
        """Normalize to the installed form: None (= full precision), a
        CompressionConfig, or a per-leg AxisConfig."""
        if compression is None:
            return None
        if isinstance(compression, Comp.AxisConfig):
            return compression if compression.is_compressed else None
        if isinstance(compression, dict):
            ax = Comp.AxisConfig.make(compression)
            return ax if ax.is_compressed else None
        cfg = Comp.resolve(compression)
        return None if cfg.scheme == "none" else cfg

    def set_tree(self, forest) -> None:
        """Install an explicit bcast tree (SimpleSetGlobalStrategy analog,
        session/adaptation.go:22-28; father-array encoding like the MST's
        output).  The tree selects the nearest implementation family
        (plan.strategy_for_tree) and is kept for introspection."""
        from .plan.graph import Graph
        from .plan.strategy import strategy_for_tree

        g = Graph.from_forest_array(list(forest))  # reduce orientation
        self.tree = g.reverse()  # bcast orientation for introspection
        self.set_strategy(strategy_for_tree(g))

    def _impl(self, strategy: Optional[Strategy]) -> Impl:
        s = strategy if strategy is not None else self.strategy
        impl = impl_of(s, self.host_count)
        if impl is Impl.HIERARCHICAL and self._hierarchical_axes is None:
            impl = Impl.RS_AG  # no ici/dcn split on this mesh
        if (impl is Impl.RING or impl in PALLAS_IMPLS) and len(self._axes) != 1:
            impl = Impl.RS_AG  # an explicit ring needs a single data axis
        return impl

    def _effective_wire(self, cfg):
        """An AxisConfig stays per-leg only on a mesh with ici and dcn axes;
        on a flat mesh it flattens to the one live leg (dcn when the session
        spans hosts, else ici).  Returns None, a non-none CompressionConfig,
        or an AxisConfig."""
        if cfg is None or not isinstance(cfg, Comp.AxisConfig):
            return cfg
        if self._hierarchical_axes is not None:
            return cfg
        flat = cfg.get("dcn") if self.host_count > 1 else cfg.get("ici")
        return None if flat.scheme == "none" else flat

    # -- the route table ---------------------------------------------------------------

    def _all_reduce_route(self, impl: Impl, op: str, dtype: torch.dtype, cfg) -> str:
        return all_reduce_route(impl, op, dtype, cfg, self._hierarchical_axes is not None)

    def route(self, x: torch.Tensor, op: str = "sum", strategy: Optional[Strategy] = None,
              compression=None) -> str:
        """The route all_reduce takes for this rank's x (the span's
        `collective_impl`): a name of the module docstring's table, with
        `_plain` after a kernel route on a CPU tensor."""
        if compression is None:
            cfg = self.compression
        else:
            cfg = self._resolve_compression(compression)
        return self._tag(self._all_reduce_route(self._impl(strategy), op, x.dtype,
                                                self._effective_wire(cfg)), x)

    @staticmethod
    def _tag(route: str, x: torch.Tensor) -> str:
        return route + "_plain" if route in KERNEL_ROUTES and not x.is_cuda else route

    def _reduce(self, route: str, x: torch.Tensor, op: str, cfg) -> torch.Tensor:
        return run_route(route, x, self._group, op, cfg, self.mesh)

    # -- running one collective -------------------------------------------------------

    @staticmethod
    def _wait(outs: Sequence[torch.Tensor], kernels: bool) -> None:
        """Wait for the collective's work on the card: the ring kernels'
        workspaces (raising a kernel's timeout), else the current stream."""
        if kernels:
            peer_memory.check_all()
        for dev in {o.device for o in outs if o.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()

    def _run(self, kind: str, x: torch.Tensor, fn: Callable[[], torch.Tensor],
             op: str = "sum", name: str = "", strategy: Optional[Strategy] = None,
             route: str = "one_shot", cfg=None):
        """fn() as collective `kind` on x: its span, stall watch and stats."""
        from .utils import trace as T

        nbytes = x.numel() * x.element_size()
        tag = self._tag(route, x)
        span_args = None
        if T.enabled():
            # per-collective latency attribution, and the pre-collective
            # arrival stamp (per-rank arrival skew per collective)
            span_args = {
                "kind": kind, "op": op, "impl": self._impl(strategy).name,
                # what moves the bytes in the port: a route of the table
                "collective_impl": tag,
                "strategy": (strategy if strategy is not None else self.strategy).name,
                "bytes": int(nbytes), "dtype": str(x.dtype).replace("torch.", ""),
                "t_arrive": round(T.job_now(), 6),
            }
            if cfg is not None:
                span_args["compression"] = cfg.describe()
        t0 = time.perf_counter()
        with stall_detector(name or kind):
            with T.trace_scope(f"collective:{name or kind}", cat="collective", args=span_args):
                out = fn()
                self._wait([out] if isinstance(out, torch.Tensor) else [],
                           x.is_cuda and route in KERNEL_ROUTES)
        self.stats.record(name or kind, nbytes, time.perf_counter() - t0)
        return out

    # -- public collective API (reference session/{allreduce,allgather,session}.go) ---

    def all_reduce(self, x: torch.Tensor, op: str = "sum", name: str = "",
                   strategy: Optional[Strategy] = None, tree=None, compression=None
                   ) -> torch.Tensor:
        """The reduction of x over the session's ranks, op in sum, min,
        max, mean, prod.  `tree` (father array) selects the implementation
        family for this op only (the reference MonitoredAllReduce's tree
        input, cpu/collective.cpp:105), without touching the session
        default; `compression` (config or registered name) selects the wire
        for this op, else the installed one (`set_compression`)."""
        if op not in C.OPS:
            raise ValueError(f"unknown reduce op {op!r}; one of {C.OPS}")
        if tree is not None:
            from .plan.graph import Graph
            from .plan.strategy import strategy_for_tree

            strategy = strategy_for_tree(Graph.from_forest_array(list(tree)))
        cfg = self.compression if compression is None else self._resolve_compression(compression)
        cfg = self._effective_wire(cfg)
        route = self._all_reduce_route(self._impl(strategy), op, x.dtype, cfg)
        return self._run("all_reduce", x, lambda: self._reduce(route, x, op, cfg), op=op,
                         name=name, strategy=strategy, route=route, cfg=cfg)

    def program_for(self, kind: str = "all_reduce", op: str = "sum",
                    strategy: Optional[Strategy] = None, compression=None, **kw):
        """The compiled program of the JAX Session, for the planner's lint."""
        raise NotImplementedError("Session.program_for serves the planner and kf-lint, not "
                                  "ported yet (ROADMAP A.8)")

    @staticmethod
    def pack_buckets(nbytes_list: Sequence[int], bucket_bytes: int) -> List[List[int]]:
        """Greedy in-order packing of tensor indices into size buckets of
        at most `bucket_bytes` (a tensor larger than the cap gets its own
        bucket).  Order is preserved so bucketed and unbucketed reductions
        see identical per-tensor layouts."""
        buckets: List[List[int]] = []
        cur: List[int] = []
        cur_bytes = 0
        for i, b in enumerate(nbytes_list):
            if cur and cur_bytes + int(b) > bucket_bytes:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += int(b)
        if cur:
            buckets.append(cur)
        return buckets

    def _reduce_bucket(self, xs: Sequence[torch.Tensor], idxs: Sequence[int], op: str,
                       impl: Impl, outs: List) -> bool:
        """Reduce xs[i] for i in idxs into outs[i]: the tensors of the
        ring_kernels route one grouped B5/B6 call a dtype
        (`ring_all_reduce_group`: a launch of each a run of `segment_plan`),
        every other tensor its own route.  True if a kernel route ran."""
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i in idxs:
            route = self._all_reduce_route(impl, op, xs[i].dtype, None)
            if route == "ring_kernels":
                by_dtype.setdefault(xs[i].dtype, []).append(i)
            else:
                outs[i] = self._reduce(route, xs[i], op, None)
        for group in by_dtype.values():
            for i, o in zip(group, RC.ring_all_reduce_group([xs[i] for i in group],
                                                            self._group, op)):
                outs[i] = o
        return bool(by_dtype)

    def group_all_reduce(self, xs: Sequence[torch.Tensor], op: str = "sum", name: str = "",
                         fuse: bool = True, strategy: Optional[Strategy] = None,
                         bucket_bytes: Optional[int] = None) -> List[torch.Tensor]:
        """Reduce a tensor list in one sync window, at full precision (as
        the JAX Session's group reduction).

        fuse=True (default): the whole list at once: under a Pallas
        strategy every f32/bf16 tensor of a dtype goes through one grouped
        B5/B6 call (one launch of each per run of `segment_plan`, never a
        launch per tensor), the rest each through its route.  bucket_bytes
        (with fuse=True): pack the list into size buckets (pack_buckets)
        and reduce bucket by bucket, as the JAX Session dispatches one
        program a bucket.  fuse=False: each tensor its own all_reduce
        route.  One wait at the end either way."""
        from .utils import trace as T

        xs = list(xs)
        t0 = time.perf_counter()
        gname = name or "group_all_reduce"
        impl = self._impl(strategy)
        span = T.trace_scope(
            f"collective:{gname}", cat="collective",
            args={"kind": "group_all_reduce", "op": op, "impl": impl.name,
                  "collective_impl": sorted({self._tag(self._all_reduce_route(
                      impl, op, x.dtype, None), x) for x in xs}),
                  "tensors": len(xs), "fuse": bool(fuse),
                  "t_arrive": round(T.job_now(), 6)} if T.enabled() else None,
        )
        outs: List[Optional[torch.Tensor]] = [None] * len(xs)
        kernels = False
        with stall_detector(gname), span:
            if fuse and len(xs) > 1:
                groups = (self.pack_buckets([x.numel() * x.element_size() for x in xs],
                                            int(bucket_bytes))
                          if bucket_bytes else [list(range(len(xs)))])
                for idxs in groups:
                    kernels |= self._reduce_bucket(xs, idxs, op, impl, outs)
            else:
                for i, x in enumerate(xs):
                    route = self._all_reduce_route(impl, op, x.dtype, None)
                    kernels |= route in KERNEL_ROUTES
                    outs[i] = self._reduce(route, x, op, None)
            self._wait(outs, kernels and any(x.is_cuda for x in xs))
        total = sum(x.numel() * x.element_size() for x in xs)
        self.stats.record(gname, total, time.perf_counter() - t0)
        return outs

    def reduce(self, x: torch.Tensor, root: int = 0, op: str = "sum", name: str = ""):
        """The reduction on rank `root`, zeros on the others."""
        return self._run("reduce", x, lambda: C.reduce(x, self._group, root, op), op=op,
                         name=name)

    def broadcast(self, x: torch.Tensor, root: int = 0, name: str = ""):
        """Rank `root`'s tensor on every rank (plus zero, as the JAX mask and
        sum: a root's -0.0 arrives as +0.0; ops/collective.broadcast)."""
        return self._run("broadcast", x, lambda: C.broadcast(x, self._group, root), name=name)

    def all_gather(self, x: torch.Tensor, name: str = ""):
        """Every rank's x stacked in rank order: (n, *x.shape)."""
        return self._run("all_gather", x, lambda: C.all_gather(x, self._group), name=name)

    def gather(self, x: torch.Tensor, root: int = 0, name: str = ""):
        """Gather-to-root (reference session/session.go:185-207): on the
        root every rank's value stacked on a new dim; zeros on the others."""
        return self._run("gather", x, lambda: C.gather(x, self._group, root), name=name)

    def cross_all_reduce(self, x: torch.Tensor, op: str = "sum", name: str = ""):
        """Cross-host-only all-reduce (reference session/allreduce.go:38).

        Needs the hierarchical ici x dcn mesh.  On a single-host session
        it is the identity, as in the reference where a 1-host cluster has
        no cross graph; a multi-host session on a flat mesh is an error,
        since skipping the cross reduction would change semantics."""
        if self._hierarchical_axes is None:
            if self.host_count > 1:
                raise ValueError(
                    f"cross_all_reduce needs an ici×dcn mesh, but this session spans "
                    f"{self.host_count} hosts on a flat mesh {self._axes}; build it with "
                    "make_hierarchical_mesh")
            return x
        return self._run("cross_all_reduce", x,
                         lambda: C.cross_all_reduce(x, self.mesh.group("dcn"), op), op=op,
                         name=name)

    def barrier(self) -> None:
        x = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._run("barrier", x, lambda: C.barrier(self._group, self.device), name="barrier")

    def consensus(self, x: torch.Tensor, name: str = "") -> bool:
        """True iff every rank holds identical values (session/session.go:120-151)."""
        return bool(self._run("consensus", x, lambda: C.consensus(x, self._group),
                              name=name or "consensus"))

    # -- monitoring (reference session/monitoring.go, adaptiveStrategies.go) ----------

    def calc_stats(self) -> Dict[str, float]:
        return {name: self.stats.throughput(name) for name in self.stats.calls}

    def throughput(self) -> float:
        return self.stats.throughput()
