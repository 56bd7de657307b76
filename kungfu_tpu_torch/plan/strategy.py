"""Collective strategies: runtime-selectable all-reduce implementations
(counterpart of kungfu_tpu.plan.strategy).

The reference enumerates message-routing topologies executed by its Go
engine (srcs/go/kungfu/base/strategy.go:10-23, graphs built in
srcs/go/kungfu/session/strategy.go:90-210).  As in the JAX package a
strategy names an implementation (`Impl`, the same members); the Session's
route table (`session.py`) says what runs each one here:

  STAR / TREE / BINARY_TREE       -> PSUM: one torch.distributed all_reduce
  RING                            -> RING: the explicit chunked ring over
                                     point-to-point (ops/collective.py)
  CLIQUE / MULTI_STAR             -> RS_AG: reduce-scatter + all-gather
  BINARY_TREE_STAR / MULTI_BINARY_TREE_STAR
                                  -> HIERARCHICAL: ici reduce-scatter, dcn
                                     all-reduce, ici all-gather over a
                                     (dcn, ici) mesh (plan.make_hierarchical_mesh)
  PALLAS_RING / PALLAS_FUSED_MATMUL
                                  -> the hand-written ring kernels B5 + B6
                                     (ops/ring_collectives.py)
  PALLAS_RING_FUSED               -> with an int8/fp8 wire, the fused-codec
                                     kernels B7 + B8
  AUTO                            -> one host: STAR; several: BINARY_TREE_STAR
                                     (reference strategy.go:165-174)

The Pallas names are kept so that each finds its counterpart in the JAX
package.  Strategies are swappable between collectives (`Session.set_strategy`,
the analog of `SetGlobalStrategy`, session/adaptation.go:8-20).
"""
from __future__ import annotations

import enum
from typing import List, Sequence, Tuple

from . import graph as G


class Strategy(enum.Enum):
    STAR = "STAR"
    MULTI_STAR = "MULTI_STAR"
    RING = "RING"
    CLIQUE = "CLIQUE"
    TREE = "TREE"
    BINARY_TREE = "BINARY_TREE"
    BINARY_TREE_STAR = "BINARY_TREE_STAR"  # reference default
    MULTI_BINARY_TREE_STAR = "MULTI_BINARY_TREE_STAR"
    PALLAS_RING = "PALLAS_RING"  # the ring kernels B5/B6
    PALLAS_RING_FUSED = "PALLAS_RING_FUSED"  # B7/B8: the int8/fp8 codec in the kernels
    # the fused computation-collective schedule (ops/fused_matmul.py); as a
    # session all-reduce it runs the ring kernels' pair, B5 then B6
    PALLAS_FUSED_MATMUL = "PALLAS_FUSED_MATMUL"
    AUTO = "AUTO"

    @classmethod
    def parse(cls, s: str) -> "Strategy":
        try:
            return cls[s.upper().replace("-", "_")]
        except KeyError:
            raise ValueError(f"unknown strategy {s!r}; one of {[m.name for m in cls]}")


DEFAULT_STRATEGY = Strategy.BINARY_TREE_STAR


def resolve_auto(strategy: Strategy, host_count: int) -> Strategy:
    """AUTO -> STAR on one host else BINARY_TREE_STAR (strategy.go:165-174)."""
    if strategy is not Strategy.AUTO:
        return strategy
    return Strategy.STAR if host_count <= 1 else Strategy.BINARY_TREE_STAR


class Impl(enum.Enum):
    """The implementation each strategy selects (the JAX package's members
    and values; `session.py`'s route table says what runs each here)."""

    PSUM = "psum"                    # one-shot all-reduce
    RS_AG = "reduce_scatter_all_gather"  # phased, bandwidth-optimal
    RING = "ring_ppermute"           # explicit ring, chunked
    HIERARCHICAL = "hierarchical"    # per-host then cross-host (ici x dcn)
    PALLAS_RING = "pallas_ring"      # the ring kernels B5/B6
    PALLAS_RING_FUSED = "pallas_ring_fused"  # + the codec in B7/B8
    PALLAS_FUSED_MATMUL = "pallas_fused_matmul"  # as an all-reduce: B5/B6


_IMPL_OF = {
    Strategy.STAR: Impl.PSUM,
    Strategy.TREE: Impl.PSUM,
    Strategy.BINARY_TREE: Impl.PSUM,
    Strategy.MULTI_STAR: Impl.RS_AG,
    Strategy.CLIQUE: Impl.RS_AG,
    Strategy.RING: Impl.RING,
    Strategy.BINARY_TREE_STAR: Impl.HIERARCHICAL,
    Strategy.MULTI_BINARY_TREE_STAR: Impl.HIERARCHICAL,
    Strategy.PALLAS_RING: Impl.PALLAS_RING,
    Strategy.PALLAS_RING_FUSED: Impl.PALLAS_RING_FUSED,
    Strategy.PALLAS_FUSED_MATMUL: Impl.PALLAS_FUSED_MATMUL,
}

#: the Impl family whose f32/bf16 sums and means run the ring kernels
PALLAS_IMPLS = (Impl.PALLAS_RING, Impl.PALLAS_RING_FUSED,
                Impl.PALLAS_FUSED_MATMUL)


def impl_of(strategy: Strategy, host_count: int = 1) -> Impl:
    s = resolve_auto(strategy, host_count)
    impl = _IMPL_OF[s]
    # hierarchical degenerates to flat psum on a single host
    if impl is Impl.HIERARCHICAL and host_count <= 1:
        return Impl.PSUM
    return impl


def strategy_graphs(
    strategy: Strategy, hosts: Sequence[Sequence[int]]
) -> List[Tuple[G.Graph, G.Graph]]:
    """(reduceGraph, bcastGraph) pairs for a strategy: parity with the
    reference graph builders (session/strategy.go:90-163), for digests and
    tests; the port's bytes follow the Session's route table."""
    n = sum(len(h) for h in hosts)
    s = resolve_auto(strategy, len([h for h in hosts if h]))
    if s in (Strategy.STAR, Strategy.TREE):
        b = G.gen_tree(n)
        return [(G.gen_default_reduce_graph(b), b)]
    if s is Strategy.BINARY_TREE:
        b = G.gen_binary_tree(n)
        return [(G.gen_default_reduce_graph(b), b)]
    if s is Strategy.BINARY_TREE_STAR:
        b = G.gen_binary_tree_star(hosts)
        return [(G.gen_default_reduce_graph(b), b)]
    if s is Strategy.MULTI_BINARY_TREE_STAR:
        return [
            (G.gen_default_reduce_graph(b), b)
            for b in G.gen_multi_binary_tree_star(hosts)
        ]
    if s is Strategy.MULTI_STAR:
        return [
            (G.gen_default_reduce_graph(G.gen_star_bcast_graph(n, r)), G.gen_star_bcast_graph(n, r))
            for r in range(min(n, len(hosts)))
        ]
    if s is Strategy.CLIQUE:
        return G.gen_clique_graph_pairs(n)
    if s in (Strategy.RING, Strategy.PALLAS_RING, Strategy.PALLAS_RING_FUSED,
             Strategy.PALLAS_FUSED_MATMUL):
        # the ring kernels run exactly the circular-pair routing, so they
        # share RING's reference graphs
        return [G.gen_circular_graph_pair(n, shift=k) for k in range(min(n, 4))]
    raise ValueError(f"unhandled strategy {s}")


def strategy_for_tree(g: "G.Graph") -> Strategy:
    """Map an explicit bcast tree onto the nearest strategy.

    The reference installs arbitrary reduce/bcast graphs at runtime
    (SetTree, session/adaptation.go:22-28); here, as in the JAX package, an
    installed tree selects the implementation family its shape implies: a
    star -> one-shot PSUM, a chain -> RING, a bounded-fanout tree -> phased
    RS_AG.
    """
    n = len(g)
    if n <= 1:
        return Strategy.STAR
    roots = [i for i in range(n) if g.is_self_loop(i)]
    root = roots[0] if roots else 0
    # the forest array encodes the reduce orientation (child -> father), so a
    # node's children are its `prevs`; classify by broadcast fanout
    children = {i: [j for j in g.prevs(i) if j != i] for i in range(n)}
    if len(children[root]) == n - 1:
        return Strategy.STAR
    if all(len(c) <= 1 for c in children.values()):
        return Strategy.RING
    return Strategy.CLIQUE  # phased reduce_scatter+all_gather
