"""Directed communication graphs and topology generators (counterpart of
kungfu_tpu.plan.graph, host code kept as its own copy).

The reference's topology math (srcs/go/plan/graph/graph.go and
srcs/go/plan/topology.go).  The port's collectives route their bytes by
the Session's route table (`session.py`), not by these graphs; the graphs
still matter for:

  - the strategy abstraction (`plan.strategy.strategy_graphs`: which
    reduce/broadcast graphs a strategy stands for, and their digests),
  - the runtime topology swap (`Session.set_tree`: an installed tree
    selects the nearest implementation family, `strategy_for_tree`),
  - the minimum spanning tree from measured latencies (include/kungfu/mst.hpp)
    and the neighbour masks gossip cycles through,
  - the permutation checks of the pair exchanges: a rank that receives
    twice, or sends twice, leaves a peer waiting forever on the card.

A graph pairs with its reverse: reduce along G, broadcast along reverse(G)
(reference GenDefaultReduceGraph, topology.go:33-40).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class Node:
    rank: int
    self_loop: bool = False
    nexts: List[int] = field(default_factory=list)
    prevs: List[int] = field(default_factory=list)


class Graph:
    """Digraph over ranks 0..n-1 with optional self-loops.

    Self-loops mark aggregation roots in reduce graphs (reference
    graph/graph.go:29-60).
    """

    def __init__(self, n: int):
        self.nodes = [Node(i) for i in range(n)]

    def __len__(self) -> int:
        return len(self.nodes)

    def add_edge(self, i: int, j: int) -> None:
        if i == j:
            self.nodes[i].self_loop = True
            return
        self.nodes[i].nexts.append(j)
        self.nodes[j].prevs.append(i)

    def nexts(self, i: int) -> List[int]:
        return list(self.nodes[i].nexts)

    def prevs(self, i: int) -> List[int]:
        return list(self.nodes[i].prevs)

    def is_self_loop(self, i: int) -> bool:
        return self.nodes[i].self_loop

    def reverse(self) -> "Graph":
        g = Graph(len(self))
        for nd in self.nodes:
            if nd.self_loop:
                g.nodes[nd.rank].self_loop = True
            for j in nd.nexts:
                g.add_edge(j, nd.rank)
        return g

    @classmethod
    def from_forest_array(cls, father: Sequence[int]) -> "Graph":
        """Father-array encoding: father[i] == i marks a root (self-loop).

        Reference FromForestArray (graph/graph.go:96-126); used by the
        `set_tree` runtime-topology-swap op.
        """
        n = len(father)
        g = cls(n)
        for i, f in enumerate(father):
            if not (0 <= f < n):
                raise ValueError(f"father[{i}]={f} out of range")
            if f == i:
                g.nodes[i].self_loop = True
            else:
                # edges point root-ward in the reduce graph: child -> father
                g.add_edge(i, f)
        return g

    def to_forest_array(self) -> List[int]:
        out = []
        for nd in self.nodes:
            if nd.nexts:
                out.append(nd.nexts[0])
            else:
                out.append(nd.rank)
        return out

    def digest_bytes(self) -> bytes:
        """Deterministic encoding for consensus (graph/graph.go:137-146)."""
        parts = []
        for nd in self.nodes:
            parts.append(f"{nd.rank}:{int(nd.self_loop)}:{','.join(map(str, sorted(nd.nexts)))}")
        return hashlib.sha256("|".join(parts).encode()).digest()

    def edges(self) -> List[Tuple[int, int]]:
        return [(nd.rank, j) for nd in self.nodes for j in nd.nexts]

    def is_valid_tree(self, root: Optional[int] = None) -> bool:
        """Broadcast-tree invariant: every non-root has exactly one prev."""
        return not self.tree_errors(root)

    def tree_errors(self, root: Optional[int] = None) -> List[str]:
        """Why this graph is not a valid broadcast tree ([] when it is).

        The same oracle `is_valid_tree` answers as a bool, but with the
        offending structure named.
        """
        problems: List[str] = []
        roots = [nd.rank for nd in self.nodes if nd.self_loop]
        if root is not None and roots != [root]:
            problems.append(f"expected single root {root}, found roots {roots}")
            return problems
        if len(roots) != 1:
            problems.append(f"expected exactly one root, found {roots}")
            return problems
        r = roots[0]
        seen = {r}
        frontier = [r]
        while frontier:
            nxt = []
            for i in frontier:
                for j in self.nodes[i].nexts:
                    if j in seen:
                        problems.append(
                            f"rank {j} is reached twice (edge {i}->{j} "
                            "re-enters the tree)"
                        )
                        return problems
                    seen.add(j)
                    nxt.append(j)
            frontier = nxt
        if len(seen) != len(self):
            missing = sorted(set(range(len(self))) - seen)
            problems.append(f"ranks {missing} are unreachable from root {r}")
        return problems


# --- permutation validation ----------------------------------------------------------


def permutation_errors(
    pairs: Sequence[Tuple[int, int]], n: int
) -> List[str]:
    """Why `pairs` is not a valid ppermute permutation over `n` ranks.

    Returns [] when every (src, dst) is in range and no rank sends or
    receives twice (a duplicate destination double-writes one rank's buffer
    while another waits forever).  Partial permutations (ranks not covered)
    are legal: an uncovered receiver receives nothing, so it is not
    reported.
    """
    problems: List[str] = []
    srcs: Dict[int, int] = {}
    dsts: Dict[int, int] = {}
    for src, dst in pairs:
        if not (0 <= src < n):
            problems.append(f"source {src} out of range [0, {n})")
        if not (0 <= dst < n):
            problems.append(f"destination {dst} out of range [0, {n})")
        srcs[src] = srcs.get(src, 0) + 1
        dsts[dst] = dsts.get(dst, 0) + 1
    for r, k in sorted(srcs.items()):
        if k > 1:
            problems.append(f"rank {r} appears as source {k} times")
    for r, k in sorted(dsts.items()):
        if k > 1:
            problems.append(f"rank {r} appears as destination {k} times")
    return problems


def validate_permutation(
    pairs: Sequence[Tuple[int, int]], n: int, what: str = "ppermute"
) -> None:
    """Raise ValueError unless `pairs` is a valid permutation over n ranks."""
    problems = permutation_errors(pairs, n)
    if problems:
        raise ValueError(
            f"invalid {what} permutation over {n} ranks: "
            + "; ".join(problems)
        )


# --- generators (reference srcs/go/plan/topology.go) ---------------------------------
#
# Every generator validates its own output on construction (is_valid_tree /
# permutation_errors) and raises with the offending edge list instead of
# letting a bad graph reach a collective: a disconnected tree silently drops
# ranks.  The known trap: tree-star over a degenerate host grouping (an
# empty host entry, duplicate or out-of-range ranks).


def _checked_tree(g: Graph, what: str, root: Optional[int] = None) -> Graph:
    problems = g.tree_errors(root)
    if problems:
        raise ValueError(
            f"{what} generated an invalid broadcast tree: "
            + "; ".join(problems) + f"; edges={g.edges()}"
        )
    return g


def _check_positive(n: int, what: str) -> None:
    if n < 1:
        raise ValueError(f"{what} needs at least one rank, got n={n}")


def gen_tree(n: int) -> Graph:
    """Flat star rooted at 0 (topology.go:17-31): bcast graph 0 -> all."""
    _check_positive(n, "gen_tree")
    g = Graph(n)
    g.add_edge(0, 0)
    for i in range(1, n):
        g.add_edge(0, i)
    return _checked_tree(g, "gen_tree", root=0)


def gen_star_bcast_graph(n: int, root: int = 0) -> Graph:
    """Star rooted at `root` (topology.go:138-147)."""
    _check_positive(n, "gen_star_bcast_graph")
    if not (0 <= root < n):
        raise ValueError(f"gen_star_bcast_graph root {root} not in [0, {n})")
    g = Graph(n)
    g.add_edge(root, root)
    for i in range(n):
        if i != root:
            g.add_edge(root, i)
    return _checked_tree(g, "gen_star_bcast_graph", root=root)


def gen_binary_tree(n: int) -> Graph:
    """Binary bcast tree rooted at 0 with heap-index children (topology.go:42-56)."""
    _check_positive(n, "gen_binary_tree")
    g = Graph(n)
    g.add_edge(0, 0)
    for i in range(n):
        l, r = 2 * i + 1, 2 * i + 2
        if l < n:
            g.add_edge(i, l)
        if r < n:
            g.add_edge(i, r)
    return _checked_tree(g, "gen_binary_tree", root=0)


def gen_default_reduce_graph(bcast: Graph) -> Graph:
    """Reverse the bcast tree and add self-loops everywhere (topology.go:33-40)."""
    g = bcast.reverse()
    for nd in g.nodes:
        nd.self_loop = True
    return g


def gen_binary_tree_star(hosts: Sequence[Sequence[int]]) -> Graph:
    """Star within each host + binary tree across local masters.

    The reference default strategy (topology.go:103-136): rank lists grouped
    by host; each host's first rank is the local master; masters form a
    binary tree (heap order); members hang off their master.
    Returns the broadcast graph.
    """
    n = sum(len(h) for h in hosts)
    _check_positive(n, "gen_binary_tree_star")
    ranks = sorted(x for h in hosts for x in h)
    if ranks != list(range(n)):
        raise ValueError(
            f"gen_binary_tree_star host grouping {list(map(list, hosts))} "
            f"does not cover ranks 0..{n - 1} exactly (a duplicate, missing "
            "or out-of-range rank leaves the tree disconnected)"
        )
    g = Graph(n)
    masters = [h[0] for h in hosts if h]
    g.add_edge(masters[0], masters[0])
    for i, m in enumerate(masters):
        l, r = 2 * i + 1, 2 * i + 2
        if l < len(masters):
            g.add_edge(m, masters[l])
        if r < len(masters):
            g.add_edge(m, masters[r])
    for h in hosts:
        for x in h[1:]:
            g.add_edge(h[0], x)
    return _checked_tree(g, "gen_binary_tree_star", root=masters[0])


def gen_multi_binary_tree_star(hosts: Sequence[Sequence[int]]) -> List[Graph]:
    """k rotated binary-tree-star graphs, one rooted per host (topology.go:107).

    Multi-graph load spreading: chunk i uses graph i%k.
    """
    k = max(1, len([h for h in hosts if h]))
    out = []
    for r in range(k):
        rotated = list(hosts[r:]) + list(hosts[:r])
        out.append(gen_binary_tree_star(rotated))
    return out


def gen_circular_graph_pair(n: int, shift: int = 0) -> Tuple[Graph, Graph]:
    """Ring reduce/bcast pair shifted by `shift` (topology.go:149-177).

    Reduce graph: chain r0 -> r1 -> ... -> r_{n-1} (root at end, self-loops
    everywhere for aggregation); bcast graph: chain from the root back.
    """
    _check_positive(n, "gen_circular_graph_pair")
    order = [(shift + i) % n for i in range(n)]
    reduce_g = Graph(n)
    bcast_g = Graph(n)
    for i in order:
        reduce_g.nodes[i].self_loop = True
    for a, b in zip(order, order[1:]):
        reduce_g.add_edge(a, b)
    root = order[-1]
    bcast_g.add_edge(root, root)
    for a, b in zip(reversed(order), list(reversed(order))[1:]):
        bcast_g.add_edge(a, b)
    # a ring round is a (partial) permutation: validate each chain's send
    # pairs through the same oracle as the pair exchanges
    for g, what in ((reduce_g, "reduce chain"), (bcast_g, "bcast chain")):
        problems = permutation_errors(g.edges(), n)
        if problems:
            raise ValueError(
                f"gen_circular_graph_pair {what} is not a valid "
                f"permutation: {'; '.join(problems)}; edges={g.edges()}"
            )
    return reduce_g, bcast_g


def gen_clique_graph_pairs(n: int) -> List[Tuple[Graph, Graph]]:
    """n star pairs, one rooted at each rank (CLIQUE strategy, strategy.go:145-154)."""
    out = []
    for r in range(n):
        b = gen_star_bcast_graph(n, root=r)
        out.append((gen_default_reduce_graph(b), b))
    return out


def neighbour_mask(
    edges: Sequence[Tuple[int, int]], self_rank: int, size: int
) -> List[bool]:
    """Boolean mask of peers adjacent to `self_rank` in an edge list.

    Reference GetNeighbourMask (srcs/cpp/src/tensorflow/ops/cpu/topology.cpp:
    154-192): given the MST's (size-1, 2) edge list, mark every peer sharing
    an edge with self — the candidate set for topology-aware gossip.
    """
    if not (0 <= self_rank < size):
        raise ValueError(f"self_rank {self_rank} not in [0, {size})")
    mask = [False] * size
    for u, v in edges:
        if u == self_rank:
            mask[v] = True
        if v == self_rank:
            mask[u] = True
    return mask


def mst_neighbour_mask(father: Sequence[int], self_rank: int) -> List[bool]:
    """neighbour_mask for a father-array tree (minimum_spanning_tree output)."""
    edges = [(father[v], v) for v in range(len(father)) if father[v] != v]
    return neighbour_mask(edges, self_rank, len(father))


class RoundRobinSelector:
    """Stateful cyclic chooser over a boolean mask.

    Reference RoundRobin op (cpu/topology.cpp:196-230): each call returns the
    next true index after the previous pick, cycling; -1 if the mask is all
    false.  Host-side state, like the reference's per-kernel `pos_`.
    """

    def __init__(self):
        self._pos = 0

    def __call__(self, mask: Sequence[bool]) -> int:
        n = len(mask)
        for i in range(n):
            idx = (self._pos + i) % n
            if mask[idx]:
                self._pos = (idx + 1) % n
                return idx
        return -1


def minimum_spanning_tree(latency: Sequence[Sequence[float]]) -> List[int]:
    """Prim's MST over a symmetric latency matrix -> father array.

    Reference include/kungfu/mst.hpp:10-59 (used by the MinimumSpanningTree
    op to derive a latency-optimal broadcast tree at runtime).
    """
    n = len(latency)
    if n == 0:
        return []
    father = [0] * n
    in_tree = [False] * n
    best = [float("inf")] * n
    best[0] = 0.0
    father[0] = 0
    for _ in range(n):
        u = min((i for i in range(n) if not in_tree[i]), key=lambda i: best[i])
        in_tree[u] = True
        for v in range(n):
            if not in_tree[v] and latency[u][v] < best[v]:
                best[v] = latency[u][v]
                father[v] = u
    return father
