"""The port's topology planner (plan/graph.py, plan/strategy.py,
plan/mesh.py) against the JAX package's, the cases of
tests/unit/test_plan.py over n = 1-9 ranks and several host layouts.

Every generator's graphs equal the JAX one's node for node (self-loops,
nexts, prevs) and by digest; `strategy_graphs`, `strategy_for_tree`,
`impl_of`, `resolve_auto`, `minimum_spanning_tree`, the neighbour masks
and `RoundRobinSelector` answer as the JAX ones do on the same inputs;
both refuse the same degenerate groupings with the same reasons.
"""
from __future__ import annotations

import numpy as np
import pytest

from _torch_reference import jax_reference
from kungfu_tpu_torch import plan
from kungfu_tpu_torch.plan import graph as G
from kungfu_tpu_torch.plan import strategy as S

NS = range(1, 10)
HOSTS = [
    [[0]],
    [[0, 1, 2]],
    [[0, 1], [2, 3]],
    [[0, 1, 2, 3], [4, 5, 6, 7]],
    [[0, 1], [2, 3], [4, 5]],
    [[0], [1, 2], [3, 4, 5]],
    [[0, 1, 2, 3, 4, 5, 6, 7, 8]],
    [[0], [1], [2], [3], [4], [5], [6]],
]
BAD_HOSTS = [[[0, 1], [1, 2]], [[0, 2]], [[1, 2, 3]], [[0, 1], [], [2, 9]]]


@pytest.fixture(scope="module")
def jp():
    with jax_reference():
        from kungfu_tpu import plan as jplan
        from kungfu_tpu.plan import graph as jgraph
        from kungfu_tpu.plan import strategy as jstrategy

        yield jplan, jgraph, jstrategy


def _shape(g):
    return ([(nd.rank, nd.self_loop, list(nd.nexts), list(nd.prevs)) for nd in g.nodes],
            g.digest_bytes())


def _same(a, b):
    assert _shape(a) == _shape(b)


def _pairs_shape(pairs):
    return [(_shape(r), _shape(b)) for r, b in pairs]


@pytest.mark.parametrize("n", NS)
def test_trees_match_jax(jp, n):
    jg = jp[1]
    _same(G.gen_tree(n), jg.gen_tree(n))
    _same(G.gen_binary_tree(n), jg.gen_binary_tree(n))
    for root in range(n):
        _same(G.gen_star_bcast_graph(n, root), jg.gen_star_bcast_graph(n, root))
    b = G.gen_binary_tree(n)
    _same(G.gen_default_reduce_graph(b), jg.gen_default_reduce_graph(jg.gen_binary_tree(n)))
    assert G.gen_tree(n).to_forest_array() == jg.gen_tree(n).to_forest_array()
    assert G.gen_binary_tree(n).is_valid_tree(root=0)


@pytest.mark.parametrize("n", NS)
def test_rings_and_cliques_match_jax(jp, n):
    jg = jp[1]
    for shift in range(n):
        assert (_pairs_shape([G.gen_circular_graph_pair(n, shift)])
                == _pairs_shape([jg.gen_circular_graph_pair(n, shift)]))
    assert _pairs_shape(G.gen_clique_graph_pairs(n)) == _pairs_shape(jg.gen_clique_graph_pairs(n))


@pytest.mark.parametrize("hosts", HOSTS, ids=str)
def test_tree_stars_match_jax(jp, hosts):
    jg = jp[1]
    _same(G.gen_binary_tree_star(hosts), jg.gen_binary_tree_star(hosts))
    ours, theirs = G.gen_multi_binary_tree_star(hosts), jg.gen_multi_binary_tree_star(hosts)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        _same(a, b)


@pytest.mark.parametrize("hosts", HOSTS, ids=str)
def test_strategy_graphs_match_jax(jp, hosts):
    jplan = jp[0]
    n = sum(len(h) for h in hosts)
    for s in S.Strategy:
        ours = S.strategy_graphs(s, hosts)
        theirs = jplan.strategy_graphs(jplan.Strategy[s.name], hosts)
        assert _pairs_shape(ours) == _pairs_shape(theirs), s
        for rg, bg in ours:
            assert len(rg) == n and len(bg) == n


@pytest.mark.parametrize("hosts", BAD_HOSTS, ids=str)
def test_degenerate_groupings_refused_alike(jp, hosts):
    with pytest.raises(ValueError) as ours:
        G.gen_binary_tree_star(hosts)
    with pytest.raises(ValueError) as theirs:
        jp[1].gen_binary_tree_star(hosts)
    assert str(ours.value) == str(theirs.value)


def _forests(n, rng):
    """Stars at every root, the chain, the heap tree and random forests."""
    out = [[r] * n for r in range(n)]
    out.append([max(i - 1, 0) for i in range(n)])
    out.append([max((i - 1) // 2, 0) for i in range(n)])
    for _ in range(6):
        out.append([0] + [int(rng.integers(0, i)) for i in range(1, n)])
    return out


@pytest.mark.parametrize("n", NS)
def test_forest_arrays_and_strategy_for_tree_match_jax(jp, n):
    jg, js = jp[1], jp[2]
    rng = np.random.default_rng(n)
    for father in _forests(n, rng):
        g, jgr = G.Graph.from_forest_array(father), jg.Graph.from_forest_array(father)
        _same(g, jgr)
        _same(g.reverse(), jgr.reverse())
        assert g.to_forest_array() == jgr.to_forest_array() == father
        assert g.tree_errors() == jgr.tree_errors()
        assert g.reverse().tree_errors() == jgr.reverse().tree_errors()
        assert S.strategy_for_tree(g).name == js.strategy_for_tree(jgr).name
    with pytest.raises(ValueError, match="out of range"):
        G.Graph.from_forest_array([n] * n)


@pytest.mark.parametrize("host_count", [1, 2, 4])
def test_impl_of_and_auto_match_jax(jp, host_count):
    jplan = jp[0]
    for s in S.Strategy:
        js = jplan.Strategy[s.name]
        assert S.impl_of(s, host_count).value == jplan.impl_of(js, host_count).value
        assert S.impl_of(s, host_count).name == jplan.impl_of(js, host_count).name
        assert S.resolve_auto(s, host_count).name == jplan.resolve_auto(js, host_count).name
    assert [i.name for i in S.Impl] == [i.name for i in jplan.Impl]
    assert [i.name for i in S.PALLAS_IMPLS] == [i.name for i in jplan.PALLAS_IMPLS]
    assert S.DEFAULT_STRATEGY.name == jplan.DEFAULT_STRATEGY.name


@pytest.mark.parametrize("n", NS)
def test_minimum_spanning_tree_and_masks_match_jax(jp, n):
    jplan = jp[0]
    rng = np.random.default_rng(100 + n)
    for _ in range(4):
        m = rng.uniform(0.1, 10.0, (n, n))
        lat = ((m + m.T) / 2).tolist()
        father = plan.minimum_spanning_tree(lat)
        assert father == jplan.minimum_spanning_tree(lat)
        assert G.Graph.from_forest_array(father).reverse().tree_errors() == []
        for r in range(n):
            assert plan.mst_neighbour_mask(father, r) == jplan.mst_neighbour_mask(father, r)
    assert plan.minimum_spanning_tree([]) == jplan.minimum_spanning_tree([]) == []


def test_neighbour_mask_and_round_robin_match_jax(jp):
    jplan = jp[0]
    edges = [(0, 1), (1, 2), (2, 3)]
    for r in range(4):
        assert plan.neighbour_mask(edges, r, 4) == jplan.neighbour_mask(edges, r, 4)
    with pytest.raises(ValueError):
        plan.neighbour_mask(edges, 4, 4)
    rng = np.random.default_rng(7)
    ours, theirs = plan.RoundRobinSelector(), jplan.RoundRobinSelector()
    for _ in range(200):
        mask = (rng.random(int(rng.integers(1, 9))) < 0.4).tolist()
        assert ours(mask) == theirs(mask)


def test_strategy_names_and_parse_match_jax(jp):
    jplan = jp[0]
    assert [s.name for s in S.Strategy] == [s.name for s in jplan.Strategy]
    for spelling in ("binary-tree-star", "pallas_ring", "Ring", "AUTO"):
        assert S.Strategy.parse(spelling).name == jplan.Strategy.parse(spelling).name
    with pytest.raises(ValueError):
        S.Strategy.parse("nope")


def test_plan_exports_match_jax(jp):
    """Every name the JAX plan package exports, but its jax shardings."""
    theirs = set(jp[0].__all__) - {"data_sharding", "replicated"}
    assert theirs <= set(plan.__all__)


def test_hierarchical_mesh_on_one_rank():
    mesh = plan.make_hierarchical_mesh(1)
    assert mesh.axis_names == ("dcn", "ici") and mesh.size == 1
    with pytest.raises(ValueError, match="not divisible"):
        plan.make_hierarchical_mesh(2)
    assert plan.mesh_digest(mesh) == plan.mesh_digest(plan.make_hierarchical_mesh(1))
    assert plan.mesh_digest(mesh) != plan.mesh_digest(plan.make_mesh(dp=-1))
