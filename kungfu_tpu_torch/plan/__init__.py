"""Cluster/topology planning layer (counterpart of kungfu_tpu.plan;
reference: srcs/go/plan)."""
from .peer import (
    PeerID,
    PeerList,
    HostSpec,
    HostList,
    Cluster,
    DEFAULT_RUNNER_PORT,
    DEFAULT_WORKER_PORT_BASE,
)
from .graph import (
    Graph,
    gen_tree,
    gen_binary_tree,
    gen_star_bcast_graph,
    gen_binary_tree_star,
    gen_multi_binary_tree_star,
    gen_circular_graph_pair,
    gen_default_reduce_graph,
    minimum_spanning_tree,
    neighbour_mask,
    mst_neighbour_mask,
    RoundRobinSelector,
)
from .strategy import (Strategy, Impl, DEFAULT_STRATEGY, PALLAS_IMPLS,
                       resolve_auto, impl_of, strategy_graphs)
from .mesh import (
    DATA_AXES,
    Mesh,
    MeshSpec,
    make_mesh,
    make_hierarchical_mesh,
    mesh_digest,
    AXIS_ORDER,
)

__all__ = [
    "PeerID", "PeerList", "HostSpec", "HostList", "Cluster",
    "DEFAULT_RUNNER_PORT", "DEFAULT_WORKER_PORT_BASE",
    "Graph", "gen_tree", "gen_binary_tree", "gen_star_bcast_graph",
    "gen_binary_tree_star", "gen_multi_binary_tree_star",
    "gen_circular_graph_pair", "gen_default_reduce_graph", "minimum_spanning_tree",
    "neighbour_mask", "mst_neighbour_mask", "RoundRobinSelector",
    "Strategy", "Impl", "DEFAULT_STRATEGY", "resolve_auto", "impl_of", "strategy_graphs",
    "Mesh", "MeshSpec", "make_mesh", "make_hierarchical_mesh", "mesh_digest",
    "AXIS_ORDER", "DATA_AXES",
]
