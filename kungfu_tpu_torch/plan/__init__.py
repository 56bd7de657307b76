"""Cluster/topology planning layer: the names env.Config needs, and the rank mesh."""
from .mesh import AXIS_ORDER, DATA_AXES, Mesh, MeshSpec, make_mesh
from .peer import Cluster, HostList, HostSpec, PeerID, PeerList
from .strategy import DEFAULT_STRATEGY, Strategy

__all__ = ["Cluster", "HostList", "HostSpec", "PeerID", "PeerList", "Strategy",
           "DEFAULT_STRATEGY", "AXIS_ORDER", "DATA_AXES", "Mesh", "MeshSpec", "make_mesh"]
