"""Cluster/topology planning layer (the names env.Config needs)."""
from .peer import Cluster, HostList, HostSpec, PeerID, PeerList
from .strategy import DEFAULT_STRATEGY, Strategy

__all__ = ["Cluster", "HostList", "HostSpec", "PeerID", "PeerList", "Strategy",
           "DEFAULT_STRATEGY"]
