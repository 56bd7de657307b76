"""Cluster/topology planning layer (the names env.Config needs)."""
from .peer import Cluster, PeerID, PeerList
from .strategy import DEFAULT_STRATEGY, Strategy

__all__ = ["Cluster", "PeerID", "PeerList", "Strategy", "DEFAULT_STRATEGY"]
