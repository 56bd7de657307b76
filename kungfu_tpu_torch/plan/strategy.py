"""Collective strategy names (counterpart of kungfu_tpu.plan.strategy).

Only the names and their parsing, so `env.Config` reads
KFT_ALLREDUCE_STRATEGY as the JAX package does.  The graph builders and
the strategy-to-implementation table wait for the Session port; the
gradient all-reduce of this package is chosen by `impl` in
`optimizers.sync`.
"""
from __future__ import annotations

import enum


class Strategy(enum.Enum):
    STAR = "STAR"
    MULTI_STAR = "MULTI_STAR"
    RING = "RING"
    CLIQUE = "CLIQUE"
    TREE = "TREE"
    BINARY_TREE = "BINARY_TREE"
    BINARY_TREE_STAR = "BINARY_TREE_STAR"
    MULTI_BINARY_TREE_STAR = "MULTI_BINARY_TREE_STAR"
    PALLAS_RING = "PALLAS_RING"
    PALLAS_RING_FUSED = "PALLAS_RING_FUSED"
    PALLAS_FUSED_MATMUL = "PALLAS_FUSED_MATMUL"
    AUTO = "AUTO"

    @classmethod
    def parse(cls, s: str) -> "Strategy":
        try:
            return cls[s.upper().replace("-", "_")]
        except KeyError:
            raise ValueError(f"unknown strategy {s!r}; one of {[m.name for m in cls]}")


DEFAULT_STRATEGY = Strategy.BINARY_TREE_STAR
