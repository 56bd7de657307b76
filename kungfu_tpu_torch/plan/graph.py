"""Permutation checks of the pair exchanges (counterpart of the
permutation half of kungfu_tpu.plan.graph).

A pairing is a list of (src, dst) ranks: src sends, dst receives.  The
gossip pull and the compressed pair exchanges validate every pairing
before a rank sends anything: a rank that receives twice, or sends twice,
leaves a peer waiting forever on the card.  The graph generators and the
broadcast trees of the JAX module come with the rest of `plan/` (ROADMAP
A.4).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def permutation_errors(pairs: Sequence[Tuple[int, int]], n: int) -> List[str]:
    """Why `pairs` is not a valid permutation over `n` ranks.

    Returns [] when every (src, dst) is in range and no rank sends or
    receives twice.  Partial permutations (ranks not covered) are legal:
    an uncovered receiver receives nothing, so it is not reported."""
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


def validate_permutation(pairs: Sequence[Tuple[int, int]], n: int,
                         what: str = "ppermute") -> None:
    """Raise ValueError unless `pairs` is a valid permutation over n ranks."""
    problems = permutation_errors(pairs, n)
    if problems:
        raise ValueError(f"invalid {what} permutation over {n} ranks: " + "; ".join(problems))
