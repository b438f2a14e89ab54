"""Abundance estimation with proportional redistribution.

Transcribed semantics of estimate_abundance (src/classification.cpp:362-428)
over the ordered taxon-count map (ordered by rank descending then taxid
ascending — sortTaxaByRank, src/classification.h:107-115):

  1. every taxon below the estimation rank folds its count into its closest
     ancestor at/above that rank (if one exists)
  2. counts of inner nodes are redistributed proportionally onto their
     children (weights = subtree counts), leaving only leaves
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..db.taxonomy import Rank, Taxonomy


def _order_key(tax: Taxonomy, node: int):
    # map order: rank descending (root first), then taxid ascending
    return (-int(tax.rank[node]), int(tax.taxid[node]))


def sorted_counts(tax: Taxonomy, counts: Dict[int, float]
                  ) -> List[Tuple[int, float]]:
    return sorted(counts.items(), key=lambda kv: _order_key(tax, kv[0]))


def estimate_abundance(tax: Taxonomy, counts: Dict[int, float],
                       est_rank: int) -> Dict[int, float]:
    """Returns a new node->count dict (leaves only)."""
    counts = dict(counts)
    lineage = tax.ranked_lineage

    if est_rank != Rank.SEQUENCE:
        # prune taxa below the estimation rank (classification.cpp:364-380)
        below = [n for n in list(counts)
                 if int(tax.rank[n]) <= est_rank - 1]
        for n in sorted(below, key=lambda n: _order_key(tax, n)):
            anc = 0
            for idx in range(est_rank, Rank.NUM_RANKS):
                if lineage[n, idx]:
                    anc = int(lineage[n, idx])
                    break
            if anc:
                counts[anc] = counts.get(anc, 0.0) + counts.pop(n)

    # weights: subtree counts propagated to the closest present ancestor
    # (classification.cpp:382-408, traversal leaves -> root)
    weights = {n: 0.0 for n in counts}
    children: Dict[int, List[int]] = {}
    for n in sorted(counts, key=lambda n: _order_key(tax, n), reverse=True):
        idx = int(tax.rank[n]) + 1
        while idx < Rank.NUM_RANKS:
            parent = int(lineage[n, idx])
            idx += 1
            if parent and parent in weights and parent != n:
                weights[parent] += weights[n] + counts[n]
                children.setdefault(parent, []).append(n)
                break

    # redistribute inner-node counts onto children proportionally
    # (classification.cpp:410-427, traversal root -> leaves)
    for n in sorted(counts, key=lambda n: _order_key(tax, n)):
        if n not in counts:
            continue
        ch = children.get(n)
        if ch:
            sum_children = weights[n]
            cnt = counts.pop(n)
            for c in ch:
                if sum_children > 0:
                    counts[c] += cnt * (counts[c] + weights[c]) / sum_children
    return counts
