"""Ranked-LCA vote over candidate lists, plain PyTorch.

Counterpart of metacache_tpu/ops/classify_op.py::classify_lca
(classify(), src/classification.cpp:235-265): unclassified if there is no
candidate or the top candidate has fewer than hitsMin hits; threshold =
(hits0 - hitsMin) * hitsDiffFraction in float32 if hits0 > hitsMin, else
0; candidates 2..C fold into a ranked LCA while their hits exceed the
threshold; unclassified if the LCA lies above highestRank. The LCA of two
consistent ranked lineages is their elementwise intersection.
"""
from __future__ import annotations

import numpy as np
import torch


def classify_lca(cand_tax: torch.Tensor, cand_hits: torch.Tensor,
                 ranked_lineage: torch.Tensor, hits_min: int,
                 hits_diff_fraction: float, highest_rank: int):
    """cand_tax/cand_hits [B, C] (tax 0 = empty, hits descending),
    ranked_lineage [N, R] (row 0 all zeros) -> (best_node, best_rank) [B]
    int64; best_node 0 = unclassified, then best_rank == R."""
    B, C = cand_tax.shape
    R = ranked_lineage.shape[1]
    dev = cand_tax.device
    hits0 = cand_hits[:, 0]
    classifiable = (cand_tax[:, 0] > 0) & (hits0 >= hits_min)
    # a float32 product, as in JAX: a float32 fraction times a float32
    # count is exact in any wider type, so it rounds the same everywhere
    diff = float(np.float32(hits_diff_fraction))
    thr = torch.where(hits0 > hits_min,
                      (hits0 - hits_min).to(torch.float32) * diff, 0.0)

    lin = ranked_lineage[cand_tax[:, 0]]
    include = torch.ones(B, dtype=torch.bool, device=dev)
    for i in range(1, C):
        include = include & (cand_hits[:, i].to(torch.float32) > thr) \
            & (cand_tax[:, i] > 0)
        lin_i = ranked_lineage[cand_tax[:, i]]
        lin = torch.where(include[:, None] & (lin != lin_i), 0, lin)

    ranks = torch.arange(R, device=dev)
    first = torch.where(lin != 0, ranks, R).min(dim=1).values
    best = lin.gather(1, first.clamp(max=R - 1)[:, None])[:, 0]
    ok = classifiable & (first < R) & (first <= highest_rank)
    return torch.where(ok, best, 0), torch.where(ok, first, R)
