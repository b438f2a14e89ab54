"""Row-limited table gather, plain PyTorch: the plain version of the CUDA
gather kernel (csrc/gather.cu, wrapper ops/gather_cuda.py).

Counterpart of the Pallas gather probes k1 / k2 of
tools/exp_pallas_gather.py (out = table[idx]) and of the lookup's CSR
location fetch `loc_packed[li]` (metacache_tpu/ops/lookup.py:356).
"""
from __future__ import annotations

import torch


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor,
                          n_valid: torch.Tensor, pad: int) -> torch.Tensor:
    """out[b, j] = table[idx[b, j]] if j < n_valid[b] else pad.

    table [N], idx [B, L] int64, n_valid [B] -> [B, L] of table's dtype.
    Indices of slots at or past n_valid[b] are never read. With every row
    full (n_valid == L) this is k1's function, table[idx]."""
    L = idx.shape[1]
    valid = torch.arange(L, device=idx.device)[None, :] < n_valid[:, None]
    return torch.where(valid, table[torch.where(valid, idx, 0)], pad)
