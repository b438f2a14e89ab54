"""Database lookup, plain PyTorch: query features -> per-read match lists
sorted by (target, window).

Counterpart of metacache_tpu/ops/lookup.py::lookup_matches
(sketch_database::accumulate_matches, src/sketch_database.h:804-833, plus
the per-read merge sort of src/querying.h:88-106). Every stored location
of every query feature is appended; a feature sketched in two windows
contributes its locations twice.

Truncation contract (identical to the JAX package): match slots fill in
feature order, and within a feature in CSR order; the first `lmax` slots
are kept and then sorted. `total` is the pre-truncation count clamped to
lmax, `overflow` the number of locations dropped.

The scattered CSR location fetch is the hand-written CUDA gather kernel
(ops/gather_cuda.py::gather_rows) on the card and its plain version on
the CPU. Clade exclusion (remove_hits_on_rank,
src/classification.cpp:141-157; JAX local_candidates) masks the matches
of a read's own clade AFTER the cut to lmax: an excluded location never
frees a slot for another one, and total / overflow count the locations
before exclusion.
"""
from __future__ import annotations

import torch

from metacache_tpu.config import FEATURE_SENTINEL, TARGET_SENTINEL

from .gather_cuda import gather_rows

#: packed location word: (target << LOC_SHIFT) | window, as int64, so the
#: numeric order of a word is the (target, window) order
LOC_SHIFT = 32
_LOC_PAD = torch.iinfo(torch.int64).max
_WIN_PAD = int(TARGET_SENTINEL)


def lookup_matches(features: torch.Tensor, keys: torch.Tensor,
                   offsets: torch.Tensor, locations: torch.Tensor,
                   lmax: int, exclude_groups: torch.Tensor = None,
                   target_groups: torch.Tensor = None):
    """Gather + sort the match lists of a batch of reads.

    Args:
      features:  [B, NF] int64 query features (FEATURE_SENTINEL = none)
      keys:      [F] int64 sorted feature keys
      offsets:   [F+1] int64 CSR offsets into `locations`
      locations: [N] int64 packed (target << 32 | window) words
      lmax:      per-read match-list capacity
      exclude_groups: optional [B] int64 clade of each read (0 = none)
      target_groups:  [T+1] int64 target -> clade on the exclusion rank
                 (the last entry, 0, absorbs the pad); needed with
                 exclude_groups

    Returns (tgt, win, total, overflow): tgt/win [B, lmax] int64 sorted by
    (tgt, win), padded with TARGET_SENTINEL / 2^31-1; total, overflow [B].
    """
    B, NF = features.shape
    dev = features.device
    if keys.numel() == 0:
        tgt = torch.full((B, lmax), _WIN_PAD, dtype=torch.int64, device=dev)
        zero = torch.zeros(B, dtype=torch.int64, device=dev)
        return tgt, tgt.clone(), zero, zero.clone()
    idx = torch.searchsorted(keys, features).clamp_(max=keys.numel() - 1)
    found = (keys[idx] == features) & (features != int(FEATURE_SENTINEL))
    start = offsets[idx]
    cnt = torch.where(found, offsets[idx + 1] - start, 0)

    cum = cnt.cumsum(dim=1)
    total_all = cum[:, -1]
    # slot j of a read belongs to the first feature whose run ends past j
    slots = torch.arange(lmax, device=dev).expand(B, lmax).contiguous()
    fi = torch.searchsorted(cum, slots, right=True).clamp_(max=NF - 1)
    li = start.gather(1, fi) + slots - (cum - cnt).gather(1, fi)
    total = total_all.clamp(max=lmax)
    loc = gather_rows(locations, li, total, _LOC_PAD)
    if exclude_groups is not None:
        # masking before the one sort gives the JAX package's mask-then-
        # resort list: excluded words become pads and sort to the end
        pad_tgt = target_groups.shape[0] - 1
        t = torch.where(loc != _LOC_PAD, loc >> LOC_SHIFT, pad_tgt)
        eg = exclude_groups[:, None]
        loc = torch.where((target_groups[t] == eg) & (eg > 0), _LOC_PAD, loc)
    loc = loc.sort(dim=1).values
    ok = loc != _LOC_PAD
    tgt = torch.where(ok, loc >> LOC_SHIFT, int(TARGET_SENTINEL))
    win = torch.where(ok, loc & ((1 << LOC_SHIFT) - 1), _WIN_PAD)
    overflow = (total_all - lmax).clamp(min=0)
    return tgt, win, total, overflow
