"""MinHash sketching, plain PyTorch: the s smallest distinct k-mer hashes
of each window (single_function_unique_min_hasher, src/hash_dna.h:50-182).

Counterpart of metacache_tpu/ops/sketch.py::sketch_windows and the plain
version of the CUDA kernel in ops/sketch_cuda.py. A hash equal to the
sentinel 0xFFFFFFFF never enters a sketch; a window with fewer than k
valid characters gives an all-sentinel sketch. Values are u32 held in
int64.
"""
from __future__ import annotations

from typing import Sequence

import torch

from metacache_tpu.config import FEATURE_SENTINEL

from .encode import AMBIG_CODE, unpack_codes, window_kmers
from .hashes import thomas_mueller_hash

SENTINEL = int(FEATURE_SENTINEL)


def sketch_windows(codes: torch.Tensor, valid_len: torch.Tensor,
                   k: int, sketch_size: int) -> torch.Tensor:
    """[B, W] uint8 codes + [B] window lengths -> [B, sketch_size] int64
    features, ascending, padded with the sentinel.

    The s smallest distinct values are order-independent, so they are
    taken as sort -> mask adjacent duplicates -> sort -> first s."""
    kmers, valid = window_kmers(codes, valid_len, k)
    h = torch.where(valid, thomas_mueller_hash(kmers), SENTINEL)
    hs = h.sort(dim=1).values
    dup = torch.zeros_like(hs, dtype=torch.bool)
    dup[:, 1:] = hs[:, 1:] == hs[:, :-1]
    hs = torch.where(dup, SENTINEL, hs).sort(dim=1).values
    if hs.shape[1] < sketch_size:
        pad = hs.new_full((hs.shape[0], sketch_size - hs.shape[1]), SENTINEL)
        hs = torch.cat([hs, pad], dim=1)
    return hs[:, :sketch_size]


def sketch_packed_reference(packed: torch.Tensor, ambig: torch.Tensor,
                            lens: torch.Tensor, *, k: int, sketch_size: int,
                            window_size: int,
                            starts: Sequence[int]) -> torch.Tensor:
    """Plain version of the fused read -> sketch kernel.

    packed [B, L/4] uint8, ambig [B, L/8] uint8, lens [B] int32, static
    window starts -> [B, len(starts) * sketch_size] int64: for each start
    s the sketch of characters [s, s + min(W, len - s)) of the read."""
    codes = unpack_codes(packed, ambig)
    B = codes.shape[0]
    feats = []
    for s in starts:
        w = codes[:, s:s + window_size]
        if w.shape[1] < window_size:
            pad = w.new_full((B, window_size - w.shape[1]), int(AMBIG_CODE))
            w = torch.cat([w, pad], dim=1)
        wlen = (lens.long() - s).clamp(0, window_size)
        feats.append(sketch_windows(w, wlen, k, sketch_size))
    return torch.cat(feats, dim=1)
