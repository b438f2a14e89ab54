"""Merge of sorted shard feature tables, one key-range chunk at a time,
plain PyTorch: the plain version of the CUDA merge kernel (csrc/merge.cu,
wrapper ops/merge_cuda.py).

A chunk is every shard's slice of one key range, laid end to end in shard
order (query/upload.py builds them): keys [NK] int32 (u32 bits), offs
[NK + P] int64 (each shard's offsets slice, one entry past its last key),
tgt / win [NL] int32, and bounds [2, P + 1] int64, where each shard's
keys (row 0) and locations (row 1) start. The fused order is (key,
target, window), equal triples in shard order: the order of the host
merge mcio_merge_shard_tables (native/mcio.cpp).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .lookup import LOC_SHIFT

_U32 = 0xFFFFFFFF


def location_keys(keys: torch.Tensor, offs: torch.Tensor,
                  bounds: torch.Tensor) -> torch.Tensor:
    """[NL] int32: the key of every location of the chunk, shard by
    shard."""
    kbeg = bounds[0].tolist()
    out = []
    for s in range(len(kbeg) - 1):
        o = offs[kbeg[s] + s:kbeg[s + 1] + s + 1]
        out.append(torch.repeat_interleave(keys[kbeg[s]:kbeg[s + 1]],
                                           o[1:] - o[:-1]))
    return torch.cat(out)


def merge_chunk_reference(keys: torch.Tensor, offs: torch.Tensor,
                          tgt: torch.Tensor, win: torch.Tensor,
                          bounds: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (packed locations [NL] int64, their keys [NL] int32) in the fused
    order: the shards concatenated in shard order, stably sorted by packed
    location, then stably by key."""
    key = location_keys(keys, offs, bounds)
    loc = (tgt.long() << LOC_SHIFT) | win.long()
    order = torch.sort(loc, stable=True).indices
    order = order[torch.sort(key[order].long() & _U32, stable=True).indices]
    return loc[order], key[order]


def count_keys_reference(keys: torch.Tensor) -> int:
    """The distinct keys of a chunk (a key that several shards hold counts
    once)."""
    return int(torch.unique(keys).numel())
