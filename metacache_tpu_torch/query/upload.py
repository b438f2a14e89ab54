"""Database tables to a device: one streamed upload for every table, and
the merge of several shards on the device as they stream up.

Every table crosses through a Stager: two reusable pinned host buffers,
filled straight from the host arrays (a shard file's memory-mapped
arrays, read in place) by FILL_THREADS threads, copied to the card on a
side stream while the host fills the other buffer. Tables cross in their own width and are
widened to the engine's int64 on the device (unsigned words masked back);
locations are packed there as (target << 32) | window.

A fused query over P > 1 shards never builds the fused table on the host
(merged_feature_tables): plan_chunks cuts the key space into ranges that
hold at most CHUNK locations summed over the shards, never splitting a
key's bucket; a first pass stages each range's keys and counts the fused
keys (ops/merge_cuda.count_keys), so the fused tables are allocated once
at their exact sizes; a second pass stages every shard's slice of each
range and merges it (ops/merge_cuda.merge_chunk) straight into the final
location table, and the run starts of the keys written beside it give
the fused keys and offsets. The result equals the host merge
(FeatureTable.concat_shards, then feature_tables), tensor for tensor. On
the CPU the same chunks go through the merge's plain version.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..db.feature_table import FeatureTable
from ..ops import merge_cuda
from ..ops.lookup import LOC_SHIFT

#: locations per merged chunk (summed over the shards), elements per
#: staged piece of a single table; a pinned buffer holds CHUNK 4-byte words
CHUNK = 1 << 24
#: threads that fill a pinned buffer: one reads page-cached memory-mapped
#: tables at ~3 GB/s on the card's host, the copy to the card is ~10x that
FILL_THREADS = 4

_U32 = 0xFFFFFFFF


class Stager:
    """Host arrays to tensors on `device` through two reusable pinned
    buffers (on the CPU: copied straight into the tensor). Use it in a
    `with` block: it owns the threads that fill the buffers."""

    def __init__(self, device: torch.device):
        self.device = device
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._main = torch.cuda.current_stream(device)
            self._copies = torch.cuda.Stream(device)
            self._bufs = [torch.empty(CHUNK * 4, dtype=torch.uint8,
                                      pin_memory=True) for _ in range(2)]
            self._freed = [None, None]
            self._turn = 0
            self._last = None
            self._fill = ThreadPoolExecutor(FILL_THREADS)

    def __enter__(self) -> "Stager":
        return self

    def __exit__(self, *exc) -> None:
        if self._cuda:
            self._fill.shutdown()

    def empty(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        """A tensor to stage into: allocated on the copy stream and marked
        as used by the current one, so its memory is not handed out again
        before both are done with it."""
        if not self._cuda:
            return torch.empty(n, dtype=dtype)
        with torch.cuda.stream(self._copies):
            out = torch.empty(n, dtype=dtype, device=self.device)
        out.record_stream(self._main)
        return out

    def put(self, arr: np.ndarray, out: torch.Tensor) -> None:
        """Copy the host integer array `arr` into `out` (of the signed type
        of arr's width: unsigned words go as the same bits). On a card the
        copy is queued on the copy stream: call ready() before using it."""
        arr = arr.view(f"i{arr.dtype.itemsize}")
        if not self._cuda:
            out.numpy()[:] = arr
            return
        size = arr.dtype.itemsize
        step = len(self._bufs[0]) // size
        for o in range(0, len(arr), step):
            n = min(step, len(arr) - o)
            b, self._turn = self._turn, self._turn ^ 1
            if self._freed[b] is not None:
                self._freed[b].synchronize()
            host = self._bufs[b][:n * size].view(out.dtype)
            self._copy(host.numpy(), arr[o:o + n])
            with torch.cuda.stream(self._copies):
                out[o:o + n].copy_(host, non_blocking=True)
                self._freed[b] = self._last = torch.cuda.Event()
                self._last.record()

    def _copy(self, dst: np.ndarray, src: np.ndarray) -> None:
        """dst[:] = src, in FILL_THREADS slices (numpy copies without the
        interpreter lock)."""
        step = -(-len(src) // FILL_THREADS)
        for f in [self._fill.submit(np.copyto, dst[o:o + step],
                                    src[o:o + step])
                  for o in range(0, len(src), step)]:
            f.result()

    def ready(self) -> None:
        """Make the current stream wait for every copy queued so far."""
        if self._cuda and self._last is not None:
            self._main.wait_event(self._last)

    def staged(self, arr: np.ndarray) -> torch.Tensor:
        """arr as a tensor of its own width on the device, ready to use."""
        out = self.empty(len(arr), _torch_int(arr.dtype.itemsize))
        self.put(arr, out)
        self.ready()
        return out


def _torch_int(size: int) -> torch.dtype:
    return {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[size]


def upload_int64(stager: Stager, arr: np.ndarray) -> torch.Tensor:
    """Host integer array -> int64 tensor on the stager's device, staged
    CHUNK elements at a time and widened there."""
    out = torch.empty(len(arr), dtype=torch.int64, device=stager.device)
    for o in range(0, len(arr), CHUNK):
        dst = out[o:o + CHUNK]
        dst.copy_(stager.staged(arr[o:o + CHUNK]))
        if arr.dtype.kind == "u":
            dst &= (1 << (8 * arr.dtype.itemsize)) - 1
    return out


def upload_locations(stager: Stager, tgt: np.ndarray,
                     win: np.ndarray) -> torch.Tensor:
    """Per-location targets and windows (int32) -> packed int64
    (target << 32) | window on the stager's device."""
    out = torch.empty(len(tgt), dtype=torch.int64, device=stager.device)
    for o in range(0, len(tgt), CHUNK):
        dst = out[o:o + CHUNK]
        dst.copy_(stager.staged(tgt[o:o + CHUNK]))
        dst <<= LOC_SHIFT
        dst |= stager.staged(win[o:o + CHUNK])
    return out


def feature_tables(stager: Stager, tables: Sequence[FeatureTable]
                   ) -> Dict[str, torch.Tensor]:
    """The engine's keys, offsets and packed locations (int64) of one
    feature table, or of several shards' tables fused (merged on the
    device)."""
    if len(tables) > 1:
        return merged_feature_tables(stager, tables)
    ft = tables[0]
    return {"keys": upload_int64(stager, ft.keys),
            "offsets": upload_int64(stager, ft.offsets),
            "locations": upload_locations(stager, ft.loc_tgt, ft.loc_win)}


# ------------------------------------------------------------ shard merge
def plan_chunks(tables: Sequence[FeatureTable], cap: int
                ) -> List[Tuple[List[int], List[int]]]:
    """Cut the key space into ranges [K_c, K_c+1) that hold at most `cap`
    locations summed over the shards (a single key with more gets a range
    of its own) -> per range, each shard's key index bounds (begin, end).
    Binary searches on the (memory-mapped) sorted keys: a few pages read
    per range."""
    keys = [t.keys for t in tables]
    offs = [t.offsets for t in tables]
    sizes = [len(k) for k in keys]

    def cut(key: int) -> List[int]:
        """Per shard, the index of its first key >= key."""
        if key > _U32:
            return list(sizes)
        return [int(np.searchsorted(k, np.uint32(key))) for k in keys]

    def located(idx: List[int]) -> int:
        return sum(int(o[i]) for o, i in zip(offs, idx))

    plan = []
    lo_key, begin = 0, [0] * len(tables)
    end_all = located(sizes)
    while begin != sizes:
        base = located(begin)
        if end_all - base <= cap:
            plan.append((begin, list(sizes)))
            break
        lo, hi = lo_key, _U32 + 1     # lo fits, hi does not
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if located(cut(mid)) - base <= cap:
                lo = mid
            else:
                hi = mid
        end = cut(lo)
        if located(end) == base:      # the next key alone holds more
            lo = min(int(k[i]) for k, i, n in zip(keys, begin, sizes)
                     if i < n) + 1
            end = cut(lo)
        plan.append((begin, end))
        lo_key, begin = lo, end
    return plan


class _Chunk:
    """One planned range of every shard, staged on the device in the
    layout of ops/merge.py (keys and bounds; offs, tgt and win too with
    `locations`). Call the stager's ready() before using it."""

    def __init__(self, stager: Stager, tables: Sequence[FeatureTable],
                 begin: List[int], end: List[int], locations: bool):
        P = len(tables)
        la = [int(t.offsets[b]) for t, b in zip(tables, begin)]
        lb = [int(t.offsets[e]) for t, e in zip(tables, end)]
        kbeg = np.concatenate([[0], np.cumsum(np.subtract(end, begin))])
        lbeg = np.concatenate([[0], np.cumsum(np.subtract(lb, la))])
        self.nl = int(lbeg[-1])
        self.bounds = stager.empty(2 * (P + 1), torch.int64)
        stager.put(np.stack([kbeg, lbeg]).astype(np.int64).ravel(),
                   self.bounds)
        self.bounds = self.bounds.view(2, P + 1)
        self.keys = stager.empty(int(kbeg[-1]), torch.int32)
        for s, t in enumerate(tables):
            stager.put(t.keys[begin[s]:end[s]],
                       self.keys[kbeg[s]:kbeg[s + 1]])
        if not locations:
            return
        self.offs = stager.empty(int(kbeg[-1]) + P, torch.int64)
        self.tgt = stager.empty(self.nl, torch.int32)
        self.win = stager.empty(self.nl, torch.int32)
        for s, t in enumerate(tables):
            stager.put(t.offsets[begin[s]:end[s] + 1],
                       self.offs[kbeg[s] + s:kbeg[s + 1] + s + 1])
            stager.put(t.loc_tgt[la[s]:lb[s]],
                       self.tgt[lbeg[s]:lbeg[s + 1]])
            stager.put(t.loc_win[la[s]:lb[s]],
                       self.win[lbeg[s]:lbeg[s + 1]])


def _fused_keys(key: torch.Tensor, first_loc: int, keys: torch.Tensor,
                offsets: torch.Tensor, first_key: int) -> int:
    """A merged chunk's keys (one per location, in fused order) -> its run
    starts written into the fused keys and offsets from first_key on;
    returns the next free key index."""
    if not len(key):
        return first_key
    starts = torch.ones(len(key), dtype=torch.bool, device=key.device)
    torch.ne(key[1:], key[:-1], out=starts[1:])
    at = starts.nonzero().squeeze(1)
    end = first_key + len(at)
    dst = keys[first_key:end]
    dst.copy_(key[at])
    dst &= _U32
    torch.add(at, first_loc, out=offsets[first_key:end])
    return end


def merged_feature_tables(stager: Stager, tables: Sequence[FeatureTable]
                          ) -> Dict[str, torch.Tensor]:
    """P > 1 shard tables -> the fused table's keys, offsets and packed
    locations on the stager's device, merged there in chunks of at most
    CHUNK locations."""
    device = stager.device
    plan = plan_chunks(tables, CHUNK)
    count = torch.zeros(1, dtype=torch.int64, device=device)
    for begin, end in plan:
        chunk = _Chunk(stager, tables, begin, end, locations=False)
        stager.ready()
        merge_cuda.count_keys(chunk.keys, chunk.bounds, count)
    n_keys = int(count)
    n_locs = sum(t.num_locations for t in tables)
    keys = torch.empty(n_keys, dtype=torch.int64, device=device)
    offsets = torch.empty(n_keys + 1, dtype=torch.int64, device=device)
    locations = torch.empty(n_locs, dtype=torch.int64, device=device)
    done, pending, at = 0, None, 0
    for begin, end in plan:
        # the host fills this chunk while the card merges the last one
        chunk = _Chunk(stager, tables, begin, end, locations=True)
        if pending is not None:
            done = _fused_keys(*pending, keys, offsets, done)
        stager.ready()
        key = merge_cuda.merge_chunk(chunk.keys, chunk.offs, chunk.tgt,
                                     chunk.win, chunk.bounds,
                                     locations[at:at + chunk.nl])
        pending = (key, at)
        at += chunk.nl
        del chunk
    if pending is not None:
        done = _fused_keys(*pending, keys, offsets, done)
    offsets[done] = n_locs
    if done < n_keys:
        # keys whose buckets are empty in every shard hold no location,
        # and the host merge drops them (no build writes such a bucket)
        keys, offsets = keys[:done].clone(), offsets[:done + 1].clone()
    return {"keys": keys, "offsets": offsets, "locations": locations}
