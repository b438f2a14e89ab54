"""The card build's triple store: one built shard's (feature, target,
window) triples held on the device in insertion order, sorted there.

The host build (db/build.py's native path) sorts each 32 M-triple chunk
on one host thread and merges the chunk files on another. Here a shard's
triples stay on the device as they are sketched, up to a budget. A store
that never reaches its budget is turned into its CSR feature table on the
device at finalize: one stable sort by feature (so each feature's
locations keep their insertion order), its runs, the first
`max_locations_per_feature` of each run; the four arrays are copied down
through a pinned buffer into files that are mapped back and unlinked, as
ChunkedTripleSorter.finalize leaves the table of its native merge. A
store that reaches its budget is sorted on the device and written as a
chunk file in the native pass's format (int64 n, f u32[n], t i32[n],
w i32[n]); its chunks end in the native K-way merge (ChunkedTripleSorter),
which keeps the first locations in (chunk, position) order: the same
table.

Features are u32 held as int32 bit patterns; a stable sort of the bits
xor 2^31 (int32 order) is their u32 order.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .feature_table import ChunkedTripleSorter, FeatureTable

#: xor with this turns u32 bit patterns held in int32 into int32 order
BIAS = -2**31

#: device bytes a stored triple takes (feature, target and window, int32)
STORE_BYTES = 12
#: device bytes per triple of the shard being finalized, beyond its store:
#: its sort keys and sorted keys (int32), the permutation (int64), the
#: sort's scratch, the run ranks of the cap (int32) and the gathered
#: location arrays
FINALIZE_BYTES = 36

#: bytes of the pinned buffer a store's arrays go down through
STAGING_BYTES = 64 << 20


class Staging:
    """Device arrays written to files through one reused pinned buffer
    (on the CPU: straight from the tensor)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._buf: Optional[torch.Tensor] = None

    def write(self, fh, t: torch.Tensor) -> None:
        t = t.contiguous()
        if t.device.type == "cpu":
            t.numpy().tofile(fh)
            return
        if self._buf is None:
            self._buf = torch.empty(STAGING_BYTES, dtype=torch.uint8,
                                    pin_memory=True)
        flat = t.view(-1).view(torch.uint8)
        for o in range(0, flat.numel(), STAGING_BYTES):
            n = min(STAGING_BYTES, flat.numel() - o)
            self._buf[:n].copy_(flat[o:o + n])
            fh.write(memoryview(self._buf[:n].numpy()))


def stable_sort(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the u32 features f sorted, as int32 bits; the stable permutation)."""
    keys = torch.bitwise_xor(f, BIAS)
    sk, perm = torch.sort(keys, stable=True)
    del keys
    return sk.bitwise_xor_(BIAS), perm


class DeviceTripleStore:
    """One shard's triples on `device`, appended in insertion order (the
    caller's record, then window, then feature order), sorted and spilled
    to a chunk file whenever `budget` triples are held. `mark()` at the
    start of an input file and `rollback()` drop everything the file added
    (its chunk files too): a spill inside a file writes the triples from
    before its mark as a chunk of their own, so none of them is lost.
    `commit()` ends the file."""

    def __init__(self, shard: int, device: torch.device, budget: int,
                 spill_dir: Callable[[], str], staging: Staging,
                 log: Optional[Callable[[str], None]] = None):
        self.shard = shard
        self.device = device
        self.budget = max(1, int(budget))
        self._spill_dir = spill_dir
        self._staging = staging
        self._log = log
        self.f: List[torch.Tensor] = []
        self.t: List[torch.Tensor] = []
        self.w: List[torch.Tensor] = []
        self.fill = 0
        self.chunks: List[Tuple[str, int]] = []   # spilled, in order
        self._mark: Optional[Tuple[int, int]] = None

    def add(self, f, t, w) -> None:
        """Append triples (device tensors or host arrays; int32, the
        features as u32 bits); spill once the budget is reached."""
        f, t, w = (torch.as_tensor(np.ascontiguousarray(x).view(np.int32))
                   .to(self.device) if isinstance(x, np.ndarray) else x
                   for x in (f, t, w))
        if not f.numel():
            return
        self.f.append(f)
        self.t.append(t)
        self.w.append(w)
        self.fill += f.numel()
        if self.fill >= self.budget:
            self.spill()

    def mark(self) -> None:
        self._mark = (len(self.f), len(self.chunks))

    def commit(self) -> None:
        self._mark = None

    def rollback(self) -> None:
        segs, chunks = self._mark
        for path, _ in self.chunks[chunks:]:
            os.unlink(path)
        del self.chunks[chunks:], self.f[segs:], self.t[segs:], self.w[segs:]
        self.fill = sum(x.numel() for x in self.f)
        self._mark = None

    def spill(self) -> None:
        """Sort the held triples on the device and write them as chunk
        files (two at a file's mark, one otherwise); the store is then
        empty."""
        if not self.fill:
            return
        cut = self._mark[0] if self._mark else 0
        for lo, hi in ((0, cut), (cut, len(self.f))):
            if hi > lo:
                self._write_chunk(lo, hi)
        if self._mark:
            self._mark = (0, self._mark[1] + (cut > 0))
        self.f, self.t, self.w, self.fill = [], [], [], 0

    def _write_chunk(self, lo: int, hi: int) -> None:
        f, perm = stable_sort(torch.cat(self.f[lo:hi]))
        t = torch.cat(self.t[lo:hi])[perm]
        w = torch.cat(self.w[lo:hi])[perm]
        del perm
        n = f.numel()
        path = os.path.join(self._spill_dir(),
                            f"s{self.shard}.d{len(self.chunks)}.bin")
        with open(path, "wb") as fh:
            fh.write(np.int64(n).tobytes())
            for x in (f, t, w):
                self._staging.write(fh, x)
        self.chunks.append((path, n))
        if self._log:
            self._log(f"  shard {self.shard}: {n} triples sorted on "
                      f"{self.device.type} and spilled to {path}")

    def finalize(self, cap: int) -> Optional[FeatureTable]:
        """The shard's feature table, built on the device from the held
        triples; None for a store that has spilled (its remainder is
        written as a last chunk: merge_spilled finishes it)."""
        if self.chunks:
            self.spill()
            return None
        if not self.fill:
            return FeatureTable.empty()
        f = torch.cat(self.f)
        self.f = []
        sk, perm = stable_sort(f)
        del f
        keys, counts = torch.unique_consecutive(sk, return_counts=True)
        del sk
        n = perm.numel()
        if int(counts.max()) > cap:
            starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
            rank = torch.arange(n, dtype=torch.int32, device=self.device) \
                - torch.repeat_interleave(starts, counts, output_size=n)
            del starts
            perm = perm[rank < cap]
            del rank
            counts = counts.clamp_(max=cap)
        offsets = torch.zeros(keys.numel() + 1, dtype=torch.int64,
                              device=self.device)
        torch.cumsum(counts, 0, out=offsets[1:])
        del counts
        lt = torch.cat(self.t)[perm]
        self.t = []
        lw = torch.cat(self.w)[perm]
        self.w = []
        del perm
        self.fill = 0
        return self._to_files(keys, offsets, lt, lw)

    def _to_files(self, keys, offsets, lt, lw) -> FeatureTable:
        """The arrays copied down into files, mapped back read-only and
        unlinked (the pages live as long as the maps)."""
        d = tempfile.mkdtemp(prefix="mc_table_", dir=self._spill_dir())
        arrays = []
        try:
            for name, x, dtype in (("keys", keys, np.uint32),
                                   ("offs", offsets, np.int64),
                                   ("lt", lt, np.int32),
                                   ("lw", lw, np.int32)):
                path = os.path.join(d, f"{name}.bin")
                with open(path, "wb") as fh:
                    self._staging.write(fh, x)
                arrays.append(np.memmap(path, dtype, mode="r",
                                        shape=(x.numel(),))
                              if x.numel() else np.zeros(0, dtype))
        finally:
            shutil.rmtree(d, ignore_errors=True)
        return FeatureTable(keys=arrays[0], offsets=arrays[1],
                            loc_tgt=arrays[2], loc_win=arrays[3])

    def merge_spilled(self, cap: int) -> FeatureTable:
        """A spilled store's table: its chunks K-way merged on the host
        (native.merge_chunks_csr, through ChunkedTripleSorter, which
        deletes them)."""
        sorter = ChunkedTripleSorter()
        sorter.adopt_chunks(self.chunks)
        self.chunks = []
        return sorter.finalize(cap)
