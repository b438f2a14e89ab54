"""Dense sorted feature table — the TPU-native replacement for the
reference's hopscotch-style hash multimap (src/hash_multimap.h:192-1124)
and its chunk allocator (src/chunk_allocator.h).

Design (SURVEY.md §7): the build phase emits (feature u32, target i32,
window i32) triples; a stable sort by feature produces runs that become a
CSR structure:

    keys[F]        sorted unique feature values (uint32)
    offsets[F+1]   row offsets into the location arrays (int64 host/int32 dev)
    loc_tgt[L]     target ids  (int32)
    loc_win[L]     window ids  (int32)

Query lookup is a vectorized ``searchsorted`` + bounded gather — no probing,
no pointer chasing, perfectly batched for the VPU.

Semantics preserved from the reference:
  - per-feature location cap: the hash multimap keeps the FIRST
    `max_locations_per_feature` locations in insertion order, which is
    ascending (target, window) order (insert at src/hash_multimap.h:653 is
    called in target order, then window order; shrink drops the tail) —
    here: keep the first N entries of each sorted run.
  - "removing" an overpopulated feature clears its values but keeps the key
    (src/sketch_database.h:356-370) — here: drop the run entirely
    (observable behavior is identical: lookups find nothing).
"""
from __future__ import annotations

import dataclasses
import mmap
from typing import List, Optional, Tuple

import numpy as np

from ..config import FEATURE_SENTINEL


@dataclasses.dataclass
class FeatureTable:
    keys: np.ndarray      # [F] uint32, strictly increasing
    offsets: np.ndarray   # [F+1] int64
    loc_tgt: np.ndarray   # [L] int32
    loc_win: np.ndarray   # [L] int32

    # ------------------------------------------------------------------ stats
    @property
    def num_keys(self) -> int:
        return len(self.keys)

    @property
    def num_locations(self) -> int:
        return len(self.loc_tgt)

    def bucket_sizes(self) -> np.ndarray:
        return np.diff(self.offsets)

    def release_pages(self) -> None:
        """Drop the resident pages of the arrays that map a file (a built
        table): they leave the process's resident set and are read from
        the page cache again if touched."""
        for a in (self.keys, self.offsets, self.loc_tgt, self.loc_win):
            if isinstance(a.base, mmap.mmap):
                a.base.madvise(mmap.MADV_DONTNEED)

    # ------------------------------------------------------------------ build
    @classmethod
    def empty(cls) -> "FeatureTable":
        return cls(keys=np.zeros(0, np.uint32), offsets=np.zeros(1, np.int64),
                   loc_tgt=np.zeros(0, np.int32), loc_win=np.zeros(0, np.int32))

    @classmethod
    def from_triples(cls, features: np.ndarray, targets: np.ndarray,
                     windows: np.ndarray, max_locs_per_feature: int,
                     presorted_by_location: bool = True,
                     sort_in_place: bool = False) -> "FeatureTable":
        """Build from (feature, target, window) triples.

        If `presorted_by_location` the triples are already in ascending
        (target, window) order (true when targets are sketched in id order),
        so a stable sort on the feature alone yields runs sorted by
        (target, window) — the reference's per-bucket insertion order.

        sort_in_place: the caller's arrays may be reordered (enables the
        native radix sort without a copy — the build hot path).
        """
        features = np.ascontiguousarray(features, dtype=np.uint32)
        targets = np.ascontiguousarray(targets, dtype=np.int32)
        windows = np.ascontiguousarray(windows, dtype=np.int32)
        if not presorted_by_location:
            order0 = np.lexsort((windows, targets))
            features, targets, windows = (features[order0], targets[order0],
                                          windows[order0])
            sort_in_place = True
        if sort_in_place and len(features):
            # native sort + single-pass CSR (mcio_build_table): each numpy
            # step below is a full-array pass — seconds each at 10^7
            # triples on bandwidth-starved hosts
            from .. import native
            keys, offsets, lt, lw = native.build_csr_table(
                features, targets, windows, int(max_locs_per_feature))
            return cls(keys=keys, offsets=offsets, loc_tgt=lt, loc_win=lw)
        order = np.argsort(features, kind="stable")
        f = features[order]
        t = targets[order]
        w = windows[order]

        # runs of the (already sorted) feature array — np.unique would
        # sort a second time
        if len(f):
            brk = np.empty(len(f), dtype=bool)
            brk[0] = True
            np.not_equal(f[1:], f[:-1], out=brk[1:])
            run_starts = np.nonzero(brk)[0]
            keys = f[run_starts]
            counts = np.diff(np.append(run_starts, len(f)))
        else:
            keys = f
            run_starts = np.zeros(0, np.int64)
            counts = np.zeros(0, np.int64)
        # cap each run at max_locs_per_feature, keeping the first entries
        capped = np.minimum(counts, max_locs_per_feature)
        offsets = np.zeros(len(keys) + 1, dtype=np.int64)
        np.cumsum(capped, out=offsets[1:])
        if len(f) and offsets[-1] == len(f):
            # nothing capped: the sorted arrays ARE the location arrays
            return cls(keys=keys.astype(np.uint32), offsets=offsets,
                       loc_tgt=t, loc_win=w)
        over = np.nonzero(counts > max_locs_per_feature)[0]
        if len(keys) and len(over) <= 100_000:
            # heavy-tailed case: few runs exceed the cap — mark their
            # tails instead of re-gathering every location (the gather
            # formulation costs seconds at 10^7 locations)
            keep = np.ones(len(f), dtype=bool)
            for r in over:
                keep[run_starts[r] + max_locs_per_feature:
                     run_starts[r] + counts[r]] = False
            return cls(keys=keys.astype(np.uint32), offsets=offsets,
                       loc_tgt=t[keep], loc_win=w[keep])
        # gather kept entries: for run i, indices run_starts[i] + [0, capped[i])
        idx = _run_local_indices(run_starts, capped) if len(keys) else \
            np.zeros(0, np.int64)
        return cls(keys=keys.astype(np.uint32), offsets=offsets,
                   loc_tgt=t[idx], loc_win=w[idx])

    @classmethod
    def concat_shards(cls, tables: List["FeatureTable"]) -> "FeatureTable":
        """Concatenate shard tables WITHOUT re-applying the location cap.

        The shards partition targets, so per-feature runs from different
        shards are disjoint in targets; merging them and querying the union
        gives exactly the per-shard-lookup + candidate-merge result (each
        target's hits are complete within its own shard). The per-shard
        location cap stays as applied at build time — the reference's
        behavior (cap per rank, sketch_database.h:1079-1097)."""
        if not tables:
            return cls.empty()
        from .. import native
        keys, offsets, tg, w = native.merge_shard_tables(tables)
        return cls(keys=keys, offsets=offsets, loc_tgt=tg, loc_win=w)

    def merge_with(self, other: "FeatureTable",
                   max_locs_per_feature: int) -> "FeatureTable":
        """Merge two tables (used by `modify` mode): re-cap per feature,
        keeping ascending (target, window) order."""
        f = np.concatenate([np.repeat(self.keys, self.bucket_sizes()),
                            np.repeat(other.keys, other.bucket_sizes())])
        t = np.concatenate([self.loc_tgt, other.loc_tgt])
        w = np.concatenate([self.loc_win, other.loc_win])
        return FeatureTable.from_triples(f, t, w, max_locs_per_feature,
                                         presorted_by_location=False)

    # ------------------------------------------------------- maintenance ops
    def feature_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, counts) — the reference's get_keys_num_items dump
        (src/sketch_database.h:1060-1075), used for the distributed
        overpopulated-feature merge."""
        return self.keys, self.bucket_sizes().astype(np.int64)

    def remove_keys(self, keys_to_remove: np.ndarray) -> Tuple["FeatureTable", int]:
        """Drop the given feature keys; returns (new_table, #removed).

        Mirrors remove_features_with_more_locations_than_distributed
        (src/sketch_database.h:397-414)."""
        keys_to_remove = np.unique(np.asarray(keys_to_remove, dtype=np.uint32))
        mask = np.isin(self.keys, keys_to_remove)
        return self._filter_runs(~mask), int(mask.sum())

    def remove_overpopulated(self, max_locs: int) -> Tuple["FeatureTable", int]:
        """Drop features with more than `max_locs` locations
        (remove_features_with_more_locations_than,
        src/sketch_database.h:380-394)."""
        mask = self.bucket_sizes() > max_locs
        return self._filter_runs(~mask), int(mask.sum())

    def remove_ambiguous(self, target_to_group: np.ndarray,
                         max_groups: int) -> Tuple["FeatureTable", int]:
        """Drop features whose locations span more than `max_groups` distinct
        groups (groups = targets, or taxa on a rank) —
        remove_ambiguous_features (src/sketch_database.h:423-470)."""
        max_groups = max(1, int(max_groups))
        sizes = self.bucket_sizes()
        feat_of_loc = np.repeat(np.arange(self.num_keys), sizes)
        grp = target_to_group[self.loc_tgt]
        # distinct groups per feature: sort (feat, grp) pairs, count run breaks
        order = np.lexsort((grp, feat_of_loc))
        fo, go = feat_of_loc[order], grp[order]
        newpair = np.ones(len(fo), dtype=bool)
        newpair[1:] = (fo[1:] != fo[:-1]) | (go[1:] != go[:-1])
        distinct = np.bincount(fo[newpair], minlength=self.num_keys)
        mask = distinct > max_groups
        return self._filter_runs(~mask), int(mask.sum())

    def cap_locations(self, max_locs: int) -> "FeatureTable":
        """Truncate every run to its first `max_locs` locations — the
        shrink loop of the reference's max_locations_per_feature setter
        (src/sketch_database.h:356-368)."""
        sizes = self.bucket_sizes()
        if not len(sizes) or int(sizes.max()) <= max_locs:
            return self
        capped = np.minimum(sizes, max_locs)
        offsets = np.zeros(self.num_keys + 1, dtype=np.int64)
        np.cumsum(capped, out=offsets[1:])
        idx = _run_local_indices(self.offsets[:-1], capped)
        return FeatureTable(keys=self.keys, offsets=offsets,
                            loc_tgt=self.loc_tgt[idx],
                            loc_win=self.loc_win[idx])

    def _filter_runs(self, keep: np.ndarray) -> "FeatureTable":
        sizes = self.bucket_sizes()
        loc_keep = np.repeat(keep, sizes)
        new_counts = sizes[keep]
        offsets = np.zeros(keep.sum() + 1, dtype=np.int64)
        np.cumsum(new_counts, out=offsets[1:])
        return FeatureTable(keys=self.keys[keep], offsets=offsets,
                            loc_tgt=self.loc_tgt[loc_keep],
                            loc_win=self.loc_win[loc_keep])

    def packed_locations(self, pad_locs_to: Optional[int] = None,
                         win_bits: Optional[int] = None):
        """Locations packed into one int32 word (tgt << win_bits | win) when
        the id widths allow it (tgt_bits + win_bits <= 31), else None.

        Numeric order of the packed word equals lexicographic (tgt, win)
        order, so the device lookup can gather half the bytes and run a
        single-key merge sort (ops/lookup.py). Mirrors the reference's
        packed `location{target, window}` struct (src/sketch_database.h:
        157-189) — there for storage, here for HBM bandwidth.

        win_bits may be forced (sharded engine: all shards must agree on
        one packing so the merged device program has a single static shift).

        Returns (packed [L] int32, win_bits int) or (None, 0).
        """
        if self.num_locations == 0:
            return None, 0
        tmax = int(self.loc_tgt.max())
        wmax = int(self.loc_win.max())
        if win_bits is None:
            win_bits = max(1, wmax.bit_length())
        elif win_bits < max(1, wmax.bit_length()):
            return None, 0
        if max(1, tmax.bit_length()) + win_bits > 31:
            return None, 0
        L = pad_locs_to if pad_locs_to is not None else self.num_locations
        packed = np.zeros(L, dtype=np.int32)
        # chunked: one full-table int64 intermediate costs 2x the table
        # bytes transiently (5.7 GB at config-3 scale) and pulls entire
        # memmapped location arrays resident at once
        CH = 64 << 20
        n = self.num_locations
        for o in range(0, n, CH):
            e = min(n, o + CH)
            packed[o:e] = ((self.loc_tgt[o:e].astype(np.int64) << win_bits)
                           | self.loc_win[o:e].astype(np.int64)
                           ).astype(np.int32)
        return packed, win_bits

    # ------------------------------------------------------------ device view
    def device_arrays(self, pad_keys_to: Optional[int] = None,
                      pad_locs_to: Optional[int] = None):
        """Arrays padded for fixed-shape device use.

        keys are padded with FEATURE_SENTINEL (sorts last, never queried
        successfully because a sentinel feature is masked out); offsets are
        padded with the final offset so padded rows have zero length.
        """
        F = pad_keys_to if pad_keys_to is not None else self.num_keys
        L = pad_locs_to if pad_locs_to is not None else self.num_locations
        if F < self.num_keys or L < self.num_locations:
            raise ValueError("pad size smaller than table")
        if F == self.num_keys and L == self.num_locations:
            # no padding: return views (GB-scale tables stay memmap-backed;
            # fresh copies here cost 8+ GB of RSS at config-3 scale). The
            # offsets narrowing still copies when it converts.
            offsets = self.offsets
            if self.offsets[-1] < 2**31 and offsets.dtype != np.int32:
                offsets = offsets.astype(np.int32)
            return self.keys, offsets, self.loc_tgt, self.loc_win
        keys = np.full(F, FEATURE_SENTINEL, dtype=np.uint32)
        keys[:self.num_keys] = self.keys
        offsets = np.full(F + 1, self.offsets[-1], dtype=np.int64)
        offsets[:len(self.offsets)] = self.offsets
        tgt = np.zeros(L, dtype=np.int32)
        tgt[:self.num_locations] = self.loc_tgt
        win = np.zeros(L, dtype=np.int32)
        win[:self.num_locations] = self.loc_win
        return keys, offsets.astype(np.int32 if self.offsets[-1] < 2**31
                                    else np.int64), tgt, win


def _run_local_indices(run_starts: np.ndarray, capped: np.ndarray) -> np.ndarray:
    """Global indices selecting the first capped[i] elements of each run."""
    total = int(capped.sum())
    out_run = np.repeat(np.arange(len(run_starts)), capped)
    cum = np.zeros(len(run_starts), dtype=np.int64)
    np.cumsum(capped[:-1], out=cum[1:])
    local = np.arange(total, dtype=np.int64) - cum[out_run]
    return run_starts[out_run] + local


class ChunkedTripleSorter:
    """Memory-bounded external sort of (feature, target, window) triples —
    the streaming replacement for concatenating ALL triples in host RAM
    before one argsort (the reference streams hash-map insertions instead,
    src/sketch_database.h:1079-1097; SURVEY.md §7 calls for chunked
    sort-merge at RefSeq scale).

    Protocol: `add()` triples in ascending (target, window) order (the
    natural sketching order), or `adopt_chunks()` pre-sorted chunk files
    written by the native streaming spill pass (native.sketch_file_spill).
    Full buffers are feature-sorted (stable, so insertion order survives)
    and spilled to disk as raw chunk files (int64 n, f u32[n], t i32[n],
    w i32[n] — the same format the native pass writes). `finalize()` runs
    a native K-way streaming merge of all chunks straight into CSR table
    FILES, returned as (unlinked) memmap-backed arrays — the table is
    never materialized in host RAM; peak memory = one chunk buffer. The
    numpy fallback merges by KEY-RANGE passes (one range of the u32
    feature space in RAM at a time).
    """

    def __init__(self, chunk_triples: int = 32 << 20, tmpdir: str = None):
        self.chunk_triples = int(chunk_triples)
        self._tmp: Optional[str] = None  # created lazily on first spill
        self._tmpdir_given = tmpdir
        self._buf_f: List[np.ndarray] = []
        self._buf_t: List[np.ndarray] = []
        self._buf_w: List[np.ndarray] = []
        self._buf_n = 0
        self._chunks: List[Tuple[str, int]] = []  # (path, count)
        self.total = 0

    def add(self, f: np.ndarray, t: np.ndarray, w: np.ndarray):
        self._buf_f.append(np.ascontiguousarray(f, dtype=np.uint32))
        self._buf_t.append(np.ascontiguousarray(t, dtype=np.int32))
        self._buf_w.append(np.ascontiguousarray(w, dtype=np.int32))
        self._buf_n += len(f)
        self.total += len(f)
        if self._buf_n >= self.chunk_triples:
            self._spill()

    def adopt_chunks(self, chunks: List[Tuple[str, int]]):
        """Append pre-sorted raw chunk files (native spill pass output).
        Any buffered triples are spilled first — the chunk list must stay
        in insertion order for the per-feature cap semantics."""
        self._spill()
        for path, count in chunks:
            self._chunks.append((path, int(count)))
            self.total += int(count)

    def spill_dir(self) -> str:
        """Directory for spill files (created on demand) — the native
        spill pass writes its chunks here so finalize owns their cleanup."""
        import tempfile
        if self._tmp is None:
            self._tmp = tempfile.mkdtemp(prefix="mc_triples_",
                                         dir=self._tmpdir_given)
        return self._tmp

    def _concat_buf(self):
        f = np.concatenate(self._buf_f) if self._buf_f else \
            np.zeros(0, np.uint32)
        t = np.concatenate(self._buf_t) if self._buf_t else \
            np.zeros(0, np.int32)
        w = np.concatenate(self._buf_w) if self._buf_w else \
            np.zeros(0, np.int32)
        self._buf_f, self._buf_t, self._buf_w, self._buf_n = [], [], [], 0
        return f, t, w

    def _spill(self):
        import os
        f, t, w = self._concat_buf()
        if len(f) == 0:
            return
        from .. import native
        native.radix_sort_triples(f, t, w)
        path = os.path.join(self.spill_dir(),
                            f"chunk{len(self._chunks)}.bin")
        with open(path, "wb") as fh:
            fh.write(np.int64(len(f)).tobytes())
            f.tofile(fh)
            t.tofile(fh)
            w.tofile(fh)
        self._chunks.append((path, len(f)))

    def finalize(self, max_locs_per_feature: int,
                 range_budget: int = 64 << 20) -> "FeatureTable":
        import os
        import shutil
        if not self._chunks:
            # everything fit in one buffer: no disk round-trip
            f, t, w = self._concat_buf()
            return FeatureTable.from_triples(f, t, w, max_locs_per_feature,
                                             sort_in_place=True)
        self._spill()
        from .. import native
        paths = [p for p, _ in self._chunks]
        out_prefix = os.path.join(self.spill_dir(), "csr")
        res = None
        if paths:
            try:
                res = native.merge_chunks_csr(paths, max_locs_per_feature,
                                              out_prefix)
            except RuntimeError:
                res = None
        if res is not None:
            nk, nl = res
            ft = FeatureTable(
                keys=np.memmap(out_prefix + ".keys.bin", np.uint32,
                               mode="r", shape=(nk,)),
                offsets=np.memmap(out_prefix + ".offs.bin", np.int64,
                                  mode="r", shape=(nk + 1,)),
                loc_tgt=np.memmap(out_prefix + ".lt.bin", np.int32,
                                  mode="r", shape=(nl,)),
                loc_win=np.memmap(out_prefix + ".lw.bin", np.int32,
                                  mode="r", shape=(nl,)))
            # unlink everything: the memmaps keep their pages alive
            # (POSIX), so no disk space leaks even on a crash, and the
            # chunk files are no longer needed
            shutil.rmtree(self._tmp, ignore_errors=True)
            for p in paths:
                if os.path.exists(p):
                    os.unlink(p)
            return ft
        # numpy fallback: key-range passes (one range of the u32 feature
        # space in RAM at a time; each chunk is sorted, so one searchsorted
        # per chunk slices its range)
        mm = [native.open_chunk_arrays(p, c) for p, c in self._chunks]
        n_ranges = max(1, -(-self.total // int(range_budget)))
        bounds = np.linspace(0, 2**32, n_ranges + 1).astype(np.uint64)
        parts: List[FeatureTable] = []
        for r in range(n_ranges):
            lo, hi = np.uint32(bounds[r]), bounds[r + 1]
            fs, ts, ws = [], [], []
            for cf, ct, cw in mm:
                a = np.searchsorted(cf, lo, side="left")
                b = len(cf) if hi >= 2**32 else \
                    np.searchsorted(cf, np.uint32(hi), side="left")
                if b > a:
                    fs.append(np.asarray(cf[a:b]))
                    ts.append(np.asarray(ct[a:b]))
                    ws.append(np.asarray(cw[a:b]))
            if not fs:
                continue
            parts.append(FeatureTable.from_triples(
                np.concatenate(fs), np.concatenate(ts), np.concatenate(ws),
                max_locs_per_feature, sort_in_place=True))
        del mm
        shutil.rmtree(self._tmp, ignore_errors=True)
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)
        if not parts:
            return FeatureTable.empty()
        # ranges partition the key space: plain concatenation is the merge
        keys = np.concatenate([p.keys for p in parts])
        offs = [parts[0].offsets]
        base = parts[0].offsets[-1]
        for p in parts[1:]:
            offs.append(p.offsets[1:] + base)
            base += p.offsets[-1]
        return FeatureTable(
            keys=keys,
            offsets=np.concatenate(offs),
            loc_tgt=np.concatenate([p.loc_tgt for p in parts]),
            loc_win=np.concatenate([p.loc_win for p in parts]))
