"""Native (C++) host library of the port: libmcio.

`mcio` — batched FASTA/FASTQ reading + 2-bit encoding/packing directly into
the device batch layout, the build's parse + sketch + spill passes, the CSR
table merges and the mapping-line formatter (see mcio.cpp). The library is
compiled from mcio.cpp with g++ at first use into build/metacache_tpu_torch/
(ops/cuda_build.py::build_library, the file named by a hash of the source
and flags) and loaded with ctypes. load_mcio() raises if it cannot be built
or loaded: the port has no pure-Python fallback for the paths that use it.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..io import sequence_io
from ..ops.cuda_build import build_library

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mcio.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
GXX_LIBS = ("-lz", "-lpthread")

_lock = threading.Lock()
_lib = None

PAIRING_CODE = {"none": 0, "": 0, None: 0, "files": 1, "sequences": 2}

#: error kinds of a sketch or spill result (mcio.cpp ErrorKind)
OK, ERR_CONTENT, ERR_SPILL_IO = 0, 1, 2


def library_path() -> str:
    """Build libmcio (if needed) and return its path."""
    return build_library(_SRC, "libmcio", "g++", GXX_FLAGS, GXX_LIBS)[0]


def load_mcio():
    """Load (building if needed) the native library; raises RuntimeError
    if g++ fails or the library does not load."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"libmcio ({path}) does not load: {e}") \
                from e
        lib.mcio_open.restype = ctypes.c_void_p
        lib.mcio_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int]
        lib.mcio_next_batch.restype = ctypes.c_int64
        lib.mcio_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.mcio_error.restype = ctypes.c_char_p
        lib.mcio_error.argtypes = [ctypes.c_void_p]
        lib.mcio_close.restype = None
        lib.mcio_close.argtypes = [ctypes.c_void_p]
        lib.mcio_sketch_file.restype = ctypes.c_void_p
        lib.mcio_sketch_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int]
        lib.mcio_sk_counts.restype = None
        lib.mcio_sk_counts.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
        lib.mcio_sk_fetch.restype = None
        lib.mcio_sk_fetch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 7
        lib.mcio_sk_error.restype = ctypes.c_char_p
        lib.mcio_sk_error.argtypes = [ctypes.c_void_p]
        lib.mcio_sk_error_kind.restype = ctypes.c_int
        lib.mcio_sk_error_kind.argtypes = [ctypes.c_void_p]
        lib.mcio_sk_free.restype = None
        lib.mcio_sk_free.argtypes = [ctypes.c_void_p]
        lib.mcio_radix_sort_triples.restype = None
        lib.mcio_radix_sort_triples.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib.mcio_build_table.restype = ctypes.c_void_p
        lib.mcio_build_table.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64]
        lib.mcio_table_counts.restype = None
        lib.mcio_table_counts.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p]
        lib.mcio_table_fetch.restype = None
        lib.mcio_table_fetch.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_void_p] * 4
        lib.mcio_table_free.restype = None
        lib.mcio_table_free.argtypes = [ctypes.c_void_p]
        lib.mcio_merge_shard_tables.restype = ctypes.c_int64
        lib.mcio_merge_shard_tables.argtypes = [
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.mcio_sketch_file_spill.restype = ctypes.c_void_p
        lib.mcio_sketch_file_spill.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_char_p]
        lib.mcio_sp_counts.restype = None
        lib.mcio_sp_counts.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_void_p] * 3
        lib.mcio_sp_fetch.restype = None
        lib.mcio_sp_fetch.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_void_p] * 7
        lib.mcio_sp_error.restype = ctypes.c_char_p
        lib.mcio_sp_error.argtypes = [ctypes.c_void_p]
        lib.mcio_sp_error_kind.restype = ctypes.c_int
        lib.mcio_sp_error_kind.argtypes = [ctypes.c_void_p]
        lib.mcio_sp_free.restype = None
        lib.mcio_sp_free.argtypes = [ctypes.c_void_p]
        lib.mcio_merge_chunks_csr.restype = ctypes.c_int64
        lib.mcio_merge_chunks_csr.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_void_p]
        lib.mcio_rs_open.restype = ctypes.c_void_p
        lib.mcio_rs_open.argtypes = [ctypes.c_char_p]
        lib.mcio_rs_error.restype = ctypes.c_char_p
        lib.mcio_rs_error.argtypes = [ctypes.c_void_p]
        lib.mcio_rs_next.restype = ctypes.c_int64
        lib.mcio_rs_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        lib.mcio_rs_close.restype = None
        lib.mcio_rs_close.argtypes = [ctypes.c_void_p]
        lib.mcio_format_lines.restype = ctypes.c_int64
        lib.mcio_format_lines.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
        return _lib


class PackedBatch:
    """One device-ready batch of (paired) reads.

    headers decode LAZILY from the raw byte buffer: the default CLI fast
    path formats mapping lines natively from hdr_buf/hdr_off
    (mcio_format_lines) and never pays the ~1 us/read python decode."""

    __slots__ = ("n", "packed1", "ambig1", "lens1", "packed2", "ambig2",
                 "lens2", "indices", "hdr_buf", "hdr_off", "_headers")

    def __init__(self, n, packed1, ambig1, lens1, packed2, ambig2, lens2,
                 hdr_buf, hdr_off, indices):
        self.n = n
        self.packed1, self.ambig1, self.lens1 = packed1, ambig1, lens1
        self.packed2, self.ambig2, self.lens2 = packed2, ambig2, lens2
        self.hdr_buf = hdr_buf      # np.uint8, concatenated header bytes
        self.hdr_off = hdr_off      # int64 [n+1]
        self.indices = indices
        self._headers: Optional[List[str]] = None

    @property
    def headers(self) -> List[str]:
        if self._headers is None:
            hb = self.hdr_buf.tobytes()
            off = self.hdr_off
            self._headers = [hb[off[i]:off[i + 1]].decode("utf-8",
                                                          "replace")
                             for i in range(self.n)]
        return self._headers


class NativeBatchReader:
    """Stream (paired) reads as packed device batches via libmcio.

    Raises OSError if the file can't be opened, RuntimeError on format
    errors — mirroring io.sequence_io exceptions.
    """

    def __init__(self, path1: str, path2: Optional[str], pairing: str,
                 batch_size: int, max_len: int, limit: int = -1):
        assert max_len % 8 == 0
        self.lib = load_mcio()
        self.B, self.L = batch_size, max_len
        self.limit = limit
        self._served = 0
        code = PAIRING_CODE.get(pairing, 0)
        p2 = path2.encode() if (path2 and code == 1) else None
        self.h = self.lib.mcio_open(path1.encode(), p2, code)
        if not self.h:
            raise OSError(f"can't open file {path1}" +
                          (f" / {path2}" if path2 else ""))
        self._hdr_cap = 1 << 22

    def __iter__(self) -> Iterator[PackedBatch]:
        return self

    def __next__(self) -> PackedBatch:
        if self.h is None:
            raise StopIteration
        B, L = self.B, self.L
        if self.limit >= 0:
            B = min(B, self.limit - self._served)
            if B <= 0:
                self.close()
                raise StopIteration
        p1 = np.zeros((self.B, L // 4), np.uint8)
        a1 = np.zeros((self.B, L // 8), np.uint8)
        l1 = np.zeros(self.B, np.int32)
        p2 = np.zeros((self.B, L // 4), np.uint8)
        a2 = np.zeros((self.B, L // 8), np.uint8)
        l2 = np.zeros(self.B, np.int32)
        hdr = np.zeros(self._hdr_cap, np.uint8)
        off = np.zeros(self.B + 1, np.int64)
        idx = np.zeros(self.B, np.int32)
        n = self.lib.mcio_next_batch(
            self.h, B, L,
            p1.ctypes.data, a1.ctypes.data, l1.ctypes.data,
            p2.ctypes.data, a2.ctypes.data, l2.ctypes.data,
            hdr.ctypes.data, self._hdr_cap, off.ctypes.data,
            idx.ctypes.data)
        if n < 0:
            msg = self.lib.mcio_error(self.h).decode()
            self.close()
            raise RuntimeError(msg)
        if n == 0:
            self.close()
            raise StopIteration
        self._served += n
        return PackedBatch(int(n), p1, a1, l1, p2, a2, l2,
                           hdr[:off[n]].copy(), off[:n + 1].copy(),
                           idx[:n].copy())

    def close(self):
        if self.h is not None:
            self.lib.mcio_close(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RecordBatch:
    """Whole records of a file, as RecordStream.next_batch reads them:
    their sequences packed one after another at the front of the caller's
    buffer (record i at offsets[i], lens[i] bytes), and their headers."""

    __slots__ = ("lens", "offsets", "headers")

    def __init__(self, lens: np.ndarray, headers: List[str]):
        self.lens = lens
        self.offsets = np.zeros(len(lens), np.int64)
        np.cumsum(lens[:-1], out=self.offsets[1:])
        self.headers = headers

    @property
    def nbytes(self) -> int:
        return int(self.lens.sum())


class RecordTooLarge(Exception):
    """The next record does not fit an empty sequence buffer of the size
    given: `need` bytes would."""

    def __init__(self, need: int):
        super().__init__(f"a record of {need} bytes")
        self.need = need


class RecordStream:
    """The card build's parse of one FASTA/FASTQ file (mcio_rs_*): whole
    records in batches that fill a caller's buffer, read with the reader
    the native passes use, neither sketched nor sorted. Raises OSError if
    the file can't be opened and sequence_io.FormatError when it is in no
    known format or holds a malformed record (the native passes'
    messages)."""

    MAX_RECORDS = 1 << 16

    def __init__(self, path: str):
        self.lib = load_mcio()
        self.h = self.lib.mcio_rs_open(path.encode())
        if not self.h:
            raise OSError(f"can't read file {path}")
        self._lens = np.zeros(self.MAX_RECORDS, np.int64)
        self._hdr = np.zeros(1 << 20, np.uint8)
        self._hdr_off = np.zeros(self.MAX_RECORDS + 1, np.int64)
        self._need = np.zeros(2, np.int64)
        self._check(0)

    def _check(self, n: int) -> None:
        if n == -1 or (n == 0 and self.lib.mcio_rs_error(self.h)):
            msg = self.lib.mcio_rs_error(self.h).decode()
            self.close()
            raise sequence_io.FormatError(msg)

    def next_batch(self, seq: np.ndarray) -> Optional[RecordBatch]:
        """The next records into the uint8 buffer `seq`, or None at the end
        of the file; RecordTooLarge if the next record alone exceeds
        `seq` (the record stays for the next call)."""
        if self.h is None:
            return None
        while True:
            n = self.lib.mcio_rs_next(
                self.h, seq.ctypes.data, len(seq), self._lens.ctypes.data,
                self.MAX_RECORDS, self._hdr.ctypes.data, len(self._hdr),
                self._hdr_off.ctypes.data, self._need.ctypes.data)
            if n != -2 or self._need[1] <= len(self._hdr):
                break
            self._hdr = np.zeros(int(self._need[1]), np.uint8)
        if n == -2:
            raise RecordTooLarge(int(self._need[0]))
        self._check(n)
        if n == 0:
            self.close()
            return None
        hb = self._hdr[:self._hdr_off[n]].tobytes()
        off = self._hdr_off
        return RecordBatch(self._lens[:n].copy(), [
            hb[off[i]:off[i + 1]].decode("utf-8", "replace")
            for i in range(n)])

    def close(self):
        if self.h is not None:
            self.lib.mcio_rs_close(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SketchedFile:
    """Result of a native parse+sketch pass over one input file.

    feat/tgt/win are the (feature, target, window) triples of the
    shard-owned records, in (target asc, window asc, hash asc) order —
    exactly the insertion order of the reference build
    (add_all_window_sketches, src/sketch_database.h:1079-1097).
    headers/seq_lens/seq_windows cover ALL records of the file.
    """

    __slots__ = ("feat", "tgt", "win", "headers", "seq_lens", "seq_windows")

    def __init__(self, feat, tgt, win, headers, seq_lens, seq_windows):
        self.feat, self.tgt, self.win = feat, tgt, win
        self.headers: Optional[List[str]] = headers
        self.seq_lens = seq_lens
        self.seq_windows = seq_windows


def _raise_error(kind: int, message: bytes) -> None:
    """The exception of a native result's error (mcio.cpp ErrorKind):
    FormatError for the input's content, OSError for a spill chunk."""
    if kind == ERR_CONTENT:
        raise sequence_io.FormatError(message.decode())
    if kind == ERR_SPILL_IO:
        raise OSError(message.decode())


def _fetch_sketch_result(lib, handle, t0: int, want_headers: bool):
    import ctypes as ct
    kind = lib.mcio_sk_error_kind(handle)
    if kind != OK:
        err = lib.mcio_sk_error(handle)
        lib.mcio_sk_free(handle)
        _raise_error(kind, err)
    n_rec, n_tri, hdr_b = ct.c_int64(), ct.c_int64(), ct.c_int64()
    lib.mcio_sk_counts(handle, ct.byref(n_rec), ct.byref(n_tri),
                       ct.byref(hdr_b))
    n, t = n_rec.value, n_tri.value
    feat = np.zeros(t, np.uint32)
    tgt = np.zeros(t, np.int32)
    win = np.zeros(t, np.int32)
    hdr = np.zeros(hdr_b.value, np.uint8) if want_headers else None
    off = np.zeros(n + 1, np.int64) if want_headers else None
    lens = np.zeros(n, np.int64)
    wins = np.zeros(n, np.int32)
    lib.mcio_sk_fetch(handle, t0, feat.ctypes.data, tgt.ctypes.data,
                      win.ctypes.data,
                      hdr.ctypes.data if hdr is not None else None,
                      off.ctypes.data if off is not None else None,
                      lens.ctypes.data, wins.ctypes.data)
    lib.mcio_sk_free(handle)
    headers = None
    if want_headers:
        hb = hdr.tobytes()
        headers = [hb[off[i]:off[i + 1]].decode("utf-8", "replace")
                   for i in range(n)]
    return SketchedFile(feat, tgt, win, headers, lens, wins)


def sketch_file(path: str, k: int, s: int, window: int, stride: int,
                t0: int, num_shards: int = 1, shard_id: int = 0,
                threads: int = 0) -> Optional[SketchedFile]:
    """Parse + sketch one FASTA/FASTQ file natively (build hot loop).

    Returns None when the file can't be opened / params are out of
    range; raises sequence_io.FormatError when it is in no known format or
    holds a malformed record (the Python reader's messages)."""
    lib = load_mcio()
    if s > 64 or not (1 <= k <= 16):
        return None
    h = lib.mcio_sketch_file(path.encode(), k, s, window, stride,
                             t0, num_shards, shard_id, threads)
    if not h:
        return None
    return _fetch_sketch_result(lib, h, t0, want_headers=True)


class SpilledFile:
    """Result of a native parse+sketch+SPILL pass over one input file
    (bounded-memory build): metadata for ALL records, plus the sorted
    triple chunk files written per owned shard. chunks: [(shard, path,
    count), ...] in spill order (= insertion order within each shard)."""

    __slots__ = ("headers", "seq_lens", "seq_windows", "chunks")

    def __init__(self, headers, seq_lens, seq_windows, chunks):
        self.headers: List[str] = headers
        self.seq_lens = seq_lens
        self.seq_windows = seq_windows
        self.chunks: List[Tuple[int, str, int]] = chunks


def sketch_file_spill(path: str, k: int, s: int, window: int, stride: int,
                      t0: int, num_shards: int, shard_ids,
                      chunk_triples: int, prefix: str,
                      threads: int = 0) -> Optional[SpilledFile]:
    """Parse + sketch one file natively, spilling feature-sorted triple
    chunks to '<prefix>.s<shard>.c<idx>.bin' instead of returning triples
    (peak memory = parse queue + one chunk buffer per shard, independent
    of file size — the at-scale build path). Returns None when the file
    can't be opened / params are out of range. Raises
    sequence_io.FormatError on content as sketch_file does, and OSError
    when a chunk cannot be written; either way the chunks this call wrote
    are deleted first."""
    import ctypes as ct
    lib = load_mcio()
    if s > 64 or not (1 <= k <= 16):
        return None
    sids = np.asarray(sorted(set(int(x) for x in shard_ids)), np.int64)
    h = lib.mcio_sketch_file_spill(
        path.encode(), k, s, window, stride, t0, num_shards,
        sids.ctypes.data, len(sids), threads, int(chunk_triples),
        prefix.encode())
    if not h:
        return None
    kind = lib.mcio_sp_error_kind(h)
    err = lib.mcio_sp_error(h)
    n_rec, n_ch, hdr_b = ct.c_int64(), ct.c_int64(), ct.c_int64()
    lib.mcio_sp_counts(h, ct.byref(n_rec), ct.byref(n_ch), ct.byref(hdr_b))
    n, nc = n_rec.value, n_ch.value
    hdr = np.zeros(hdr_b.value, np.uint8)
    off = np.zeros(n + 1, np.int64)
    lens = np.zeros(n, np.int64)
    wins = np.zeros(n, np.int32)
    csh = np.zeros(nc, np.int64)
    cix = np.zeros(nc, np.int64)
    cct = np.zeros(nc, np.int64)
    lib.mcio_sp_fetch(h, hdr.ctypes.data, off.ctypes.data,
                      lens.ctypes.data, wins.ctypes.data,
                      csh.ctypes.data, cix.ctypes.data, cct.ctypes.data)
    lib.mcio_sp_free(h)
    hb = hdr.tobytes()
    headers = [hb[off[i]:off[i + 1]].decode("utf-8", "replace")
               for i in range(n)]
    chunks = [(int(csh[c]), f"{prefix}.s{int(csh[c])}.c{int(cix[c])}.bin",
               int(cct[c])) for c in range(nc)]
    if kind != OK:
        for _, cpath, _ in chunks:
            os.unlink(cpath)
        _raise_error(kind, err)
    return SpilledFile(headers, lens, wins, chunks)


def merge_chunks_csr(paths: List[str], cap: int, out_prefix: str):
    """K-way merge of feature-sorted spill chunk files into CSR table
    files '<out_prefix>.{keys,offs,lt,lw}.bin' (streamed — the table is
    never materialized in RAM). paths must be in insertion order (chunk
    j's triples precede chunk j+1's for equal features). Returns
    (n_keys, n_locs); raises RuntimeError on IO failure."""
    import ctypes as ct
    lib = load_mcio()
    enc = [p.encode() for p in paths]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    nk = ct.c_int64()
    nl = lib.mcio_merge_chunks_csr(arr, len(enc), int(cap),
                                   out_prefix.encode(), ct.byref(nk))
    if nl < 0:
        raise RuntimeError(f"chunk merge failed for {out_prefix}")
    return int(nk.value), int(nl)


def open_chunk_arrays(path: str, count: int):
    """Memmap views (f u32, t i32, w i32) over one spill chunk file."""
    f = np.memmap(path, np.uint32, mode="r", offset=8, shape=(count,))
    t = np.memmap(path, np.int32, mode="r", offset=8 + 4 * count,
                  shape=(count,))
    w = np.memmap(path, np.int32, mode="r", offset=8 + 8 * count,
                  shape=(count,))
    return f, t, w


def format_mapping_lines(hdr_buf: np.ndarray, hdr_off: np.ndarray,
                         sidx: np.ndarray, strs,
                         soff: np.ndarray, col: bytes,
                         qids: Optional[np.ndarray] = None
                         ) -> Optional[bytes]:
    """Native per-read mapping-line formatter (mcio_format_lines).

    hdr_buf/hdr_off: concatenated raw header bytes + [n+1] offsets (the
    first token of each header is printed). sidx: [n] int64 taxon-string
    index per read (< 0 skips the read). strs/soff: concatenated taxon
    strings + [S+1] offsets. col: the column separator bytes. qids:
    optional [n] int32 query ids (printed first).
    Returns the output bytes, or None if they overflow the buffer."""
    lib = load_mcio()
    n = len(sidx)
    strs_arr = np.frombuffer(strs, np.uint8) if len(strs) else \
        np.zeros(0, np.uint8)
    cap = int(hdr_off[-1]) + n * (len(col) * 2 + 34) + \
        int((soff[1:] - soff[:-1]).max() if len(soff) > 1 else 0) * n
    out = np.empty(cap, np.uint8)
    # bound to names: the buffers must live until the call returns
    hdr_buf = np.ascontiguousarray(hdr_buf, np.uint8)
    hdr_off = np.ascontiguousarray(hdr_off, np.int64)
    sidx = np.ascontiguousarray(sidx, np.int64)
    soff = np.ascontiguousarray(soff, np.int64)
    if qids is not None:
        qids = np.ascontiguousarray(qids, np.int32)
    m = lib.mcio_format_lines(
        hdr_buf.ctypes.data, hdr_off.ctypes.data, n, sidx.ctypes.data,
        strs_arr.ctypes.data if len(strs_arr) else None, soff.ctypes.data,
        col, len(col), qids.ctypes.data if qids is not None else None,
        out.ctypes.data, cap)
    if m < 0:
        return None
    return out[:m].tobytes()


def radix_sort_triples(f: np.ndarray, t: np.ndarray, w: np.ndarray) -> None:
    """Stable in-place sort of (feature u32, target i32, window i32)
    triples by feature via the native LSD radix sort. Arrays must be
    contiguous and same-length."""
    lib = load_mcio()
    assert f.flags.c_contiguous and t.flags.c_contiguous \
        and w.flags.c_contiguous
    assert f.dtype == np.uint32 and t.dtype == np.int32 \
        and w.dtype == np.int32 and len(f) == len(t) == len(w)
    lib.mcio_radix_sort_triples(f.ctypes.data, t.ctypes.data, w.ctypes.data,
                                len(f))


def build_csr_table(f: np.ndarray, t: np.ndarray, w: np.ndarray,
                    cap: int):
    """Sort (in place) + CSR-construct a feature table natively.

    Returns (keys u32, offsets i64, loc_tgt i32, loc_win i32)."""
    lib = load_mcio()
    assert f.flags.c_contiguous and t.flags.c_contiguous \
        and w.flags.c_contiguous
    assert f.dtype == np.uint32 and t.dtype == np.int32 \
        and w.dtype == np.int32 and len(f) == len(t) == len(w)
    import ctypes as ct
    h = lib.mcio_build_table(f.ctypes.data, t.ctypes.data, w.ctypes.data,
                             len(f), cap)
    nk, nl = ct.c_int64(), ct.c_int64()
    lib.mcio_table_counts(h, ct.byref(nk), ct.byref(nl))
    keys = np.zeros(nk.value, np.uint32)
    offsets = np.zeros(nk.value + 1, np.int64)
    lt = np.zeros(nl.value, np.int32)
    lw = np.zeros(nl.value, np.int32)
    lib.mcio_table_fetch(h, keys.ctypes.data, offsets.ctypes.data,
                         lt.ctypes.data, lw.ctypes.data)
    lib.mcio_table_free(h)
    return keys, offsets, lt, lw


def merge_shard_tables(tables):
    """P-way merge of shard CSR tables into one fused (feature, target,
    window)-ordered table (mcio_merge_shard_tables — replaces a numpy
    3-key lexsort over all triples, which costs minutes at 10^8+ triples).
    `tables`: list of objects with .keys/.offsets/.loc_tgt/.loc_win.
    Returns (keys, offsets, loc_tgt, loc_win)."""
    import ctypes as ct
    lib = load_mcio()
    P = len(tables)
    keys = [np.ascontiguousarray(t.keys, np.uint32) for t in tables]
    offs = [np.ascontiguousarray(t.offsets, np.int64) for t in tables]
    tgts = [np.ascontiguousarray(t.loc_tgt, np.int32) for t in tables]
    wins = [np.ascontiguousarray(t.loc_win, np.int32) for t in tables]
    nkeys = np.array([len(k) for k in keys], np.int64)
    tot_k = int(nkeys.sum())
    tot_l = int(sum(len(t) for t in tgts))
    keys_out = np.zeros(tot_k, np.uint32)
    offs_out = np.zeros(tot_k + 1, np.int64)
    tgt_out = np.zeros(tot_l, np.int32)
    win_out = np.zeros(tot_l, np.int32)
    PtrArr = ct.c_void_p * P
    kp = PtrArr(*[k.ctypes.data for k in keys])
    op = PtrArr(*[o.ctypes.data for o in offs])
    tp = PtrArr(*[t.ctypes.data for t in tgts])
    wp = PtrArr(*[w.ctypes.data for w in wins])
    out_nk = ct.c_int64()
    nl = lib.mcio_merge_shard_tables(
        P, kp, op, nkeys.ctypes.data, tp, wp,
        keys_out.ctypes.data, offs_out.ctypes.data,
        tgt_out.ctypes.data, win_out.ctypes.data, ct.byref(out_nk))
    nk = out_nk.value
    return (keys_out[:nk], offs_out[:nk + 1], tgt_out[:nl], win_out[:nl])
