"""Database build: FASTA/FASTQ genomes -> sketches -> feature table.

Counterpart of metacache_tpu/db/build.py (add_to_database,
src/mode_build.cpp:559-843). `-device` picks the path of a file whose
records can be numbered up front (no empty record, no repeated sequence
id) at a sketch size of at most 64:
  * cuda, the card path (build_shards_on_card): the native record stream
    (native.RecordStream) parses the file into batches of whole records,
    each batch goes up through a pinned buffer, every window of it is
    sketched on the card (ops/sketch_cuda.py::sketch_windows) and its
    triples are appended to the shard's DeviceTripleStore
    (db/device_store.py), which sorts them on the card: into the shard's
    table at the end, or into chunk files when the store's device budget
    is reached;
  * cpu, the host path: the native C++ pass (libmcio: mcio_sketch_file,
    or mcio_sketch_file_spill for large files, which sorts 32 M-triple
    chunks on one thread) parses and sketches the file; its triples go to
    the external sorter (ChunkedTripleSorter), the JAX build's own path.
Both sketch bit-identically. Every other file takes the WindowBatcher
on `-device` (the card, or the CPU): records parsed in Python (empty
records and repeated ids skipped, the rest renumbered), their windows
packed into fixed-shape batches and sketched by the port's sketch
(sketch_packed). Triples reach each shard's sorter or store in the JAX
build's order, so the shard files are the JAX package's, array for
array, on either device.

A file in no known format or with a malformed record is reported on
stdout as `FAIL: <path>: <error>` and left out, as the JAX build (and
mode_build.cpp:630-643) does: the whole file on the native and card
paths, the records after the bad one on the WindowBatcher path.

Differences from the JAX build, on purpose:
  * if libmcio cannot load, the build raises (no all-Python build);
  * a spill chunk that cannot be written ends the build (OSError) instead
    of leaving the file out.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from .. import native
from ..config import FEATURE_SENTINEL, BuildParams, SketchParams
from ..device import resolve_device
from ..io import sequence_io, taxonomy_io
from ..ops import encode
from ..ops.sketch_cuda import sketch_packed, sketch_windows
from ..parallel import distributed
from .database import Database
from .device_store import (FINALIZE_BYTES, STORE_BYTES, DeviceTripleStore,
                           Staging)
from .feature_table import ChunkedTripleSorter, FeatureTable
from .taxonomy import NONE_TAXID, Rank, Taxonomy, rank_from_name

#: input files at or above this size stream through the native SPILL path
#: (per-shard sorted chunk files, bounded memory) instead of holding the
#: whole file's triples in RAM
SPILL_MIN_BYTES = 256 << 20

#: largest sketch size the native sketcher takes
NATIVE_MAX_SKETCH = 64

#: triples per in-RAM chunk of the external sort (ChunkedTripleSorter):
#: bounds build memory, larger builds spill sorted chunks to disk
CHUNK_TRIPLES = 32 << 20

#: accession -> taxid mapping files read from the inputs' directories
SEQUENCE_ID_MAPPINGS = ("assembly_summary.txt",)

#: sequence bytes per batch of the card path's record stream (each of its
#: two pinned buffers; a longer record gets a buffer of its own size)
BATCH_BYTES = 64 << 20

#: share of the card's free memory at the start of a build that its
#: device triple stores may hold, with one shard's finalize on top
DEVICE_SHARE = 0.5

#: windows per device batch of the WindowBatcher (the JAX build's
#: BUILD_WINDOW_BATCH: the flush points fix the order in which triples
#: reach the sorter, which the per-feature location cap depends on)
BUILD_WINDOW_BATCH = 8192


class WindowBatcher:
    """Packs the windows of each sequence into fixed-shape batches, sketches
    a full batch on the device and turns its sketches into (feature,
    target, window) triples for `triples` (a ChunkedTripleSorter).
    Counterpart of metacache_tpu/db/build.py::WindowBatcher, with the same
    batch size and the same one-batch-in-flight flush order."""

    def __init__(self, params: SketchParams, triples, device: torch.device,
                 batch_size: int = BUILD_WINDOW_BATCH):
        self.p = params
        self.triples = triples
        self.device = device
        self.batch_size = batch_size
        # the packed sketch takes rows of a multiple of 8 characters
        width = -(-params.window_size // 8) * 8
        self._codes = np.full((batch_size, width), encode.AMBIG_CODE,
                              np.uint8)
        self._lens = np.zeros(batch_size, np.int32)
        self._tgt = np.zeros(batch_size, np.int32)
        self._win = np.zeros(batch_size, np.int32)
        self._n = 0
        self._pending = None   # the batch in flight on the device

    def add_sequence(self, seq_codes: np.ndarray, target_id: int) -> int:
        """Queue all windows of one sequence; returns the window count,
        tail window included (for_each_window, src/dna_encoding.h:261-276)."""
        W, stride = self.p.window_size, self.p.window_stride
        L = len(seq_codes)
        starts = encode.window_starts(L, W, stride)
        n_win = len(starts)
        lens = np.minimum(L - starts, W).astype(np.int32)
        wins = np.full((n_win, W), encode.AMBIG_CODE, np.uint8)
        if L <= W:
            wins[0, :L] = seq_codes
        else:
            sv = np.lib.stride_tricks.sliding_window_view(seq_codes, W)
            full = lens == W
            wins[full] = sv[starts[full]]
            for i in np.nonzero(~full)[0]:   # at most the tail window
                wins[i, :lens[i]] = seq_codes[starts[i]:starts[i] + lens[i]]
        wi = 0
        while wi < n_win:
            take = min(self.batch_size - self._n, n_win - wi)
            sl = slice(self._n, self._n + take)
            self._codes[sl, :W] = wins[wi:wi + take]
            self._lens[sl] = lens[wi:wi + take]
            self._tgt[sl] = target_id
            self._win[sl] = np.arange(wi, wi + take, dtype=np.int32)
            self._n += take
            wi += take
            if self._n == self.batch_size:
                self.flush()
        return n_win

    def flush(self):
        """Dispatch the current batch; drain the previous one (one batch
        in flight overlaps device sketching with host packing)."""
        pending = None
        if self._n:
            packed, ambig = encode.np_pack_codes(self._codes)
            sk = sketch_packed(
                torch.from_numpy(packed).to(self.device),
                torch.from_numpy(ambig).to(self.device),
                torch.from_numpy(self._lens.copy()).to(self.device),
                k=self.p.kmer_size, sketch_size=self.p.sketch_size,
                window_size=self.p.window_size, starts=(0,))
            pending = (sk, self._n, self._tgt[:self._n].copy(),
                       self._win[:self._n].copy())
            self._n = 0
        if self._pending is not None:
            self._drain(*self._pending)
        self._pending = pending

    def finish(self):
        self.flush()
        if self._pending is not None:
            self._drain(*self._pending)
            self._pending = None

    def _drain(self, sk_dev, n, tgt, win):
        sk = sk_dev[:n].cpu().numpy()
        valid = sk != int(FEATURE_SENTINEL)
        counts = valid.sum(axis=1)
        self.triples.add(sk[valid].astype(np.uint32),
                         np.repeat(tgt, counts).astype(np.int32),
                         np.repeat(win, counts).astype(np.int32))


@dataclasses.dataclass
class BuildOptions:
    """mode_build options (src/mode_build.cpp:63-138)."""
    params: BuildParams = dataclasses.field(default_factory=BuildParams)
    taxonomy_nodes: str = ""
    taxonomy_names: str = ""
    taxonomy_merged: str = ""
    # post-build accession -> taxid mapping files
    taxpostmap: Tuple[str, ...] = ()
    reset_parents: bool = False
    # silent | moderate | verbose (io_options.h:32)
    info_level: str = "moderate"
    # cuda: the card path; cpu: the native host path (both sketch the
    # WindowBatcher's files on this device)
    device: str = "cuda"


def gather_input_files(infiles: Sequence[str], max_depth: int = 10
                       ) -> List[str]:
    """Expand directories recursively (depth 10, docs/build.txt:12) and
    sort: all shards must agree on the target order."""
    out: List[str] = []
    for f in infiles:
        if os.path.isdir(f):
            for root, dirs, files in os.walk(f):
                if root[len(f):].count(os.sep) >= max_depth:
                    dirs[:] = []
                    continue
                out.extend(os.path.join(root, name) for name in files)
        else:
            out.append(f)
    return sorted(out)


def resolve_parent_taxid(header: str, seq2taxid: Dict[str, int],
                         taxonomy: Taxonomy) -> int:
    """Parent taxid of a sequence from its header: an embedded taxid, else
    the accession(.version) or first word looked up in the mapping files
    (mode_build.cpp:300-380)."""
    tid = sequence_io.extract_taxon_id(header)
    if tid and taxonomy.node_of_id(tid):
        return tid
    for key in (sequence_io.extract_ncbi_accession_version(header),
                sequence_io.extract_ncbi_accession(header),
                header.split(" ")[0] if header else ""):
        if key and key in seq2taxid:
            return seq2taxid[key]
    return NONE_TAXID


def _sequence_id(header: str) -> str:
    """A record's sequence id: its accession, else its first word."""
    return sequence_io.extract_accession_string(header) \
        or header.split(" ")[0] or header


def _native_ids(res, seen_names: set) -> Optional[List[str]]:
    """Sequence ids of a natively sketched file's records, or None if a
    record is empty or repeats an id: the native pass numbered the records
    up front, so such a file takes the WindowBatcher path, which skips
    those records and renumbers the rest."""
    sids: List[str] = []
    in_file: set = set()
    for i, header in enumerate(res.headers):
        sid = _sequence_id(header)
        if res.seq_lens[i] == 0 or sid in seen_names or sid in in_file:
            return None
        sids.append(sid)
        in_file.add(sid)
    return sids


def _register_targets(path: str, headers: List[str], windows, sids: List[str],
                      taxonomy: Taxonomy, target_nodes: List[int],
                      seen_names: set, seq2taxid: Dict[str, int],
                      progress) -> None:
    """Add one sequence-level taxon per record of a file the native or the
    card path took (taxid -(t+1), src/sketch_database.h:149-150)."""
    for i, (header, sid) in enumerate(zip(headers, sids)):
        seen_names.add(sid)
        tgt = len(target_nodes)
        parent = resolve_parent_taxid(header, seq2taxid, taxonomy)
        node = taxonomy.add_node(
            -(tgt + 1), parent if parent else NONE_TAXID, sid,
            Rank.SEQUENCE, source_filename=path, source_index=i + 1,
            source_windows=int(windows[i]))
        target_nodes.append(node)
        if progress:
            progress(path, tgt)


def _sketch_natively(path: str, p: SketchParams, num_shards: int,
                     sorters: Dict[int, ChunkedTripleSorter],
                     taxonomy: Taxonomy, target_nodes: List[int],
                     seen_names: set, seq2taxid: Dict[str, int], progress,
                     spill_dir) -> bool:
    """Native parse + sketch of one file in ONE pass for every built
    shard (the keys of `sorters`): in RAM, or spilling feature-sorted
    per-shard chunk files for a large one (spill_dir() makes the
    directory). Returns False, having added nothing, when the file holds
    records the native pass cannot number; raises FormatError, having
    added nothing (and deleted its chunks), when its content is bad."""
    t0 = len(target_nodes)
    spill = os.path.getsize(path) >= SPILL_MIN_BYTES
    if spill:
        res = native.sketch_file_spill(
            path, p.kmer_size, p.sketch_size, p.window_size,
            p.window_stride, t0=t0, num_shards=num_shards,
            shard_ids=list(sorters), chunk_triples=CHUNK_TRIPLES,
            prefix=os.path.join(spill_dir(), f"t{t0}"))
    else:
        res = native.sketch_file(path, p.kmer_size, p.sketch_size,
                                 p.window_size, p.window_stride, t0=t0)
    if res is None:
        raise OSError(f"can't read file {path}")
    sids = _native_ids(res, seen_names)
    if sids is None:
        if spill:
            for _, cpath, _ in res.chunks:
                os.unlink(cpath)
        return False
    if spill:
        for s, sorter in sorters.items():
            mine = [(cpath, cnt) for sh, cpath, cnt in res.chunks if sh == s]
            if mine:
                sorter.adopt_chunks(mine)
    elif num_shards == 1:
        sorters[0].add(res.feat, res.tgt, res.win)
    else:   # target t belongs to shard t % num_shards
        owner = res.tgt % np.int32(num_shards)
        for s, sorter in sorters.items():
            sel = owner == s
            if sel.any():
                sorter.add(res.feat[sel], res.tgt[sel], res.win[sel])
    _register_targets(path, res.headers, res.seq_windows, sids, taxonomy,
                      target_nodes, seen_names, seq2taxid, progress)
    return True


def sketch_records(path: str, batcher, taxonomy: Taxonomy,
                   target_nodes: List[int], seen_names: set,
                   seq2taxid: Dict[str, int], progress) -> None:
    """The WindowBatcher path for one file (the JAX build's per-record
    loop): records parsed in Python, empty records and repeated ids
    skipped, the rest numbered in order; `batcher(t)` is the batcher of
    target t's shard, None for a shard that is not built (the target is
    numbered but not sketched)."""
    for rec in sequence_io.read_sequences(path):
        sid = _sequence_id(rec.header)
        if not rec.data or sid in seen_names:
            continue
        seen_names.add(sid)
        tgt = len(target_nodes)
        parent = resolve_parent_taxid(rec.header, seq2taxid, taxonomy)
        windows = 0
        b = batcher(tgt)
        if b is not None:
            codes = encode.np_encode_bytes(
                np.frombuffer(rec.data.encode(), dtype=np.uint8))
            windows = b.add_sequence(codes, tgt)
        node = taxonomy.add_node(
            -(tgt + 1), parent if parent else NONE_TAXID, sid,
            Rank.SEQUENCE, source_filename=path, source_index=rec.index,
            source_windows=windows)
        target_nodes.append(node)
        if progress:
            progress(path, tgt)


def _num_windows(lens: np.ndarray, window: int, stride: int) -> np.ndarray:
    """Windows of each sequence length, tail window included
    (encode.window_starts)."""
    lens = np.asarray(lens, np.int64)
    full = np.maximum(lens - window, 0) // stride + 1
    return np.where(lens <= window, 1, full + (full * stride < lens))


class CardBuild:
    """The card path: a DeviceTripleStore for each built shard, the record
    stream's two pinned buffers and the thread that parses into them."""

    def __init__(self, p: SketchParams, num_shards: int,
                 shard_ids: Sequence[int], device: torch.device,
                 store_triples: int, spill_dir, log=None):
        self.p = p
        self.num_shards = num_shards
        self.device = device
        self.cuda = device.type == "cuda"
        staging = Staging(device)
        self.stores = {s: DeviceTripleStore(s, device, store_triples,
                                            spill_dir, staging, log)
                       for s in shard_ids}
        self.bufs = [self._buffer(BATCH_BYTES) for _ in range(2)]
        self.copied: List[Optional[torch.cuda.Event]] = [None, None]
        self.parser = ThreadPoolExecutor(1)

    def _buffer(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.cuda)

    def _parse(self, stream: native.RecordStream, i: int):
        """The next batch into buffer i (grown for a longer record)."""
        while True:
            try:
                return stream.next_batch(self.bufs[i].numpy())
            except native.RecordTooLarge as e:
                self.bufs[i] = self._buffer(e.need)

    def add_file(self, path: str, t0: int, seen_names: set):
        """Stream one file into the stores. Returns (headers, sequence
        ids, windows) of all its records, or None, having added nothing,
        when a record is empty or repeats an id (the WindowBatcher path
        takes the file); raises FormatError, having added nothing (its
        chunk files deleted), when its content is bad. The parse of the
        next batch overlaps this batch's upload and sketch."""
        stream = native.RecordStream(path)
        for st in self.stores.values():
            st.mark()
        headers: List[str] = []
        sids: List[str] = []
        lens: List[np.ndarray] = []
        in_file: set = set()
        numbered = True
        pending = None
        try:
            pending = self.parser.submit(self._parse, stream, 0)
            turn = 0
            while True:
                batch = pending.result()
                pending = None
                if batch is None:
                    break
                for header, n in zip(batch.headers, batch.lens):
                    sid = _sequence_id(header)
                    numbered = numbered and n > 0 \
                        and sid not in seen_names and sid not in in_file
                    in_file.add(sid)
                    sids.append(sid)
                if numbered:   # else only the rest of the parse is left
                    seq = self.bufs[turn][:batch.nbytes]
                    if self.cuda:
                        seq = seq.to(self.device, non_blocking=True)
                        self.copied[turn] = torch.cuda.Event()
                        self.copied[turn].record()
                    else:
                        seq = seq.clone()
                turn ^= 1
                if self.copied[turn] is not None:
                    self.copied[turn].synchronize()
                pending = self.parser.submit(self._parse, stream, turn)
                if numbered:
                    self.add_batch(seq, batch, t0 + len(headers))
                headers += batch.headers
                lens.append(batch.lens)
        except BaseException:
            for st in self.stores.values():
                st.rollback()
            raise
        finally:
            if pending is not None:
                try:
                    pending.result()
                except Exception:
                    pass
            stream.close()
        for st in self.stores.values():
            if numbered:
                st.commit()
            else:
                st.rollback()
        if not numbered:
            return None
        lens_all = np.concatenate(lens) if lens else np.zeros(0, np.int64)
        return headers, sids, _num_windows(lens_all, self.p.window_size,
                                           self.p.window_stride)

    def add_batch(self, seq: torch.Tensor, batch: native.RecordBatch,
                  t0: int) -> None:
        """Sketch every window of the batch's records (targets t0, t0+1,
        ...) on the device and append each shard's triples to its store,
        in record, window, feature order."""
        p = self.p
        tgt = t0 + np.arange(len(batch.lens))
        nwin = _num_windows(batch.lens, p.window_size, p.window_stride)
        for s, store in self.stores.items():
            mine = tgt % self.num_shards == s
            if not mine.any():
                continue
            win_off = np.zeros(int(mine.sum()) + 1, np.int64)
            np.cumsum(nwin[mine], out=win_off[1:])
            host = dict(rec_off=batch.offsets[mine], rec_len=batch.lens[mine],
                        win_off=win_off,
                        win_tgt=np.repeat(tgt[mine], nwin[mine]).astype(
                            np.int32),
                        win_idx=(np.arange(win_off[-1])
                                 - np.repeat(win_off[:-1], nwin[mine])
                                 ).astype(np.int32))
            d = {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                 for k, v in host.items()}
            sk = sketch_windows(seq, d["rec_off"], d["rec_len"],
                                d["win_off"], n_windows=int(win_off[-1]),
                                k=p.kmer_size,
                                sketch_size=p.sketch_size,
                                window_size=p.window_size,
                                stride=p.window_stride)
            valid = sk != -1
            f = sk[valid]
            counts = valid.sum(dim=1)
            n = f.numel()
            store.add(f, torch.repeat_interleave(d["win_tgt"], counts,
                                                 output_size=n),
                      torch.repeat_interleave(d["win_idx"], counts,
                                              output_size=n))

    def finalize(self, cap: int) -> Dict[int, FeatureTable]:
        """Each store's table: those that never spilled built on the
        device one after another, the spilled ones merged natively on host
        threads meanwhile."""
        fts: Dict[int, FeatureTable] = {}
        spilled = [s for s, st in self.stores.items() if st.chunks]
        with ThreadPoolExecutor(min(4, max(1, len(spilled)))) as pool:
            merges = {}
            for s in spilled:
                self.stores[s].finalize(cap)
                merges[s] = pool.submit(self.stores[s].merge_spilled, cap)
            for s, st in self.stores.items():
                if s not in merges:
                    fts[s] = st.finalize(cap)
            for s, fut in merges.items():
                fts[s] = fut.result()
        return {s: fts[s] for s in self.stores}

    def close(self) -> None:
        self.parser.shutdown()


def store_budget(device: torch.device, n_stores: int) -> int:
    """Triples each device store may hold: DEVICE_SHARE of the card's free
    memory now, shared with the other ranks on this card, over the
    stores and one shard's finalize; on the CPU, CHUNK_TRIPLES."""
    if device.type != "cuda":
        return CHUNK_TRIPLES
    free, _ = torch.cuda.mem_get_info(device)
    ranks_here = math.ceil(distributed.world_size()
                           / torch.cuda.device_count())
    return int(DEVICE_SHARE * free / ranks_here
               / (STORE_BYTES * n_stores + FINALIZE_BYTES))


def build_database_shards(infiles: Sequence[str], opt: BuildOptions,
                          num_shards: int = 1,
                          shard_ids: Optional[Sequence[int]] = None,
                          progress=None) -> List[Database]:
    """Build shards in ONE pass over the inputs
    (src/mode_build.cpp:1145-1175, :797-843). Target t belongs to shard
    t % num_shards; shard_ids are the shards to build (default: all), and
    only those get sorters and batchers. Every target is numbered either
    way. Returns one Database per built shard, in shard_ids order.
    opt.device cuda takes the card path (raises without a card), cpu the
    native host path."""
    device = resolve_device(opt.device)
    if device.type == "cuda":
        return build_shards_on_card(infiles, opt, device, num_shards,
                                    shard_ids, progress)
    return _build_shards(infiles, opt, num_shards, shard_ids, progress,
                         device, None)


def build_shards_on_card(infiles: Sequence[str], opt: BuildOptions,
                         device: torch.device, num_shards: int = 1,
                         shard_ids: Optional[Sequence[int]] = None,
                         progress=None,
                         store_triples: Optional[int] = None
                         ) -> List[Database]:
    """The card path on `device` (the CPU runs its functions with the
    kernels' plain versions). store_triples: each shard store's budget
    (default store_budget)."""
    shard_ids = list(range(num_shards)) if shard_ids is None \
        else list(shard_ids)
    if store_triples is None:
        store_triples = store_budget(device, len(shard_ids))
    return _build_shards(infiles, opt, num_shards, shard_ids, progress,
                         device, store_triples)


def _build_shards(infiles: Sequence[str], opt: BuildOptions,
                  num_shards: int, shard_ids: Optional[Sequence[int]],
                  progress, device: torch.device,
                  store_triples: Optional[int]) -> List[Database]:
    """Both paths: the card path's stores when store_triples is given,
    else the host path's sorters."""
    shard_ids = list(range(num_shards)) if shard_ids is None \
        else list(shard_ids)
    p = opt.params.sketch
    native.load_mcio()   # the native library: raises if it cannot be built

    taxonomy = taxonomy_io.make_taxonomic_hierarchy(
        opt.taxonomy_nodes, opt.taxonomy_names, opt.taxonomy_merged) \
        if opt.taxonomy_nodes else Taxonomy()
    if not taxonomy.node_of_id(1):
        taxonomy.add_node(1, 1, "root", Rank.ROOT)

    files = gather_input_files(infiles)
    seq2taxid = taxonomy_io.make_sequence_to_taxon_id_map(
        SEQUENCE_ID_MAPPINGS, files)
    target_nodes: List[int] = []
    seen_names: set = set()
    spill: List[str] = []

    def spill_dir() -> str:
        if not spill:
            spill.append(tempfile.mkdtemp(prefix="mc_spill_"))
        return spill[0]

    card = None
    if store_triples is not None:
        card = CardBuild(p, num_shards, shard_ids, device, store_triples,
                         spill_dir, print if opt.info_level == "verbose"
                         else None)
        sinks = card.stores
    else:
        sinks = {s: ChunkedTripleSorter(chunk_triples=CHUNK_TRIPLES)
                 for s in shard_ids}
    batchers: Dict[int, WindowBatcher] = {}

    def batcher(tgt: int) -> Optional[WindowBatcher]:
        s = tgt % num_shards
        if s not in sinks:
            return None
        if s not in batchers:
            batchers[s] = WindowBatcher(p, sinks[s], device)
        return batchers[s]

    def on_card(path: str) -> bool:
        got = card.add_file(path, len(target_nodes), seen_names)
        if got is None:
            return False
        headers, sids, windows = got
        _register_targets(path, headers, windows, sids, taxonomy,
                          target_nodes, seen_names, seq2taxid, progress)
        return True

    try:
        for path in files:
            try:
                if p.sketch_size <= NATIVE_MAX_SKETCH and (
                        on_card(path) if card else _sketch_natively(
                            path, p, num_shards, sinks, taxonomy,
                            target_nodes, seen_names, seq2taxid, progress,
                            spill_dir)):
                    continue
                sketch_records(path, batcher, taxonomy, target_nodes,
                               seen_names, seq2taxid, progress)
            except sequence_io.FormatError as e:
                print(f"FAIL: {path}: {e}")
        for b in batchers.values():
            b.finish()

        if opt.taxpostmap:
            post_map: Dict[str, int] = {}
            for mf in opt.taxpostmap:
                taxonomy_io.read_sequence_to_taxon_id_mapping(mf, post_map)
            rank_unranked_targets(taxonomy, target_nodes, post_map,
                                  reset_parents=opt.reset_parents,
                                  info_level=opt.info_level)

        cap = opt.params.max_locations_per_feature
        if card:
            fts = card.finalize(cap)
        else:
            # the shards' native merges at once, as the JAX build does
            with ThreadPoolExecutor(min(4, len(sinks) or 1)) as pool:
                fts = dict(zip(sinks, pool.map(
                    lambda sorter: sorter.finalize(cap), sinks.values())))
    finally:
        if card:
            card.close()
        for d in spill:
            shutil.rmtree(d, ignore_errors=True)

    target_arr = np.array(target_nodes, dtype=np.int32)
    dbs: List[Database] = []
    for s in shard_ids:
        db = Database(
            sketch_params=p, query_sketch_params=p,
            max_locations_per_feature=opt.params.max_locations_per_feature,
            taxonomy=_shard_taxonomy_view(taxonomy, target_arr, num_shards,
                                          s),
            target_taxon_node=target_arr,
            features=fts[s], num_shards=num_shards, shard_id=s)
        if opt.params.remove_ambig_features_rank:
            r = rank_from_name(opt.params.remove_ambig_features_rank)
            if r != Rank.NONE:
                db.remove_ambiguous_features(r,
                                             opt.params.max_taxa_per_feature)
        dbs.append(db)
    return dbs


def _shard_taxonomy_view(taxonomy: Taxonomy, target_nodes: np.ndarray,
                         num_shards: int, shard_id: int):
    """Per-shard taxonomy: identical nodes, but source windows only for the
    shard's own targets (as a per-shard build records them)."""
    if num_shards == 1:
        return taxonomy
    import copy as _copy
    t = _copy.copy(taxonomy)
    sw = taxonomy.source_windows.copy()
    sw[target_nodes[np.arange(len(target_nodes)) % num_shards
                    != shard_id]] = 0
    t._src_windows = sw
    return t


def rank_unranked_targets(taxonomy: Taxonomy, target_nodes: List[int],
                          mapping: Dict[str, int],
                          reset_parents: bool = False,
                          info_level: str = "moderate"):
    """Attach parents to sequence-level taxa from accession -> taxid maps
    (try_to_rank_unranked_targets, mode_build.cpp:414-539); with
    reset_parents every target is re-ranked."""
    notify = info_level != "silent"
    todo = [n for n in target_nodes
            if reset_parents or taxonomy.parent_taxid[n] == NONE_TAXID]
    if todo and notify:
        print(f"{len(todo)} targets are unranked.")
    changed = False
    for node in todo:
        name = taxonomy.names[node]
        for key in (name,
                    sequence_io.extract_ncbi_accession_version(name),
                    sequence_io.extract_ncbi_accession(name)):
            if key and key in mapping:
                taxonomy.parent_taxid[node] = mapping[key]
                changed = True
                break
    if changed:
        taxonomy.invalidate_caches()
    if notify:
        remaining = [n for n in target_nodes
                     if taxonomy.parent_taxid[n] == NONE_TAXID]
        if not remaining:
            print("All targets are ranked.")
        else:
            print(f"{len(remaining)} targets remain unranked."
                  f"{taxonomy.names[remaining[0]]}")


def merge_shard_feature_counts(shard_tables: Iterable[FeatureTable]
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Global (sorted feature keys, location counts) across shards — the
    host-side analogue of the reference's count tree merge
    (mode_build.cpp:865-1024)."""
    keys, counts = [np.zeros(0, np.uint32)], [np.zeros(0, np.int64)]
    for ft in shard_tables:
        k, c = ft.feature_counts()
        keys.append(np.asarray(k, dtype=np.uint32))
        counts.append(np.asarray(c, dtype=np.int64))
    return merge_feature_count_arrays(np.concatenate(keys),
                                      np.concatenate(counts))


def merge_feature_count_arrays(keys: np.ndarray, counts: np.ndarray
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenated (key, count) dumps -> unique sorted keys with summed
    counts."""
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv, weights=counts,
                       minlength=len(uniq)).astype(np.int64)
    return uniq.astype(np.uint32), sums
