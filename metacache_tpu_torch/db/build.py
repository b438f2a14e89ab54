"""Database build: FASTA/FASTQ genomes -> sketches -> feature table.

Counterpart of metacache_tpu/db/build.py (add_to_database,
src/mode_build.cpp:559-843). Two paths, as in the JAX build:
  * the native C++ pass (libmcio: mcio_sketch_file, or
    mcio_sketch_file_spill for large files) parses and sketches a whole
    file; its sketches are bit-identical to the device sketch;
  * the WindowBatcher: records parsed in Python, their windows packed into
    fixed-shape batches and sketched on the device by the port's sketch
    (the CUDA kernel on `cuda`, its plain version on the CPU). It takes
    the files the native pass cannot number (an empty record or a repeated
    sequence id: those records are skipped and the rest renumbered) and
    every file when the sketch size exceeds the native sketcher's 64.
Triples go to the JAX package's external sorter, in the JAX build's order,
so the shard files are the JAX package's, array for array.

A file in no known format or with a malformed record is reported on
stdout as `FAIL: <path>: <error>` and left out, as the JAX build (and
mode_build.cpp:630-643) does: the whole file on the native paths, the
records after the bad one on the WindowBatcher path.

Differences from the JAX build, on purpose:
  * if libmcio cannot load, the build raises (no all-Python build);
  * a spill chunk that cannot be written ends the build (OSError) instead
    of leaving the file out.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from .. import native
from ..config import FEATURE_SENTINEL, BuildParams, SketchParams
from ..device import resolve_device
from ..io import sequence_io, taxonomy_io
from ..ops import encode
from ..ops.sketch_cuda import sketch_packed
from .database import Database
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
    # where the WindowBatcher path sketches (cuda | cpu); resolved only
    # when a file takes that path
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


def _native_ids(res, seen_names: set) -> Optional[List[str]]:
    """Sequence ids of a natively sketched file's records, or None if a
    record is empty or repeats an id: the native pass numbered the records
    up front, so such a file takes the WindowBatcher path, which skips
    those records and renumbers the rest."""
    sids: List[str] = []
    in_file: set = set()
    for i, header in enumerate(res.headers):
        sid = sequence_io.extract_accession_string(header) \
            or header.split(" ")[0] or header
        if res.seq_lens[i] == 0 or sid in seen_names or sid in in_file:
            return None
        sids.append(sid)
        in_file.add(sid)
    return sids


def _register_targets(path: str, res, sids: List[str], taxonomy: Taxonomy,
                      target_nodes: List[int], seen_names: set,
                      seq2taxid: Dict[str, int], progress) -> None:
    """Add one sequence-level taxon per record of a natively sketched file
    (taxid -(t+1), src/sketch_database.h:149-150)."""
    for i, (header, sid) in enumerate(zip(res.headers, sids)):
        seen_names.add(sid)
        tgt = len(target_nodes)
        parent = resolve_parent_taxid(header, seq2taxid, taxonomy)
        node = taxonomy.add_node(
            -(tgt + 1), parent if parent else NONE_TAXID, sid,
            Rank.SEQUENCE, source_filename=path, source_index=i + 1,
            source_windows=int(res.seq_windows[i]))
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
    _register_targets(path, res, sids, taxonomy, target_nodes, seen_names,
                      seq2taxid, progress)
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
        sid = sequence_io.extract_accession_string(rec.header) \
            or rec.header.split(" ")[0] or rec.header
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


def build_database_shards(infiles: Sequence[str], opt: BuildOptions,
                          num_shards: int = 1,
                          shard_ids: Optional[Sequence[int]] = None,
                          progress=None) -> List[Database]:
    """Build shards in ONE pass over the inputs
    (src/mode_build.cpp:1145-1175, :797-843). Target t belongs to shard
    t % num_shards; shard_ids are the shards to build (default: all), and
    only those get sorters and batchers. Every target is numbered either
    way. Returns one Database per built shard, in shard_ids order."""
    shard_ids = list(range(num_shards)) if shard_ids is None \
        else list(shard_ids)
    p = opt.params.sketch
    native.load_mcio()   # the native sketcher: raises if it cannot be built

    taxonomy = taxonomy_io.make_taxonomic_hierarchy(
        opt.taxonomy_nodes, opt.taxonomy_names, opt.taxonomy_merged) \
        if opt.taxonomy_nodes else Taxonomy()
    if not taxonomy.node_of_id(1):
        taxonomy.add_node(1, 1, "root", Rank.ROOT)

    files = gather_input_files(infiles)
    seq2taxid = taxonomy_io.make_sequence_to_taxon_id_map(
        SEQUENCE_ID_MAPPINGS, files)
    sorters = {s: ChunkedTripleSorter(chunk_triples=CHUNK_TRIPLES)
               for s in shard_ids}
    batchers: Dict[int, WindowBatcher] = {}

    def batcher(tgt: int) -> Optional[WindowBatcher]:
        s = tgt % num_shards
        if s not in sorters:
            return None
        if s not in batchers:
            batchers[s] = WindowBatcher(p, sorters[s],
                                        resolve_device(opt.device))
        return batchers[s]

    target_nodes: List[int] = []
    seen_names: set = set()
    spill: List[str] = []

    def spill_dir() -> str:
        if not spill:
            spill.append(tempfile.mkdtemp(prefix="mc_spill_"))
        return spill[0]

    try:
        for path in files:
            try:
                if p.sketch_size <= NATIVE_MAX_SKETCH and _sketch_natively(
                        path, p, num_shards, sorters, taxonomy, target_nodes,
                        seen_names, seq2taxid, progress, spill_dir):
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

        fts = {s: sorter.finalize(opt.params.max_locations_per_feature)
               for s, sorter in sorters.items()}
    finally:
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
