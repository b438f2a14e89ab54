"""Query mode: load database shard(s), classify read files, write output.

Counterpart of metacache_tpu/modes/query.py (main_mode_query +
process_input_files, src/mode_query.cpp:55-455): the native reader
feeding packed batches to the port's engine in dispatch windows (the
Python reader for -align, which needs each read's sequence), -pairfiles
or single-end input, -out / -splitout / stdout, clade exclusion
(-exclude), -hits-per-seq, -align, the epilogue (hits per target,
abundances, summary) and the interactive mode (no read files on the
command line). The options and output lines are the JAX package's.

Without -mesh the shards are fused into one table on one device. With
-mesh each shard keeps its own tables (parallel/sharding.py): shard s on
card s % device count, or, under the MC_* launch, the shards s % P == r
on rank r's card; only rank 0 writes results.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import struct
import sys
import threading
import zipfile
from typing import Dict, List, Optional, TextIO

import numpy as np
import torch

from metacache_tpu import native
from metacache_tpu.config import ClassifyParams, QueryPipelineParams
from metacache_tpu.db.database import Database, shard_path
from metacache_tpu.db.feature_table import FeatureTable
from metacache_tpu.db.taxonomy import Rank, rank_from_name
from metacache_tpu.io import sequence_io
from metacache_tpu.query import abundance as abundance_mod
from metacache_tpu.query import output as out_mod
from metacache_tpu.query.stats import ClassificationStatistics
from metacache_tpu.utils import ArgsParser, Timer

from ..device import resolve_device
from ..parallel import ShardedQueryEngine, distributed
from ..query.engine import QueryEngine, encode_read_into, tables_from_database

#: batches per dispatch window: window k is formatted while k+1 computes
WINDOW = 8


@dataclasses.dataclass
class EvaluationOptions:
    """(src/query_options.h:144-154)"""
    precision: bool = False
    taxon_coverage: bool = False
    exclude_rank: int = Rank.NONE
    determine_ground_truth: bool = False


@dataclasses.dataclass
class QueryModeOptions:
    pairing: str = "none"               # none | files | sequences
    query_limit: int = -1
    # echoed in the query-parameters block (query_options.h:106)
    num_threads: int = os.cpu_count() or 1
    classify: ClassifyParams = dataclasses.field(default_factory=ClassifyParams)
    evaluate: EvaluationOptions = dataclasses.field(
        default_factory=EvaluationOptions)
    output: out_mod.OutputOptions = dataclasses.field(
        default_factory=out_mod.OutputOptions)
    pipeline: QueryPipelineParams = dataclasses.field(
        default_factory=QueryPipelineParams)
    # query-time database tuning (src/query_options.cpp:41-66)
    max_locations_per_feature: int = -1
    remove_overpopulated_features: bool = False
    db_sketch_len: int = -1
    db_win_len: int = -1
    db_win_stride: int = -1


def get_query_options(args: ArgsParser, device: torch.device
                      ) -> QueryModeOptions:
    """Flag harvesting mirroring get_query_options
    (src/query_options.cpp:41-387), same flag aliases. On the CPU the
    pipeline defaults are the JAX package's CPU shapes (batch 512, 1024
    match slots), so both CLIs truncate match lists alike."""
    opt = QueryModeOptions()

    if args.contains("pairfiles") or args.contains(
            ["pair-files", "pair_files", "paired_files", "paired-files"]):
        opt.pairing = "files"
    elif args.contains(["pairseq", "pair-seq", "pair_seq", "paired_seq",
                        "paired-seq"]):
        opt.pairing = "sequences"

    opt.query_limit = args.get(["query-limit", "query_limit"], -1, int)
    threads = args.get("threads", 0, int)
    if threads >= 1:
        opt.num_threads = threads

    c = opt.classify
    lowest_rank = c.lowest_rank
    lowest = args.get("lowest", "")
    if lowest:
        r = rank_from_name(lowest)
        if r < Rank.ROOT:
            lowest_rank = r
    highest_rank = c.highest_rank
    highest = args.get("highest", "")
    if highest:
        r = rank_from_name(highest)
        if r <= Rank.ROOT:
            highest_rank = r
    lowest_code = _code(lowest_rank)
    highest_code = _code(highest_rank)
    if lowest_code > highest_code:
        lowest_code = highest_code
    hitsdiff = args.get(["hitdiff", "hit-diff", "hit_diff", "hitsdiff",
                         "hits-diff", "hits_diff"], None, float)
    if hitsdiff is not None:
        # percentages > 1 are divided by 100 (query_options.cpp:166-172)
        if hitsdiff > 1:
            hitsdiff /= 100.0
        hitsdiff = max(hitsdiff, 0.0)
    else:
        hitsdiff = c.hits_diff_fraction
    opt.classify = ClassifyParams(
        lowest_rank=lowest_code,
        highest_rank=highest_code,
        hits_min=args.get(["hitmin", "hit-min", "hit_min", "hitsmin",
                           "hits-min", "hits_min"], c.hits_min, int),
        hits_diff_fraction=hitsdiff,
        insert_size_max=args.get(["insertsize", "insert-size", "insert_size"],
                                 c.insert_size_max, int),
        max_candidates=args.get(["maxcand", "max-cand", "max_cand"],
                                c.max_candidates, int))

    e = opt.evaluate
    e.precision = args.contains("precision") \
        or args.contains(["taxon-coverage", "taxon_coverage"])
    e.taxon_coverage = args.contains(["taxon-coverage", "taxon_coverage"])
    e.determine_ground_truth = args.contains(
        ["ground-truth", "ground_truth", "groundtruth"])
    excl = args.get(["exclude", "exclude-rank", "exclude_rank"], "")
    if excl:
        e.exclude_rank = rank_from_name(excl)
    if e.exclude_rank != Rank.NONE:
        e.determine_ground_truth = True

    # query-time database tuning (src/query_options.cpp:47-61)
    opt.max_locations_per_feature = args.get(
        ["max-locations-per-feature", "max_locations_per_feature"],
        opt.max_locations_per_feature, int)
    opt.remove_overpopulated_features = args.contains(
        ["remove-overpopulated-features", "remove_overpopulated_features"])
    opt.db_sketch_len = args.get("sketchlen", opt.db_sketch_len, int)
    opt.db_win_len = args.get("winlen", opt.db_win_len, int)
    opt.db_win_stride = args.get(
        "winstride", opt.db_win_len if opt.db_win_len > 0
        else opt.db_win_stride, int)

    o = opt.output
    o.format.comment = args.get("comment", o.format.comment)
    o.format.column = args.get("separator", o.format.column)
    if args.contains(["separate-cols", "separatecols", "separate_cols",
                      "separate-columns", "separatecolumns",
                      "separate_columns"]):
        # rank/name/taxid into separate columns (query_options.cpp:235-247)
        o.collapse_unclassified = False
        o.format.tax_separator = o.format.column
        o.format.rank_suffix = o.format.column
        o.format.taxid_prefix = o.format.column
        o.format.taxid_suffix = ""
    o.show_query_ids = args.contains(["queryids", "query-ids", "query_ids"])
    o.lowest_rank = opt.classify.lowest_rank
    o.highest_rank = _code(opt.classify.highest_rank)
    o.show_lineage = args.contains("lineage")
    o.show_locations = args.contains("locations")
    o.show_top_hits = args.contains(["tophits", "top-hits", "top_hits"])
    o.show_all_hits = args.contains(["allhits", "all-hits", "all_hits"])
    show_ranks = not args.contains(["omit-ranks", "omitranks", "omit_ranks"])
    if args.contains(["taxidsonly", "taxids-only", "taxids_only",
                      "taxid-only", "taxid_only"]):
        o.show_taxa_as = out_mod.TaxonPrintMode.RANK_ID if show_ranks \
            else out_mod.TaxonPrintMode.ID
    elif args.contains(["taxids", "taxid"]):
        o.show_taxa_as = out_mod.TaxonPrintMode.RANK_NAME_ID if show_ranks \
            else out_mod.TaxonPrintMode.NAME_ID
    else:
        o.show_taxa_as = out_mod.TaxonPrintMode.RANK_NAME if show_ranks \
            else out_mod.TaxonPrintMode.NAME
    if args.contains(["nomap", "no-map", "no_map"]):
        o.map_view_mode = out_mod.MapViewMode.NONE
    elif args.contains(["mapped-only", "mapped_only", "mappedonly"]):
        o.map_view_mode = out_mod.MapViewMode.MAPPED_ONLY
    elif o.show_all_hits:
        o.map_view_mode = out_mod.MapViewMode.ALL
    o.show_ground_truth = e.determine_ground_truth
    o.show_alignment = args.contains(
        ["align", "alignment", "showalignment", "showalign", "show-align",
         "show_align"])
    hps = ["hits-per-seq", "hitsperseq", "hits_per_seq", "hits-per-sequence",
           "hitspersequence", "hits_per_sequence"]
    o.show_hits_per_target_list = args.contains(hps)
    o.targets_file = args.get(hps, o.targets_file) or ""
    o.show_query_ids = o.show_query_ids or o.show_hits_per_target_list

    o.show_tax_abundances = args.contains("abundances")
    o.abundance_file = args.get("abundances", o.abundance_file) or ""
    est = args.get(["abundance-per", "abundances-per", "abundance_per",
                    "abundances_per"], "")
    if est:
        r = rank_from_name(est)
        if r != Rank.NONE and r <= Rank.ROOT:
            o.abundance_estimates_rank = r
    o.make_tax_counts = o.show_tax_abundances or \
        o.abundance_estimates_rank != Rank.NONE

    # info-level flags (query_options.cpp:325-341, io_options.h:32)
    verbose = args.contains("verbose")
    o.show_db_properties = o.show_db_properties or verbose
    o.show_query_params = (o.show_query_params or verbose) and \
        not args.contains(["no-query-params", "noqueryparams",
                           "no_query_params"])
    o.show_summary = (o.show_summary or verbose) and \
        not args.contains(["no-summary", "nosummary", "no_summary"])
    o.show_errors = o.show_errors and \
        not args.contains(["noerr", "noerrors"])

    o.query_mappings_file = args.get("out", o.query_mappings_file) or ""
    if not o.query_mappings_file:
        split = args.get(["splitout", "split-out"], "")
        if split:
            o.split_files = True
            o.query_mappings_file = split

    if device.type == "cpu":
        opt.pipeline = dataclasses.replace(
            opt.pipeline, batch_size=512, max_locations_per_query=1024)
    for names, field in ((["batch-size", "batch_size"], "batch_size"),
                         (["max-locations-per-query",
                           "max_locations_per_query"],
                          "max_locations_per_query"),
                         (["max-query-len", "max_query_len"],
                          "max_query_len")):
        v = args.get(names, None, int)
        if v:
            opt.pipeline = dataclasses.replace(opt.pipeline, **{field: v})
    return opt


def _code(rank) -> int:
    return rank if isinstance(rank, int) else rank_from_name(rank)


def _window_k(opt: QueryModeOptions) -> int:
    """Window hit counts per candidate that -hits-per-seq reports."""
    return 16 if opt.output.show_hits_per_target_list else 0


# ---------------------------------------------------------------------------
FEATURE_ARRAYS = ("keys", "offsets", "loc_tgt", "loc_win")


def npz_memmap(path: str, names) -> Optional[Dict[str, np.ndarray]]:
    """Read-only memmaps of uncompressed members of an npz, located with
    NumPy's public .npy header readers (the port's counterpart of
    Database._npz_memmap, metacache_tpu/db/database.py:160-197, which calls
    a NumPy-private parser). Shard files are written uncompressed, so each
    member is a raw .npy at a fixed offset inside the zip. Returns None if
    a member is compressed or not a plain C-order array: the caller then
    reads the arrays whole."""
    from numpy.lib import format as npfmt
    readers = {(1, 0): npfmt.read_array_header_1_0,
               (2, 0): npfmt.read_array_header_2_0}
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
        for name in names:
            info = zf.getinfo(name + ".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                return None
            fh.seek(info.header_offset)
            local = fh.read(30)
            if local[:4] != b"PK\x03\x04":
                return None
            fnlen, extralen = struct.unpack("<HH", local[26:30])
            fh.seek(info.header_offset + 30 + fnlen + extralen)
            read = readers.get(npfmt.read_magic(fh))
            if read is None:
                return None
            shape, fortran, dtype = read(fh)
            if fortran or dtype.hasobject:
                return None
            if int(np.prod(shape)) == 0:
                out[name] = np.zeros(shape, dtype)
            else:
                out[name] = np.memmap(path, dtype=dtype, mode="r",
                                      offset=fh.tell(), shape=shape)
    return out


def load_shard(dbname: str, s: int) -> Database:
    """One shard with its feature table memory-mapped (a whole read only
    for compressed members): the tables stay in evictable file-backed
    pages until they are uploaded or merged."""
    mm = npz_memmap(shard_path(dbname, s), FEATURE_ARRAYS)
    if mm is None:
        return Database.load(dbname, s)
    db = Database.load(dbname, s, metadata_only=True)
    db.features = FeatureTable(**mm)
    return db


def count_shards(dbname: str) -> int:
    """Number of consecutive shard files '<dbname>_<s>.npz' from s = 0."""
    n = 0
    while os.path.exists(shard_path(dbname, n)):
        n += 1
    return n


def load_all_shards(dbname: str) -> Database:
    """Load every '<dbname>_<s>.npz' shard, feature tables memory-mapped
    (load_shard), and fuse their feature tables for single-device
    querying."""
    n = count_shards(dbname)
    if not n:
        raise FileNotFoundError(f"can't open file {shard_path(dbname, 0)}")
    shards = [load_shard(dbname, s) for s in range(n)]
    db = shards[0]
    if len(shards) > 1:
        db.features = FeatureTable.concat_shards([d.features for d in shards])
        db.num_shards = 1
        db.shard_id = 0
    return db


def ground_truth_node(db: Database, header: str) -> int:
    """(classification.cpp:111-131)"""
    t = db.taxonomy
    name2node: Optional[Dict[str, int]] = getattr(db, "_name2node", None)
    if name2node is None:
        name2node = {}
        for node in range(1, len(t)):
            if t.rank[node] == Rank.SEQUENCE:
                name2node.setdefault(t.names[node], node)
        db._name2node = name2node
    acc = sequence_io.extract_ncbi_accession_version(header)
    node = name2node.get(acc, 0)
    if node:
        return t.next_ranked_ancestor(node)
    accs = sequence_io.extract_ncbi_accession(header)
    if accs:
        for name, n in name2node.items():
            if accs in name:
                return t.next_ranked_ancestor(n)
    tid = sequence_io.extract_taxon_id(header)
    if tid:
        n = t.node_of_id(tid)
        if n:
            return t.next_ranked_ancestor(n)
    node = name2node.get(header, 0)
    if node:
        return t.next_ranked_ancestor(node)
    return 0


class QueryProcessor:
    """Streams read files through the engine, formats output and
    accumulates statistics / abundances / hits per target — the host half
    of the query."""

    def __init__(self, db: Database, opt: QueryModeOptions,
                 engine: QueryEngine):
        self.db = db
        self.opt = opt
        self.engine = engine
        self.exclusion = opt.evaluate.exclude_rank != Rank.NONE
        if self.exclusion:
            engine.set_exclusion(opt.evaluate.exclude_rank)
        self.stats = ClassificationStatistics()
        self.tax_counts: Dict[int, float] = {}
        self.total_overflow = 0
        # target node -> [(qid, [(win, hits), ...]), ...]
        self.target_matches: Dict[int, List] = {}
        self._seq_cache: Dict[str, List[str]] = {}
        self._taxstr: Dict[int, int] = {}    # node -> index into the table
        self._taxstr_list: List[bytes] = []

    def _load_target_sequence(self, filename: str, index: int) -> str:
        """Record #index (1-based) of a reference file, each file read once
        (-align re-reads the sources, classification.cpp:447-453)."""
        if filename not in self._seq_cache:
            self._seq_cache[filename] = [
                r.data for r in sequence_io.read_sequences(filename)]
        seqs = self._seq_cache[filename]
        return seqs[index - 1] if 0 < index <= len(seqs) else ""

    def process_files(self, infiles: List[str], out: TextIO):
        timer = Timer()
        timer.start()
        # the parameters echo precedes the table header in result files
        # (mode_query.cpp:119-121)
        if self.opt.output.show_query_params:
            out_mod.show_query_parameters(out, self.opt)
        if self.opt.output.map_view_mode != out_mod.MapViewMode.NONE:
            out_mod.show_query_mapping_header(out, self.opt.output)
        cmt = self.opt.output.format.comment
        if self.opt.pairing == "files":
            infiles = sorted(infiles)
            for f1, f2 in zip(infiles[0::2], infiles[1::2]):
                # input-file announcement (querying.h:1337)
                out.write(f"{cmt}{f1} + {f2}\n")
                self._process_one(f1, f2, out)
        else:
            for f in infiles:
                out.write(f"{cmt}{f}\n")
                self._process_one(f, None, out)
        timer.stop()
        self.time_ms = timer.milliseconds()

    def _process_one(self, f1: str, f2: Optional[str], out: TextIO):
        # -align needs every read's sequence: the Python reader keeps it
        if self.opt.output.show_alignment:
            self._process_one_python(f1, f2, out)
        else:
            self._process_one_native(f1, f2, out)

    def _exclusion_groups(self, headers):
        """Ground-truth nodes of a batch's reads and the exclusion group of
        each ([batch_size] int64), or (None, None) without -exclude."""
        if not self.exclusion:
            return None, None
        gts = [ground_truth_node(self.db, h) for h in headers]
        groups = np.zeros(self.opt.pipeline.batch_size, np.int64)
        for i, g in enumerate(gts):
            groups[i] = self.engine.exclusion_group_of(g)
        return gts, groups

    def _process_one_native(self, f1: str, f2: Optional[str], out: TextIO):
        """Native reader -> engine, in dispatch windows: WINDOW batches are
        dispatched before the previous window is materialized and
        formatted, so host formatting overlaps device compute. A reader
        thread parses ahead (the native parse releases the GIL)."""
        if native.load_mcio() is None:
            raise RuntimeError("the native reader (libmcio) could not be "
                               "loaded or built")
        reader = native.NativeBatchReader(
            f1, f2, self.opt.pairing, self.opt.pipeline.batch_size,
            self.opt.pipeline.max_query_len,
            limit=self.opt.query_limit if self.opt.query_limit > 0 else -1)
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def _feed():
            try:
                for batch in reader:
                    if stop.is_set():
                        return
                    q.put(batch)
                q.put(None)
            except BaseException as e:   # raised again by the consumer
                q.put(e)

        feeder = threading.Thread(target=_feed, daemon=True)
        feeder.start()
        try:
            windows: List[list] = []
            pending: list = []
            while True:
                b = q.get()
                if isinstance(b, BaseException):
                    raise b
                if b is None:
                    break
                gts, groups = self._exclusion_groups(b.headers)
                dev = self.engine.dispatch_packed(
                    b.packed1, b.ambig1, b.lens1, b.packed2, b.ambig2,
                    b.lens2, exclude_groups=groups)
                pending.append((dev, b.n, b, gts))
                if len(pending) >= WINDOW:
                    windows.append(pending)
                    pending = []
                    if len(windows) == 2:
                        self._finalize_window(windows.pop(0), out)
            if pending:
                windows.append(pending)
            for w in windows:
                self._finalize_window(w, out)
        finally:
            # a consumer that raised must not leave the reader thread
            # blocked on a full queue
            stop.set()
            while feeder.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            feeder.join()

    def _finalize_window(self, window, out: TextIO):
        results = self.engine.materialize_many(
            [(dev, n) for dev, n, _, _ in window])
        for res, (_, n, meta, gts) in zip(results, window):
            self._postprocess(res, n, meta, gts, out)

    def _process_one_python(self, f1: str, f2: Optional[str], out: TextIO):
        """Python reader (sequence_io) -> engine, one batch at a time; each
        read's sequences ride along for the -align display."""
        B = self.opt.pipeline.batch_size
        L = self.opt.pipeline.max_query_len
        c1, l1, c2, l2 = self.engine.make_host_buffers()
        meta: List[tuple] = []   # (query id, header, seq1, seq2)
        limit = self.opt.query_limit
        count = 0
        for r1, r2 in sequence_io.read_sequence_pairs(f1, f2,
                                                      self.opt.pairing):
            if limit > 0 and count >= limit:
                break
            count += 1
            if r1.empty:
                continue
            n = len(meta)
            encode_read_into(c1, l1, n, r1.data, L)
            if r2 is not None and r2.data:
                encode_read_into(c2, l2, n, r2.data, L)
            else:
                l2[n] = 0
            meta.append((r1.index, r1.header, r1.data,
                         r2.data if r2 is not None else ""))
            if len(meta) == B:
                self._emit(c1, l1, c2, l2, meta, out)
                c1[:] = 0
                l1[:] = 0
                c2[:] = 0
                l2[:] = 0
                meta = []
        if meta:
            self._emit(c1, l1, c2, l2, meta, out)

    def _emit(self, c1, l1, c2, l2, meta, out: TextIO):
        gts, groups = self._exclusion_groups([m[1] for m in meta])
        res = self.engine.classify_batch(c1, l1, c2, l2, len(meta),
                                         exclude_groups=groups)
        self._postprocess(res, len(meta), meta, gts, out)

    def _postprocess(self, res, n: int, meta, gts, out: TextIO):
        """meta: a native batch, or [(query id, header, seq1, seq2), ...]
        from the Python reader; gts: ground-truth nodes (with -exclude)."""
        # count READS whose match list was truncated at lmax
        self.total_overflow += int((res.match_overflow[:n] > 0).sum())
        if self._fast_path_ok():
            self._postprocess_fast_native(res, n, meta, out)
            return
        db, opt = self.db, self.opt
        ev, o = opt.evaluate, opt.output
        if isinstance(meta, list):
            qids = [m[0] for m in meta]
            headers = [m[1] for m in meta]
        else:
            qids = meta.indices.tolist()
            headers = meta.headers
        need_cand = (o.show_top_hits or o.show_all_hits or o.show_locations
                     or o.show_alignment or o.show_hits_per_target_list)
        none = np.zeros(0, np.int32)
        for i in range(n):
            header = headers[i]
            best = int(res.best[i])
            best_rank = int(res.best_rank[i])
            if gts is not None:
                gt = gts[i]
            elif ev.precision or ev.determine_ground_truth:
                gt = ground_truth_node(db, header)
            else:
                gt = 0
            if ev.precision:
                lca = db.taxonomy.ranked_lca_node(best, gt)
                self.stats.assign_known_correct(
                    best_rank,
                    int(db.taxonomy.rank[gt]) if gt else Rank.NONE,
                    int(db.taxonomy.rank[lca]) if lca else Rank.NONE)
                if ev.taxon_coverage and gt:
                    self._update_coverage(gt, best, best_rank)
            else:
                self.stats.assign(best_rank)
            if o.make_tax_counts and best:
                self.tax_counts[best] = self.tax_counts.get(best, 0) + 1
            if o.show_hits_per_target_list:
                self._collect_target_matches(res, i, qids[i])
            suffix = ""
            if o.show_alignment and best:
                suffix = out_mod.alignment_suffix_str(
                    db, o, meta[i][2], meta[i][3], res.cand_tax[i],
                    res.cand_beg[i], res.cand_end[i],
                    self._load_target_sequence)
            out_mod.show_query_mapping(
                out, db, o, qids[i], header, gt, best,
                res.cand_tax[i] if need_cand else none,
                res.cand_hits[i] if need_cand else none,
                res.cand_beg[i] if need_cand else none,
                res.cand_end[i] if need_cand else none,
                alignment_suffix=suffix)

    def _collect_target_matches(self, res, i: int, qid: int):
        """matches_per_target::insert (src/matches_per_target.h:111-155):
        sequence-level candidates with >= hitsMin hits contribute their
        window hit lists."""
        tax = self.db.taxonomy
        hits_min = self.engine.hits_min
        twh = res.target_window_hits
        for c in range(res.cand_tax.shape[1]):
            node = int(res.cand_tax[i, c])
            if node == 0 or res.cand_hits[i, c] < hits_min \
                    or tax.rank[node] != Rank.SEQUENCE:
                continue
            beg = int(res.cand_beg[i, c])
            wins = [(beg + k, int(h)) for k, h in enumerate(twh[i, c])
                    if h > 0]
            if wins:
                self.target_matches.setdefault(node, []).append((qid, wins))

    def _update_coverage(self, gt: int, best: int, best_rank: int):
        """-taxon-coverage confusion counting per ground-truth lineage rank
        (update_coverage_statistics, src/classification.cpp:294-327)."""
        t = self.db.taxonomy
        lin = t.ranked_lineage[gt]
        covered = t.covered_mask
        for r in range(Rank.NUM_RANKS):
            node = int(lin[r])
            if node == 0:
                continue
            rr = int(t.rank[node])
            unclassified_on_rank = best == 0 or rr < best_rank
            if covered[node]:
                if unclassified_on_rank:
                    self.stats.count_coverage_false_neg(rr)
                else:
                    self.stats.count_coverage_true_pos(rr)
            elif unclassified_on_rank:
                self.stats.count_coverage_true_neg(rr)
            else:
                self.stats.count_coverage_false_pos(rr)

    def _fast_path_ok(self) -> bool:
        """True when per-read work is only statistics, taxon counts and
        the default mapping line: then a batch is formatted by one native
        pass instead of a per-read Python loop (JAX _fast_path_ok)."""
        o, ev = self.opt.output, self.opt.evaluate
        return (not ev.precision and not ev.determine_ground_truth
                and ev.exclude_rank == Rank.NONE
                and not o.show_hits_per_target_list
                and not o.show_alignment and not o.show_top_hits
                and not o.show_all_hits and not o.show_locations
                and not o.show_ground_truth)

    def _postprocess_fast_native(self, res, n: int, batch, out: TextIO):
        """Default output: mapping lines built by ONE native pass over the
        raw header bytes and a table of taxon strings
        (mcio_format_lines)."""
        o = self.opt.output
        best = res.best[:n]
        if o.map_view_mode != out_mod.MapViewMode.NONE:
            for nd in np.unique(best).tolist():
                if nd not in self._taxstr:
                    self._taxstr[nd] = len(self._taxstr_list)
                    self._taxstr_list.append(out_mod.show_taxon_str(
                        self.db, o, int(nd)).encode())
            lens = np.fromiter((len(x) for x in self._taxstr_list),
                               np.int64, len(self._taxstr_list))
            soff = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=soff[1:])
            sidx = np.fromiter((self._taxstr[nd] for nd in best.tolist()),
                               np.int64, n)
            if o.map_view_mode == out_mod.MapViewMode.MAPPED_ONLY:
                sidx = np.where(best == 0, np.int64(-1), sidx)
            buf = native.format_mapping_lines(
                batch.hdr_buf, batch.hdr_off[:n + 1], sidx,
                b"".join(self._taxstr_list), soff,
                o.format.column.encode(),
                batch.indices[:n] if o.show_query_ids else None)
            if buf is None:
                raise RuntimeError("native mapping-line formatter failed")
            out.write(buf.decode("utf-8", "replace"))
        self.stats.assign_batch(res.best_rank[:n])
        if o.make_tax_counts:
            nodes, cnts = np.unique(best[best != 0], return_counts=True)
            for nd, ct in zip(nodes.tolist(), cnts.tolist()):
                self.tax_counts[nd] = self.tax_counts.get(nd, 0) + ct

    def write_epilogue(self, out: TextIO, abundance_out: TextIO):
        o = self.opt.output
        if o.show_hits_per_target_list:
            if o.targets_file and o.targets_file != o.query_mappings_file:
                with open(o.targets_file, "w") as target_out:
                    out_mod.show_matches_per_targets(
                        target_out, self.db, self.target_matches, o)
            else:
                out_mod.show_matches_per_targets(
                    out, self.db, self.target_matches, o)
        if o.show_tax_abundances:
            out_mod.show_abundances(
                abundance_out, self.db,
                abundance_mod.sorted_counts(self.db.taxonomy, self.tax_counts),
                self.stats.total(), o)
        if o.abundance_estimates_rank != Rank.NONE:
            est = abundance_mod.estimate_abundance(
                self.db.taxonomy, self.tax_counts, o.abundance_estimates_rank)
            out_mod.show_abundance_estimates(
                abundance_out, self.db,
                abundance_mod.sorted_counts(self.db.taxonomy, est),
                self.stats.total(), o)
        if o.show_summary:
            out_mod.show_summary(out, o, self.stats, self.time_ms,
                                 self.opt.pairing != "none")
        if self.total_overflow:
            # the one documented fixed-shape divergence (ops/lookup.py), on
            # stderr so result files keep byte parity with the reference
            print(f"WARNING: match-list overflow on {self.total_overflow} "
                  f"queries — hit counts may be underreported; rerun with a "
                  f"larger -max-locations-per-query", file=sys.stderr)


def main_mode_query(args: ArgsParser) -> int:
    if len(args.positionals) < 2:
        print("usage: metacache query <database> [<reads>...] OPTIONS",
              file=sys.stderr)
        return 1
    device = resolve_device(args.get("device", "cuda"))
    dbname = args.positionals[1]
    infiles = _expand_files(args.positionals[2:])
    if not infiles:
        return run_interactive_query_mode(dbname, args, device)
    opt = get_query_options(args, device)

    engine = None
    if args.contains("mesh"):
        engine, db = _mesh_engine(dbname, opt, device)
    if engine is None:
        db = load_all_shards(dbname)
        _apply_database_tuning(opt, db)
        _adapt_options_to_database(opt, db)
    if not distributed.is_writer():
        # only rank 0 writes results (querying.h:1088-1136)
        o = opt.output
        o.query_mappings_file, o.split_files = os.devnull, False
        o.abundance_file = o.targets_file = ""
    if opt.output.show_db_properties:
        from metacache_tpu.db.database import (print_content_properties,
                                               print_static_properties)
        print_static_properties(db)
        print_content_properties(db)
    # ONE engine (the database on the device) serves every output group
    if engine is None:
        engine = QueryEngine(db, opt.classify, opt.pipeline, device=device,
                             target_window_k=_window_k(opt))

    if opt.output.split_files and opt.output.query_mappings_file:
        # one output (and statistics) per input file / file pair
        # (mode_query.cpp:55-143)
        prefix = opt.output.query_mappings_file
        step = 2 if opt.pairing == "files" else 1
        files = sorted(infiles) if opt.pairing == "files" else infiles
        for i in range(0, len(files), step):
            group = files[i:i + step]
            proc = QueryProcessor(db, opt, engine)
            with open(prefix + "_" + os.path.basename(group[0]), "w") as out:
                proc.process_files(group, out)
                proc.write_epilogue(out, out)
        return 0

    proc = QueryProcessor(db, opt, engine)
    outfile = opt.output.query_mappings_file
    if not outfile:
        proc.process_files(infiles, sys.stdout)
        proc.write_epilogue(sys.stdout, sys.stdout)
        return 0
    with open(outfile, "w") as out:
        proc.process_files(infiles, out)
        abf = opt.output.abundance_file
        if abf and abf != outfile:
            with open(abf, "w") as ab:
                proc.write_epilogue(out, ab)
        else:
            proc.write_epilogue(out, out)
    return 0


def _mesh_engine(dbname: str, opt: QueryModeOptions, device: torch.device):
    """-mesh (JAX modes/query.py:803-837): this rank's shards, memory-
    mapped, tuned one by one, each with its own device tables ->
    (ShardedQueryEngine, the first of them), or (None, None) to run fused
    when there are fewer than two shards or fewer shards than ranks."""
    n = count_shards(dbname)
    world = distributed.world_size()
    if n < max(2, world):
        print(f"-mesh: {n} shard(s) for {world} rank(s); falling back to "
              f"fused single-device query", file=sys.stderr)
        return None, None
    mine = distributed.local_shard_ids(n)
    shards = [load_shard(dbname, s) for s in mine]
    for sh in shards:   # per-rank tuning (mode_query.cpp:354-388)
        _apply_database_tuning(opt, sh)
    _adapt_options_to_database(opt, shards[0])
    devices = distributed.place_shards(mine, device.type)
    print("-mesh: " + ", ".join(f"shard {s} on {d}"
                                for s, d in zip(mine, devices)),
          file=sys.stderr)
    return ShardedQueryEngine(shards, opt.classify, opt.pipeline, devices,
                              target_window_k=_window_k(opt)), shards[0]


def run_interactive_query_mode(dbname: str, init_args: ArgsParser,
                               device: torch.device) -> int:
    """Read-eval loop over one loaded database
    (run_interactive_query_mode, src/mode_query.cpp:269-315; JAX
    modes/query.py:902-961): each stdin line holds read files and query
    options; an empty line, ':q' or end of input ends it.

    Engines are cached by the options that shape their batch program; a
    line that changes only -hitmin / -hitdiff reuses its engine. The device
    tables depend only on the lowest rank, so they are uploaded once per
    distinct lowest rank and shared by the engines. Database tuning flags
    apply once, from the initial command line; every line runs on the
    initial command line's -device. As in the JAX package, a line's -mesh
    is ignored: every line runs on the fused database."""
    db = load_all_shards(dbname)
    _apply_database_tuning(get_query_options(init_args, device), db)
    init_argv = ["query", dbname]
    engines: Dict[tuple, QueryEngine] = {}
    tables: Dict[int, Dict[str, torch.Tensor]] = {}
    while True:
        try:
            line = input("$> ")
        except EOFError:
            print("Terminate.")
            return 0
        if not line or line.startswith(":q"):
            print("Terminate.")
            return 0
        if line.startswith("#"):
            continue
        args = ArgsParser(init_argv + line.split())
        files = _expand_files(args.positionals[2:])
        opt = get_query_options(args, device)
        _adapt_options_to_database(opt, db)
        if opt.pairing == "files":
            files = sorted(files)
        try:
            c = opt.classify
            key = (c.lowest_rank, c.highest_rank, c.insert_size_max,
                   c.max_candidates, dataclasses.astuple(opt.pipeline),
                   _window_k(opt))
            engine = engines.get(key)
            if engine is None:
                if c.lowest_rank not in tables:
                    tables[c.lowest_rank] = tables_from_database(
                        db, device, c.lowest_rank,
                        like=next(iter(tables.values()), None))
                engine = QueryEngine(db, c, opt.pipeline, device=device,
                                     target_window_k=_window_k(opt),
                                     tables=tables[c.lowest_rank])
                engines[key] = engine
            else:
                engine.update_runtime_thresholds(c)
                print("(reusing loaded engine)", file=sys.stderr)
            proc = QueryProcessor(db, opt, engine)
            outfile = opt.output.query_mappings_file
            out = open(outfile, "w") if outfile else sys.stdout
            try:
                proc.process_files(files, out)
                proc.write_epilogue(out, out)
            finally:
                if outfile:
                    out.close()
        except Exception as e:   # a bad line must not end the session
            if opt.output.show_errors:
                print(e, file=sys.stderr)


def _expand_files(infiles: List[str]) -> List[str]:
    expanded: List[str] = []
    for f in infiles:
        if os.path.isdir(f):
            for root, _, files in os.walk(f):
                expanded.extend(os.path.join(root, x) for x in files)
        else:
            expanded.append(f)
    return expanded


def _apply_database_tuning(opt: QueryModeOptions, db: Database):
    """Query-time database re-parameterization (mode_query.cpp:354-388):
    -remove-overpopulated-features / -max-locations-per-feature apply
    maintenance at load; -sketchlen/-winlen/-winstride override the QUERY
    sketcher only."""
    if opt.remove_overpopulated_features:
        old = db.features.num_keys
        lim = Database.MAX_SUPPORTED_LOCS_PER_FEATURE
        maxlpf = opt.max_locations_per_feature - 1
        if maxlpf < 0 or maxlpf >= lim:
            maxlpf = lim - 1
        maxlpf = min(maxlpf, db.max_locations_per_feature - 1)
        if maxlpf > 0:  # always keep buckets with size 1
            print(f"\nRemoving features with more than {maxlpf} "
                  f"locations... ", file=sys.stderr, end="")
            rem = db.remove_overpopulated_features(maxlpf)
            print(f"{rem} of {old} removed.", file=sys.stderr)
        db.set_max_locations_per_feature(opt.max_locations_per_feature)
    elif opt.max_locations_per_feature > 1:
        db.set_max_locations_per_feature(opt.max_locations_per_feature)
        print(f"max locations per feature set to "
              f"{opt.max_locations_per_feature}", file=sys.stderr)
    qp = db.query_sketch_params
    if opt.db_win_len > 0:
        qp = dataclasses.replace(qp, window_size=opt.db_win_len)
    if opt.db_win_stride > 0:
        qp = dataclasses.replace(qp, window_stride=opt.db_win_stride)
    if opt.db_sketch_len > 0:
        qp = dataclasses.replace(qp, sketch_size=opt.db_sketch_len)
    db.query_sketch_params = qp


def _adapt_options_to_database(opt: QueryModeOptions, db: Database):
    """hitsMin deduced from the TARGET sketcher's sketch size
    (src/mode_query.cpp:247-260)."""
    opt.classify = dataclasses.replace(
        opt.classify,
        hits_min=opt.classify.resolved_hits_min(db.sketch_params.sketch_size))
