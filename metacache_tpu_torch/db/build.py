"""Database build: FASTA/FASTQ genomes -> sketches -> feature table.

Counterpart of metacache_tpu/db/build.py (add_to_database,
src/mode_build.cpp:559-843), native path only: every input file is parsed
and sketched by the native C++ pass (libmcio: mcio_sketch_file, or
mcio_sketch_file_spill for large files), whose sketches are bit-identical
to the device sketch, and triples go to the JAX package's external sorter.
The shard files are the JAX package's, array for array.

Differences from the JAX build, on purpose:
  * there is no fallback: if libmcio cannot load, or a file holds records
    the native pass cannot number (empty sequences, duplicate ids — the
    JAX package sketches those through its device WindowBatcher, not yet
    ported), the build raises;
  * a file that cannot be read or parsed aborts the build instead of being
    reported and silently left out of the database.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from metacache_tpu import native
from metacache_tpu.config import BuildParams, SketchParams
from metacache_tpu.db.database import Database
from metacache_tpu.db.feature_table import ChunkedTripleSorter, FeatureTable
from metacache_tpu.db.taxonomy import NONE_TAXID, Rank, Taxonomy
from metacache_tpu.db.taxonomy import rank_from_name
from metacache_tpu.io import sequence_io, taxonomy_io

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


def _register_targets(path: str, res, taxonomy: Taxonomy,
                      target_nodes: List[int], seen_names: set,
                      seq2taxid: Dict[str, int], progress) -> None:
    """Add one sequence-level taxon per record of a natively sketched file
    (taxid -(t+1), src/sketch_database.h:149-150). The native pass numbered
    the records up front, so a record that would need renumbering is an
    error here."""
    sids = []
    in_file = set()
    for i, header in enumerate(res.headers):
        sid = sequence_io.extract_accession_string(header) \
            or header.split(" ")[0] or header
        if res.seq_lens[i] == 0 or sid in seen_names or sid in in_file:
            raise NotImplementedError(
                f"{path}: record {i + 1} is empty or repeats id '{sid}'; "
                "builds that skip records (the JAX package's WindowBatcher "
                "path) are not yet ported")
        sids.append(sid)
        in_file.add(sid)
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


def _sketch_in_ram(path: str, p: SketchParams, sorters: List, t0: int):
    """Native parse + sketch of one file with its triples in RAM, in ONE
    pass for every shard (target t belongs to shard t % num_shards)."""
    res = native.sketch_file(path, p.kmer_size, p.sketch_size,
                             p.window_size, p.window_stride, t0=t0)
    if res is None:
        raise OSError(f"can't read file {path}")
    if len(sorters) == 1:
        sorters[0].add(res.feat, res.tgt, res.win)
    else:
        owner = res.tgt % np.int32(len(sorters))
        for s, sorter in enumerate(sorters):
            sel = owner == s
            if sel.any():
                sorter.add(res.feat[sel], res.tgt[sel], res.win[sel])
    return res


def _sketch_spill(path: str, p: SketchParams, sorters: List, t0: int,
                  spill_dir: str):
    """Native parse + sketch of one LARGE file, spilling feature-sorted
    per-shard triple chunk files that the shards' sorters adopt."""
    res = native.sketch_file_spill(
        path, p.kmer_size, p.sketch_size, p.window_size, p.window_stride,
        t0=t0, num_shards=len(sorters), shard_ids=range(len(sorters)),
        chunk_triples=CHUNK_TRIPLES,
        prefix=os.path.join(spill_dir, f"t{t0}"))
    if res is None:
        raise OSError(f"can't read file {path}")
    for s in range(len(sorters)):
        mine = [(cpath, cnt) for sh, cpath, cnt in res.chunks if sh == s]
        if mine:
            sorters[s].adopt_chunks(mine)
    return res


def build_database_shards(infiles: Sequence[str], opt: BuildOptions,
                          num_shards: int = 1,
                          progress=None) -> List[Database]:
    """Build all shards in ONE pass over the inputs
    (src/mode_build.cpp:1145-1175, :797-843). Target t belongs to shard
    t % num_shards. Returns one Database per shard, in shard order."""
    p = opt.params.sketch
    if native.load_mcio() is None:
        raise RuntimeError("the native sketcher (libmcio) could not be "
                           "loaded or built; the port has no other build "
                           "path")
    if p.sketch_size > NATIVE_MAX_SKETCH:
        raise NotImplementedError(
            f"sketch size {p.sketch_size} > {NATIVE_MAX_SKETCH} needs the "
            "WindowBatcher build path, which is not yet ported")

    taxonomy = taxonomy_io.make_taxonomic_hierarchy(
        opt.taxonomy_nodes, opt.taxonomy_names, opt.taxonomy_merged) \
        if opt.taxonomy_nodes else Taxonomy()
    if not taxonomy.node_of_id(1):
        taxonomy.add_node(1, 1, "root", Rank.ROOT)

    files = gather_input_files(infiles)
    seq2taxid = taxonomy_io.make_sequence_to_taxon_id_map(
        SEQUENCE_ID_MAPPINGS, files)
    sorters = [ChunkedTripleSorter(chunk_triples=CHUNK_TRIPLES)
               for _ in range(num_shards)]
    target_nodes: List[int] = []
    seen_names: set = set()
    spill_dir: Optional[str] = None
    try:
        for path in files:
            t0 = len(target_nodes)
            if os.path.getsize(path) >= SPILL_MIN_BYTES:
                if spill_dir is None:
                    spill_dir = tempfile.mkdtemp(prefix="mc_spill_")
                res = _sketch_spill(path, p, sorters, t0, spill_dir)
            else:
                res = _sketch_in_ram(path, p, sorters, t0)
            _register_targets(path, res, taxonomy, target_nodes, seen_names,
                              seq2taxid, progress)

        if opt.taxpostmap:
            post_map: Dict[str, int] = {}
            for mf in opt.taxpostmap:
                taxonomy_io.read_sequence_to_taxon_id_mapping(mf, post_map)
            rank_unranked_targets(taxonomy, target_nodes, post_map,
                                  reset_parents=opt.reset_parents,
                                  info_level=opt.info_level)

        fts = [s.finalize(opt.params.max_locations_per_feature)
               for s in sorters]
    finally:
        if spill_dir is not None:
            shutil.rmtree(spill_dir, ignore_errors=True)

    target_arr = np.array(target_nodes, dtype=np.int32)
    dbs: List[Database] = []
    for s in range(num_shards):
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
    keys, counts = [], []
    for ft in shard_tables:
        k, c = ft.feature_counts()
        keys.append(np.asarray(k, dtype=np.uint32))
        counts.append(np.asarray(c, dtype=np.int64))
    if not keys:
        return np.zeros(0, np.uint32), np.zeros(0, np.int64)
    uniq, inv = np.unique(np.concatenate(keys), return_inverse=True)
    sums = np.bincount(inv, weights=np.concatenate(counts)).astype(np.int64)
    return uniq.astype(np.uint32), sums
