"""Database facade: sketching params + feature table + taxonomy + targets.

The TPU-native analogue of sketch_database (src/sketch_database.h:99-1242).
One Database object = one shard (the reference's per-rank database file
``<name>_<rank>``, src/mode_build.cpp:1079-1091). Taxonomy and target
metadata are fully replicated across shards (src/sketch_database.h:544-560);
only the feature table differs per shard (targets gated by
``t % num_shards == shard_id``, src/sketch_database.h:540).

Shard file format: a directory-free pair ``<name>_<shard>.npz`` holding the
flat arrays plus a JSON header with version / dtype-width / parameter checks
mirroring the reference's self-describing binary format
(src/sketch_database.h:858-999, MC_DB_VERSION at src/version.h:29).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import (DB_FORMAT_VERSION, MAX_SUPPORTED_LOCS_PER_FEATURE,
                      SketchParams)
from .feature_table import FeatureTable
from .taxonomy import NONE_TAXID, Rank, Taxonomy

#: the CSR feature table's arrays in a shard file
FEATURE_ARRAYS = ("keys", "offsets", "loc_tgt", "loc_win")
#: SketchParams' fields, as a shard file's header names them
SKETCH_FIELDS = ("kmer_size", "sketch_size", "window_size", "window_stride")


class IncompatibleDatabaseError(RuntimeError):
    pass


@dataclasses.dataclass
class Database:
    sketch_params: SketchParams
    query_sketch_params: SketchParams
    max_locations_per_feature: int
    taxonomy: Taxonomy
    # targets: parallel arrays indexed by target id
    target_taxon_node: np.ndarray        # [T] int32 node index of seq-level taxon
    features: FeatureTable = dataclasses.field(default_factory=FeatureTable.empty)
    num_shards: int = 1
    shard_id: int = 0

    # ------------------------------------------------------------------ props
    @property
    def target_count(self) -> int:
        return len(self.target_taxon_node)

    def target_name(self, tgt: int) -> str:
        return self.taxonomy.names[self.target_taxon_node[tgt]]

    def taxon_of_target(self, tgt: int) -> int:
        return int(self.target_taxon_node[tgt])

    # ------------------------------------------------------------- query prep
    def target_cand_tax(self, lowest_rank: int) -> np.ndarray:
        """[T+1] map target -> candidate taxon node for candidate merging:
        ancestor at `lowest_rank` if present, else the target's own
        sequence-level taxon (candidates.h:242-244 mergeBelow). The final
        slot is scratch for the sentinel target."""
        out = np.zeros(self.target_count + 1, dtype=np.int32)
        if self.target_count == 0:
            return out
        nodes = self.target_taxon_node
        if lowest_rank > Rank.SEQUENCE:
            anc = self.taxonomy.ranked_lineage[nodes, lowest_rank]
            out[:-1] = np.where(anc != 0, anc, nodes)
        else:
            out[:-1] = nodes
        return out

    # ------------------------------------------------------------ maintenance
    def remove_overpopulated_features(self, max_locs: int,
                                      global_counts=None) -> int:
        """Remove features whose (global) location count exceeds max_locs.

        With `global_counts` (a `(keys, counts)` array pair merged across
        shards, the analogue of the reference's log2(P) count tree-merge at
        mode_build.cpp:865-1069), removal uses the global count; otherwise
        the local one."""
        if global_counts is not None:
            gkeys, gcounts = global_counts
            keys = np.asarray(gkeys, dtype=np.uint32)[
                np.asarray(gcounts) > max_locs]
            self.features, removed = self.features.remove_keys(keys)
        else:
            self.features, removed = self.features.remove_overpopulated(max_locs)
        return removed

    #: uint8 location-list size type minus the fill slot
    #: (max_supported_locations_per_feature, src/sketch_database.h:375-378)
    MAX_SUPPORTED_LOCS_PER_FEATURE = 254

    def set_max_locations_per_feature(self, n: int) -> None:
        """Re-set the per-feature location cap, shrinking existing buckets
        when lowered — the reference's query-time DB tuning entry point
        (sketch_database::max_locations_per_feature(n),
        src/sketch_database.h:356-368; applied from mode_query.cpp:371-378).
        n < 0 mirrors the reference's unsigned wrap: clamps to the
        supported maximum."""
        lim = Database.MAX_SUPPORTED_LOCS_PER_FEATURE
        if n < 0 or n >= lim:
            n = lim
        elif n < 1:
            n = 1
        if n < self.max_locations_per_feature:
            self.features = self.features.cap_locations(n)
        self.max_locations_per_feature = n

    def remove_ambiguous_features(self, rank: int, max_ambig: int) -> int:
        if len(self.taxonomy) <= 1:
            raise RuntimeError("no taxonomy available!")
        if rank == Rank.SEQUENCE:
            groups = np.arange(self.target_count, dtype=np.int32)
        else:
            groups = self.taxonomy.ranked_lineage[
                self.target_taxon_node, rank].astype(np.int32)
        self.features, removed = self.features.remove_ambiguous(
            groups, max_ambig)
        return removed

    # -------------------------------------------------------------- save/load
    def save(self, basename: str) -> str:
        """Write this shard to '<basename>_<shard_id>.npz'
        (naming mirrors mode_build.cpp:1079-1091)."""
        path = shard_path(basename, self.shard_id)
        header = {
            "format_version": DB_FORMAT_VERSION,
            "feature_dtype": "uint32",
            "target_dtype": "int32",
            "window_dtype": "int32",
            "num_tax_ranks": Rank.NUM_RANKS,
            "kmer_size": self.sketch_params.kmer_size,
            "sketch_size": self.sketch_params.sketch_size,
            "window_size": self.sketch_params.window_size,
            "window_stride": self.sketch_params.window_stride,
            "query_kmer_size": self.query_sketch_params.kmer_size,
            "query_sketch_size": self.query_sketch_params.sketch_size,
            "query_window_size": self.query_sketch_params.window_size,
            "query_window_stride": self.query_sketch_params.window_stride,
            "max_locations_per_feature": self.max_locations_per_feature,
            "num_shards": self.num_shards,
            "shard_id": self.shard_id,
            "target_count": self.target_count,
        }
        tax_arrays = {f"tax_{k}": v for k, v in
                      self.taxonomy.to_arrays().items()}
        # uncompressed: zlib costs seconds per 100 MB and dominates build
        # wall time on fast disks; the 2-bit-dense arrays barely compress
        np.savez(
            path,
            header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
            keys=self.features.keys,
            offsets=self.features.offsets,
            loc_tgt=self.features.loc_tgt,
            loc_win=self.features.loc_win,
            target_taxon_node=self.target_taxon_node,
            **tax_arrays,
        )
        return path

    @staticmethod
    def _npz_memmap(path: str, names):
        """Read-only memmap views over UNCOMPRESSED members of an npz.

        The shard files are written uncompressed (save()), so each member
        is a raw .npy at a fixed offset inside the zip; mapping them keeps
        multi-GB feature tables out of resident memory during the fused
        multi-shard load (config-3 query load peaked at 38 GB RSS in
        round 4 — pages of mapped tables are clean/evictable instead).
        Each member's header is read with NumPy's public .npy header
        readers. Returns None if a member is compressed or not a plain
        C-order array: the caller then reads the arrays whole.
        """
        import struct
        import zipfile
        from numpy.lib import format as npfmt
        readers = {(1, 0): npfmt.read_array_header_1_0,
                   (2, 0): npfmt.read_array_header_2_0}
        out = {}
        with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
            for name in names:
                info = zf.getinfo(name + ".npy")
                if info.compress_type != zipfile.ZIP_STORED:
                    return None  # compressed member: caller falls back
                fh.seek(info.header_offset)
                hdr = fh.read(30)
                if hdr[:4] != b"PK\x03\x04":
                    return None
                fnlen, extralen = struct.unpack("<HH", hdr[26:30])
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

    @classmethod
    def load(cls, basename: str, shard_id: int = 0,
             metadata_only: bool = False, mmap: bool = False) -> "Database":
        path = shard_path(basename, shard_id)
        if not os.path.exists(path):
            raise FileNotFoundError(f"can't open file {path}")
        with np.load(path, allow_pickle=True) as z:
            header = json.loads(bytes(z["header"]).decode())
            if header.get("format_version") != DB_FORMAT_VERSION:
                raise IncompatibleDatabaseError(
                    f"Database {path} (version {header.get('format_version')})"
                    f" is incompatible with this version of metacache-tpu"
                    f" (uses version {DB_FORMAT_VERSION})")
            if (header.get("feature_dtype") != "uint32"
                    or header.get("target_dtype") != "int32"
                    or header.get("window_dtype") != "int32"
                    or header.get("num_tax_ranks") != Rank.NUM_RANKS):
                raise IncompatibleDatabaseError(
                    f"Database {path} is incompatible with this variant of"
                    f" metacache-tpu due to different data type sizes")
            features = None
            if not metadata_only:
                features = cls._npz_memmap(path, FEATURE_ARRAYS) \
                    if mmap else None
                if features is None:
                    features = {k: z[k] for k in FEATURE_ARRAYS}
            return database_from_arrays(
                sketch=[header[k] for k in SKETCH_FIELDS],
                query_sketch=[header["query_" + k] for k in SKETCH_FIELDS],
                max_locations_per_feature=header["max_locations_per_feature"],
                taxonomy={k[4:]: z[k] for k in z.files
                          if k.startswith("tax_")},
                target_taxon_node=z["target_taxon_node"],
                features=features,
                num_shards=header["num_shards"], shard_id=header["shard_id"])

    # ------------------------------------------------------------------ info
    def properties(self) -> Dict:
        sizes = self.features.bucket_sizes()
        return {
            "targets": self.target_count,
            "taxa": len(self.taxonomy) - 1,
            "features": self.features.num_keys,
            "locations": self.features.num_locations,
            "max locations per feature": self.max_locations_per_feature,
            "kmer size": self.sketch_params.kmer_size,
            "sketch size": self.sketch_params.sketch_size,
            "window size": self.sketch_params.window_size,
            "window stride": self.sketch_params.window_stride,
            "mean bucket size": float(sizes.mean()) if len(sizes) else 0.0,
            "max bucket size": int(sizes.max()) if len(sizes) else 0,
            "shard": f"{self.shard_id}/{self.num_shards}",
        }


def database_from_arrays(*, sketch: Sequence[int],
                         query_sketch: Sequence[int],
                         max_locations_per_feature: int,
                         taxonomy: Dict[str, np.ndarray],
                         target_taxon_node: np.ndarray,
                         features: Optional[Dict[str, np.ndarray]] = None,
                         num_shards: int = 1,
                         shard_id: int = 0) -> Database:
    """A Database from plain numpy arrays and values, the contents of one
    shard file: `sketch` / `query_sketch` are (kmer_size, sketch_size,
    window_size, window_stride), `taxonomy` the arrays of
    Taxonomy.to_arrays(), `features` the CSR table's FEATURE_ARRAYS (None:
    an empty table)."""
    return Database(
        sketch_params=SketchParams(*(int(x) for x in sketch)),
        query_sketch_params=SketchParams(*(int(x) for x in query_sketch)),
        max_locations_per_feature=int(max_locations_per_feature),
        taxonomy=Taxonomy.from_arrays(taxonomy),
        target_taxon_node=np.asarray(target_taxon_node),
        features=FeatureTable.empty() if features is None
        else FeatureTable(**{k: features[k] for k in FEATURE_ARRAYS}),
        num_shards=int(num_shards), shard_id=int(shard_id))


def shard_path(basename: str, shard_id: int) -> str:
    if basename.endswith(".npz"):
        basename = basename[:-4]
    return f"{basename}_{shard_id}.npz"


def bucket_size_moments(sizes: np.ndarray):
    """(max, mean, stddev, skewness) of location-list sizes — the analogue
    of the reference's moments accumulator used for DB stats
    (src/stat_moments.h, consumed at src/sketch_database.h:1021-1032)."""
    if len(sizes) == 0:
        return 0, 0.0, 0.0, 0.0
    s = sizes.astype(np.float64)
    mean = float(s.mean())
    var = float(s.var())
    std = var ** 0.5
    skew = float(((s - mean) ** 3).mean() / (std ** 3)) if std > 0 else 0.0
    return int(s.max()), mean, std, skew


def print_static_properties(db: Database):
    """DB property echo, layout mirroring print_static_properties
    (src/sketch_database.h:1160-1195) with this framework's types."""
    sp = db.sketch_params
    print(
        "------------------------------------------------\n"
        f"database version     {DB_FORMAT_VERSION}\n"
        "------------------------------------------------\n"
        "sequence type        2-bit packed uint8 codes\n"
        "target id type       int32 32 bits\n"
        f"target limit         {2**31 - 1}\n"
        "------------------------------------------------\n"
        "window id type       int32 32 bits\n"
        f"window limit         {2**31 - 1}\n"
        f"window length        {sp.window_size}\n"
        f"window stride        {sp.window_stride}\n"
        "------------------------------------------------\n"
        "sketcher type        unique min-hasher (device kernel)\n"
        "feature type         uint32 32 bits\n"
        "feature hash         thomas_mueller\n"
        f"kmer size            {sp.kmer_size}\n"
        "kmer limit           16\n"
        f"sketch size          {sp.sketch_size}\n"
        "------------------------------------------------\n"
        "bucket size type     CSR offsets int64\n"
        f"max. locations       {db.max_locations_per_feature}\n"
        f"location limit       {MAX_SUPPORTED_LOCS_PER_FEATURE}\n"
        "------------------------------------------------")


def print_content_properties(db: Database):
    """(src/sketch_database.h:1206-1237)"""
    if db.target_count > 0:
        ranked = int(np.count_nonzero(
            db.taxonomy.parent_taxid[db.target_taxon_node] != NONE_TAXID))
        print(f"targets              {db.target_count}\n"
              f"ranked targets       {ranked}\n"
              f"taxa in tree         "
              f"{len(db.taxonomy) - 1 - db.target_count}")
    if db.features.num_keys > 0:
        mx, mean, std, skew = bucket_size_moments(db.features.bucket_sizes())
        print("------------------------------------------------\n"
              f"buckets              {db.features.num_keys}\n"
              f"bucket size          max: {mx} mean: {mean:g} "
              f"+/- {std:g} <> {skew:g}\n"
              f"features             {db.features.num_keys}\n"
              "dead features        0\n"
              f"locations            {db.features.num_locations}")
    print("------------------------------------------------")
