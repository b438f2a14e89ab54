"""Modify mode: add targets to an existing database
(main_mode_build_modify, src/mode_build.cpp:1117-1136).

Counterpart of metacache_tpu/modes/modify.py: the new records are parsed
in Python and sketched by the port's WindowBatcher on `-device cuda|cpu`
(default cuda), and their table is merged into shard 0 of the database.
Unlike the JAX mode, a file that cannot be parsed aborts the run instead
of being reported and left out.
"""
from __future__ import annotations

import sys

import numpy as np

from metacache_tpu.db.database import Database
from metacache_tpu.db.feature_table import ChunkedTripleSorter
from metacache_tpu.io import taxonomy_io
from metacache_tpu.utils import ArgsParser

from ..db import build as build_mod
from ..device import resolve_device


def main_mode_modify(args: ArgsParser) -> int:
    if len(args.positionals) < 3:
        print("usage: metacache modify <database> <sequence files/dirs...> "
              "OPTIONS", file=sys.stderr)
        return 1
    dbfile = args.positionals[1]
    infiles = args.positionals[2:]
    device = resolve_device(args.get("device", "cuda"))

    db = Database.load(dbfile, 0)
    files = build_mod.gather_input_files(infiles)
    seq2taxid = taxonomy_io.make_sequence_to_taxon_id_map(
        build_mod.SEQUENCE_ID_MAPPINGS, files)

    triples = ChunkedTripleSorter()
    batcher = build_mod.WindowBatcher(db.sketch_params, triples, device)
    seen = {db.taxonomy.names[n] for n in db.target_taxon_node}
    target_nodes = list(db.target_taxon_node)
    old = len(target_nodes)
    for path in files:
        build_mod.sketch_records(path, lambda tgt: batcher, db.taxonomy,
                                 target_nodes, seen, seq2taxid, None)
    batcher.finish()

    new_ft = triples.finalize(db.max_locations_per_feature)
    db.features = db.features.merge_with(new_ft,
                                         db.max_locations_per_feature)
    db.target_taxon_node = np.array(target_nodes, dtype=np.int32)
    path = db.save(dbfile)
    print(f"Added {len(target_nodes) - old} reference sequences.")
    print(f"Writing database to file '{path}' ... done.")
    return 0
