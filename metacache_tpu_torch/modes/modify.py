"""Modify mode: add targets to an existing database
(main_mode_build_modify, src/mode_build.cpp:1117-1136).

Counterpart of metacache_tpu/modes/modify.py: the new records are parsed
in Python and sketched by the port's WindowBatcher on `-device cuda|cpu`
(default cuda), and their table is merged into shard 0 of the database.
A file in no known format or with a malformed record is reported on
stderr as `FAIL: <path>: <error>`, as in the JAX mode; the records read
before the error stay.
"""
from __future__ import annotations

import sys

import numpy as np

from ..db import build as build_mod
from ..db.database import Database
from ..db.feature_table import ChunkedTripleSorter
from ..device import resolve_device
from ..io import sequence_io, taxonomy_io
from ..utils import ArgsParser


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
        try:
            build_mod.sketch_records(path, lambda tgt: batcher, db.taxonomy,
                                     target_nodes, seen, seq2taxid, None)
        except sequence_io.FormatError as e:
            print(f"FAIL: {path}: {e}", file=sys.stderr)
    batcher.finish()

    new_ft = triples.finalize(db.max_locations_per_feature)
    db.features = db.features.merge_with(new_ft,
                                         db.max_locations_per_feature)
    db.target_taxon_node = np.array(target_nodes, dtype=np.int32)
    path = db.save(dbfile)
    print(f"Added {len(target_nodes) - old} reference sequences.")
    print(f"Writing database to file '{path}' ... done.")
    return 0
