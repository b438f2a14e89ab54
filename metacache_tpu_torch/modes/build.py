"""Build mode CLI driver (main_mode_build, src/mode_build.cpp:1145-1175).

Counterpart of metacache_tpu/modes/build.py on the port's build
(db/build.py). One process builds all -num-shards shards in one pass over
the inputs. Under the MC_* launch (parallel/distributed.py) with P ranks
there are at least P shards, and rank r builds and writes the shards
s % P == r, each rank in one pass (the reference's rank-gated build,
mode_build.cpp:1079-1091). `-device cuda|cpu` (default cuda) is where
files that take the WindowBatcher path are sketched.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from metacache_tpu.config import BuildParams, SketchParams
from metacache_tpu.utils import ArgsParser, Timer, vm_rss_mb

from ..db import build as build_mod
from ..parallel import distributed


def get_build_options(args: ArgsParser) -> build_mod.BuildOptions:
    """(get_build_options, src/mode_build.cpp:93-138)"""
    kmerlen = args.get("kmerlen", 16, int)
    sketchlen = args.get("sketchlen", 16, int)
    winlen = args.get("winlen", 128, int)
    winstride = args.get("winstride", winlen - kmerlen + 1, int)
    maxlocs = args.get(["max-locations-per-feature",
                        "max_locations_per_feature"], 254, int)
    params = BuildParams(
        sketch=SketchParams(kmerlen, sketchlen, winlen, winstride),
        max_locations_per_feature=min(max(1, maxlocs), 254),
        remove_overpopulated_features=args.contains(
            ["remove-overpopulated-features",
             "remove_overpopulated_features"]),
        remove_ambig_features_rank=args.get(
            ["remove-ambig-features", "remove_ambig_features"], None),
        max_taxa_per_feature=args.get(
            ["max-ambig-per-feature", "max_ambig_per_feature"], 1, int))
    info_level = "moderate"
    if args.contains("silent"):
        info_level = "silent"
    elif args.contains("verbose"):
        info_level = "verbose"
    taxdir = args.get("taxonomy", "")
    return build_mod.BuildOptions(
        params=params,
        taxonomy_nodes=os.path.join(taxdir, "nodes.dmp") if taxdir else "",
        taxonomy_names=os.path.join(taxdir, "names.dmp") if taxdir else "",
        taxonomy_merged=os.path.join(taxdir, "merged.dmp") if taxdir else "",
        taxpostmap=tuple(args.get_all("taxpostmap")),
        reset_parents=args.contains(["reset-parents", "reset_parents"]),
        info_level=info_level,
        device=args.get("device", "cuda"))


def main_mode_build(args: ArgsParser) -> int:
    if len(args.positionals) < 3:
        print("usage: metacache build <database> <sequence files/dirs...> "
              "OPTIONS", file=sys.stderr)
        return 1
    dbfile = args.positionals[1]
    infiles = args.positionals[2:]
    opt = get_build_options(args)
    num_shards = args.get(["num-shards", "num_shards"], 1, int)
    world = distributed.world_size()
    num_shards = max(num_shards, world)
    my_shards = distributed.local_shard_ids(num_shards)

    silent = opt.info_level == "silent"
    progress = None
    if opt.info_level == "verbose":
        seen_files = set()

        def progress(path, tgt):
            if path not in seen_files:
                seen_files.add(path)
                print(f"  processing {path}")

    timer = Timer()
    timer.start()
    if not silent:
        print("Processing reference sequences.")
    shard_dbs = build_mod.build_database_shards(
        infiles, opt, num_shards=num_shards, shard_ids=my_shards,
        progress=progress)
    if not silent and shard_dbs:
        print(f"Added {shard_dbs[0].target_count} reference sequences "
              f"in {timer.seconds():.3f} s")

    if opt.params.remove_overpopulated_features:
        # global counts across shards (mode_build.cpp:847-1074); with
        # several ranks, every rank's (key, count) dump is all-gathered
        # (the reference's log2(P) Send/Recv tree + Bcast)
        counts = build_mod.merge_shard_feature_counts(
            [d.features for d in shard_dbs])
        if world > 1:
            rows = distributed.all_gather_int64(np.stack(
                [counts[0].astype(np.int64), counts[1]], axis=1))
            counts = build_mod.merge_feature_count_arrays(
                rows[:, 0].astype(np.uint32), rows[:, 1])
        for db in shard_dbs:
            rem = db.remove_overpopulated_features(
                opt.params.max_locations_per_feature, global_counts=counts)
            if not silent:
                print(f"Removed {rem} overpopulated features in shard "
                      f"{db.shard_id}.")

    write_timer = Timer()
    write_timer.start()
    for db in shard_dbs:
        path = db.save(dbfile)
        if not silent:
            print(f"Writing database to file '{path}' ... done.")
    write_timer.stop()
    timer.stop()
    if not silent:
        print(f"Time for database write: {write_timer.seconds():.3f} s")
        print(f"Total build time: {timer.seconds():.3f} s")
        rss = vm_rss_mb()
        if rss is not None:
            print(f"Current memory usage (VmRSS): {rss:.1f} MB")
        if shard_dbs:
            print("------------------------------------------------")
            for k, v in shard_dbs[0].properties().items():
                print(f"{k:<22}{v}")
    return 0
