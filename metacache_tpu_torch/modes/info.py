"""Info mode: show database properties / target info / lineages
(main_mode_info, src/mode_info.cpp:48-345).

Counterpart of metacache_tpu/modes/info.py, whose module cannot be
imported without JAX. Host only: it loads the shards through the port's
load_all_shards (feature tables memory-mapped).
"""
from __future__ import annotations

import sys

from ..db.taxonomy import Rank, rank_from_name, rank_name
from ..utils import ArgsParser
from .query import load_all_shards


def main_mode_info(args: ArgsParser) -> int:
    if len(args.positionals) < 2:
        print("usage: metacache info <database> [target|targets|lineages|"
              "rank <rankname>|statistics|featuremap|featurecounts]",
              file=sys.stderr)
        return 1
    dbname = args.positionals[1]
    what = args.positionals[2] if len(args.positionals) > 2 else ""

    if what in ("", "statistics"):
        db = load_all_shards(dbname)
        print("------------------------------------------------")
        for k, v in db.properties().items():
            print(f"{k:<28}{v}")
        return 0

    db = load_all_shards(dbname)
    t = db.taxonomy
    if what in ("target", "targets"):
        names = set(args.positionals[3:])
        print("targets (sequence level taxa):")
        for tgt in range(db.target_count):
            node = int(db.target_taxon_node[tgt])
            if names and t.names[node] not in names:
                continue
            lin = t.ranked_lineage[node]
            parts = [f"{rank_name(r)}:{t.names[lin[r]]}"
                     for r in range(Rank.NUM_RANKS) if lin[r]]
            print(f"    {t.names[node]}:")
            print(f"        origin:  {t.source_filename[node]} / "
                  f"{int(t.source_index[node])}")
            print(f"        windows: {int(t.source_windows[node])}")
            print(f"        lineage: {','.join(parts)}")
        return 0
    if what == "lineages":
        print("ranked lineages of all targets:")
        for tgt in range(db.target_count):
            node = int(db.target_taxon_node[tgt])
            lin = t.ranked_lineage[node]
            parts = [t.names[lin[r]] if lin[r] else "--"
                     for r in range(Rank.NUM_RANKS)]
            print(f"{t.names[node]}\t" + "\t".join(parts))
        return 0
    if what == "rank":
        if len(args.positionals) < 4:
            print("usage: metacache info <database> rank <rankname>",
                  file=sys.stderr)
            return 1
        r = rank_from_name(args.positionals[3])
        counts = {}
        for tgt in range(db.target_count):
            node = int(db.target_taxon_node[tgt])
            anc = int(t.ranked_lineage[node, r]) if r < Rank.NUM_RANKS else 0
            counts[anc] = counts.get(anc, 0) + 1
        print(f"number of targets per {args.positionals[3]}:")
        for anc, c in sorted(counts.items(),
                             key=lambda kv: (-kv[1], kv[0])):
            nm = t.names[anc] if anc else "none"
            print(f"    {nm}: {c}")
        return 0
    if what == "featurecounts":
        keys, counts = db.features.feature_counts()
        for k, c in zip(keys, counts):
            print(f"{int(k)} -> {int(c)}")
        return 0
    if what == "featuremap":
        ft = db.features
        for i, k in enumerate(ft.keys):
            s, e = ft.offsets[i], ft.offsets[i + 1]
            locs = "".join(f"({int(tg)},{int(w)})" for tg, w in
                           zip(ft.loc_tgt[s:e], ft.loc_win[s:e]))
            print(f"{int(k)} -> {locs}")
        return 0
    print(f"unknown info mode '{what}'", file=sys.stderr)
    return 1
