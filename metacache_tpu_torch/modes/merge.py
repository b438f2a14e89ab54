"""Merge mode: offline merging of per-shard classification result files
(main_mode_merge, src/mode_merge.cpp:52-457).

Counterpart of metacache_tpu/modes/merge.py, whose module cannot be
imported without JAX. Each input file must contain '-tophits' output
produced with '-queryids' at a rank above sequence level. Candidates are
re-inserted per query id (same-taxon candidates keep the max hit count)
and re-classified at >= species level by the port's ranked-LCA vote on
`-device cuda|cpu` (default cuda).
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, TextIO

import numpy as np
import torch

from metacache_tpu.db.database import Database
from metacache_tpu.db.taxonomy import Rank, Taxonomy, rank_from_name
from metacache_tpu.io import taxonomy_io
from metacache_tpu.query import abundance as abundance_mod
from metacache_tpu.query import output as out_mod
from metacache_tpu.query.stats import ClassificationStatistics
from metacache_tpu.utils import ArgsParser, Timer

from ..device import resolve_device
from ..ops.classify_op import classify_lca
from .query import QueryModeOptions, get_query_options


class ResultsFormatError(RuntimeError):
    pass


def parse_results_file(path: str, colsep: str = "\t|\t"):
    """Yield (query_id, header, [(taxid, hits), ...]) per result line
    (get_results_file_properties + read_results,
    src/mode_merge.cpp:131-264)."""
    tophits_col = -1
    saw_rank_line = False
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("#"):
                if line.startswith("# Classification will be constrained"):
                    if "sequence" in line:
                        raise ResultsFormatError(
                            "cannot merge results on sequence level")
                    saw_rank_line = True
                if line.startswith("# TABLE_LAYOUT:"):
                    cols = [c.strip() for c in line[15:].split("|")]
                    if not cols or cols[0].strip() != "query_id":
                        raise ResultsFormatError(
                            f"no query_id in file {path}")
                    for i, c in enumerate(cols):
                        if c == "top_hits":
                            tophits_col = i
                    if tophits_col < 1:
                        raise ResultsFormatError(
                            f"no top_hits in file {path}")
                continue
            if not line:
                continue
            if tophits_col < 1:
                raise ResultsFormatError(f"TABLE_LAYOUT not found in {path}")
            cols = line.split(colsep)
            if len(cols) <= tophits_col:
                continue
            try:
                qid = int(cols[0])
            except ValueError:
                continue
            header = cols[1] if len(cols) > 1 else ""
            cands = []
            for item in cols[tophits_col].split(","):
                if ":" not in item:
                    continue
                tid_s, hits_s = item.rsplit(":", 1)
                try:
                    cands.append((int(tid_s), int(hits_s)))
                except ValueError:
                    continue
            yield qid, header, cands


def insert_candidate(top: List[dict], tax_node: int, hits: int,
                     tax: Taxonomy, lowest_rank: int, max_cand: int):
    """best_distinct_…::insert semantics for the merge path
    (src/candidates.h:236-285)."""
    if tax_node == 0:
        return
    if lowest_rank > Rank.SEQUENCE:
        anc = int(tax.ranked_lineage[tax_node, lowest_rank])
        if anc:
            tax_node = anc
    j = next((j for j, c in enumerate(top) if c["tax"] == tax_node), None)
    if j is not None:
        if hits > top[j]["hits"]:
            top[j] = {"tax": tax_node, "hits": hits}
        top[:j + 1] = sorted(top[:j + 1], key=lambda c: -c["hits"])
        return
    lo, hi = 0, len(top)
    while lo < hi:
        mid = (lo + hi) // 2
        if top[mid]["hits"] >= hits:
            lo = mid + 1
        else:
            hi = mid
    if lo != len(top) or len(top) < max_cand:
        top.insert(lo, {"tax": tax_node, "hits": hits})
        del top[max_cand:]


def main_mode_merge(args: ArgsParser) -> int:
    if len(args.positionals) < 3:
        print("Please provide at least two files to be merged!",
              file=sys.stderr)
        return 1
    infiles = sorted(args.positionals[1:])
    device = resolve_device(args.get("device", "cuda"))

    taxdir = args.get("taxonomy", "")
    if not taxdir:
        print("No taxonomy specified. Unable to perform merge.")
        return 1
    tax = taxonomy_io.make_taxonomic_hierarchy(
        os.path.join(taxdir, "nodes.dmp"),
        os.path.join(taxdir, "names.dmp"),
        os.path.join(taxdir, "merged.dmp"))

    opt = get_query_options(args, device)
    # merge constraints (get_merge_options, mode_merge.cpp:84-95)
    c = opt.classify
    hits_min = c.hits_min if c.hits_min > 0 else 5
    lowest = max(_ci(c.lowest_rank), Rank.SPECIES)
    opt.classify = dataclasses.replace(
        c, hits_min=hits_min, lowest_rank=lowest)
    opt.output.lowest_rank = max(opt.output.lowest_rank, Rank.SPECIES)

    db = Database(
        sketch_params=None, query_sketch_params=None,
        max_locations_per_feature=254, taxonomy=tax,
        target_taxon_node=np.zeros(0, np.int32))

    headers: Dict[int, str] = {}
    candidates: Dict[int, List[dict]] = {}
    for path in infiles:
        try:
            for qid, header, cands in parse_results_file(path):
                headers.setdefault(qid, header)
                top = candidates.setdefault(qid, [])
                for tid, hits in cands:
                    insert_candidate(top, tax.node_of_id(tid), hits, tax,
                                     lowest, opt.classify.max_candidates)
        except (ResultsFormatError, OSError) as e:
            print(f"FAIL: {path}: {e}", file=sys.stderr)
            return 1

    out_path = opt.output.query_mappings_file
    out = open(out_path, "w") if out_path else sys.stdout
    try:
        _classify_and_report(db, opt, headers, candidates, out, infiles,
                             device)
    finally:
        if out_path:
            out.close()
    return 0


def _ci(rank) -> int:
    if isinstance(rank, int):
        return rank
    return rank_from_name(rank)


def _classify_and_report(db: Database, opt: QueryModeOptions, headers,
                         candidates, out: TextIO, infiles,
                         device: torch.device):
    timer = Timer()
    timer.start()
    c = opt.output.format.comment
    # parameter echo precedes everything (mode_merge.cpp:358 emits the same
    # block as query mode; merge runs single-threaded, mode_merge.cpp:91-92)
    if opt.output.show_query_params:
        opt.num_threads = 1
        out_mod.show_query_parameters(out, opt)
    out.write(f"{c}Merging {len(infiles)} files:\n")
    for f in infiles:
        out.write(f"{c}{f}\n")

    stats = ClassificationStatistics()
    tax_counts: Dict[int, float] = {}
    qids = sorted(headers)
    C = opt.classify.max_candidates
    n = len(qids)
    lin = db.taxonomy.ranked_lineage
    cand_tax = np.zeros((max(n, 1), C), np.int32)
    cand_hits = np.zeros((max(n, 1), C), np.int32)
    for i, q in enumerate(qids):
        for j, cd in enumerate(candidates.get(q, [])[:C]):
            cand_tax[i, j] = cd["tax"]
            cand_hits[i, j] = cd["hits"]
    best, best_rank = classify_lca(
        *(torch.from_numpy(a.astype(np.int64)).to(device)
          for a in (cand_tax, cand_hits, np.asarray(lin))),
        opt.classify.hits_min, opt.classify.hits_diff_fraction,
        _ci(opt.classify.highest_rank))
    best = best.cpu().numpy()
    best_rank = best_rank.cpu().numpy()

    zeros = np.zeros(C, np.int32)
    for i, q in enumerate(qids):
        b = int(best[i])
        stats.assign(int(best_rank[i]))
        if opt.output.make_tax_counts and b:
            tax_counts[b] = tax_counts.get(b, 0) + 1
        out_mod.show_query_mapping(out, db, opt.output, q, headers[q], 0, b,
                                   cand_tax[i], cand_hits[i], zeros, zeros)
    timer.stop()

    o = opt.output
    if o.show_tax_abundances:
        out_mod.show_abundances(
            out, db, abundance_mod.sorted_counts(db.taxonomy, tax_counts),
            stats.total(), o)
    if o.abundance_estimates_rank != Rank.NONE:
        est = abundance_mod.estimate_abundance(db.taxonomy, tax_counts,
                                               o.abundance_estimates_rank)
        out_mod.show_abundance_estimates(
            out, db, abundance_mod.sorted_counts(db.taxonomy, est),
            stats.total(), o)
    if o.show_summary:
        out_mod.show_summary(out, o, stats, timer.milliseconds(), False)
