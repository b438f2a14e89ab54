"""Per-read / per-target / summary output — byte-compatible with the
reference's printers (src/printing.cpp, src/classification.cpp:583-632).

Number formatting: C++ default ostream formatting is %.6g-equivalent for
doubles; `fmt_g` reproduces it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, TextIO

import numpy as np

from ..db.database import Database
from ..db.taxonomy import NONE_TAXID, Rank, rank_from_name, rank_name
from .stats import ClassificationStatistics


def _rankcode(r) -> int:
    return r if isinstance(r, int) else rank_from_name(r)


def fmt_g(x: float) -> str:
    """C++ `os << double` default formatting (6 significant digits).
    Python's %g matches C++'s form exactly, including >=2-digit
    exponents (1e-05)."""
    return f"{x:.6g}"


class MapViewMode:
    NONE = 0
    MAPPED_ONLY = 1
    ALL = 2


class TaxonPrintMode:
    RANK_ID = 0
    RANK_NAME = 1
    RANK_NAME_ID = 2
    ID = 3
    NAME = 4
    NAME_ID = 5


@dataclasses.dataclass
class FormattingStrings:
    """(src/query_options.h:167-181)"""
    comment: str = "# "
    none: str = "--"
    column: str = "\t|\t"
    tax_separator: str = ","
    rank_suffix: str = ":"
    taxid_prefix: str = "("
    taxid_suffix: str = ")"


@dataclasses.dataclass
class OutputOptions:
    """classification_output_options (src/query_options.h:189-242)."""
    map_view_mode: int = MapViewMode.ALL
    show_query_ids: bool = False
    show_top_hits: bool = False
    show_all_hits: bool = False
    show_locations: bool = False
    show_lineage: bool = False
    collapse_unclassified: bool = True
    show_taxa_as: int = TaxonPrintMode.RANK_NAME
    show_ground_truth: bool = False
    show_alignment: bool = False
    show_hits_per_target_list: bool = False
    show_tax_abundances: bool = False
    abundance_estimates_rank: int = Rank.NONE
    make_tax_counts: bool = False
    show_errors: bool = True
    lowest_rank: int = Rank.SEQUENCE
    highest_rank: int = Rank.DOMAIN
    format: FormattingStrings = dataclasses.field(
        default_factory=FormattingStrings)
    split_files: bool = False
    query_mappings_file: str = ""
    targets_file: str = ""
    abundance_file: str = ""
    show_db_properties: bool = False
    show_query_params: bool = True
    show_summary: bool = True


# ---------------------------------------------------------------------------
# taxon formatting (printing.cpp:117-230, :305-329)
# ---------------------------------------------------------------------------
def _taxon_str(db: Database, node: int, mode: int,
               fmt: FormattingStrings) -> str:
    if node == 0:
        return ""
    t = db.taxonomy
    r = int(t.rank[node])
    name = t.names[node]
    tid = int(t.taxid[node])
    if mode == TaxonPrintMode.RANK_NAME:
        return f"{rank_name(r)}{fmt.rank_suffix}{name}"
    if mode == TaxonPrintMode.NAME:
        return name
    if mode == TaxonPrintMode.RANK_ID:
        return f"{rank_name(r)}{fmt.rank_suffix}{tid}"
    if mode == TaxonPrintMode.ID:
        return str(tid)
    if mode == TaxonPrintMode.RANK_NAME_ID:
        return (f"{rank_name(r)}{fmt.rank_suffix}{name}"
                f"{fmt.taxid_prefix}{tid}{fmt.taxid_suffix}")
    if mode == TaxonPrintMode.NAME_ID:
        return f"{name}{fmt.taxid_prefix}{tid}{fmt.taxid_suffix}"
    return name


def _no_taxon_str(mode: int, r: int, fmt: FormattingStrings) -> str:
    if mode == TaxonPrintMode.RANK_NAME:
        return f"{rank_name(r)}{fmt.rank_suffix}{fmt.none}"
    if mode == TaxonPrintMode.NAME:
        return fmt.none
    if mode == TaxonPrintMode.RANK_ID:
        return f"{rank_name(r)}{fmt.rank_suffix}{NONE_TAXID}"
    if mode == TaxonPrintMode.ID:
        return str(NONE_TAXID)
    if mode == TaxonPrintMode.RANK_NAME_ID:
        return (f"{rank_name(r)}{fmt.rank_suffix}{fmt.none}"
                f"{fmt.taxid_prefix}{NONE_TAXID}{fmt.taxid_suffix}")
    if mode == TaxonPrintMode.NAME_ID:
        return f"{fmt.none}{fmt.taxid_prefix}{NONE_TAXID}{fmt.taxid_suffix}"
    return fmt.none


def show_lineage_str(db: Database, lineage_row: np.ndarray, mode: int,
                     lowest: int, highest: int,
                     fmt: FormattingStrings) -> str:
    """(printing.cpp:180-202)"""
    if lowest == Rank.NONE:
        return ""
    if highest == Rank.NONE:
        highest = Rank.ROOT
    parts = []
    for r in range(lowest, highest + 1):
        node = int(lineage_row[r]) if r < Rank.NUM_RANKS else 0
        if node:
            parts.append(_taxon_str(db, node, mode, fmt))
        else:
            parts.append(_no_taxon_str(mode, r, fmt))
    return fmt.tax_separator.join(parts)


def show_taxon_str(db: Database, opt: OutputOptions, node: int) -> str:
    """(printing.cpp:305-329)"""
    fmt = opt.format
    r = int(db.taxonomy.rank[node]) if node else Rank.NONE
    if node == 0 or r > opt.highest_rank:
        if opt.collapse_unclassified:
            if opt.show_taxa_as == TaxonPrintMode.ID:
                return str(NONE_TAXID)
            return fmt.none
        rmax = opt.highest_rank if opt.show_lineage else opt.lowest_rank
        parts = []
        for rr in range(opt.lowest_rank, rmax + 1):
            if opt.show_taxa_as == TaxonPrintMode.ID:
                parts.append(str(NONE_TAXID))
            elif opt.show_taxa_as == TaxonPrintMode.NAME:
                parts.append(fmt.none)
            elif opt.show_taxa_as == TaxonPrintMode.NAME_ID:
                parts.append(f"{fmt.none}{fmt.taxid_prefix}{NONE_TAXID}"
                             f"{fmt.taxid_suffix}")
            elif opt.show_taxa_as == TaxonPrintMode.RANK_ID:
                parts.append(f"{fmt.none}{fmt.rank_suffix}{NONE_TAXID}")
            elif opt.show_taxa_as == TaxonPrintMode.RANK_NAME_ID:
                parts.append(f"{fmt.none}{fmt.rank_suffix}{fmt.none}"
                             f"{fmt.taxid_prefix}{NONE_TAXID}"
                             f"{fmt.taxid_suffix}")
            else:
                parts.append(f"{fmt.none}{fmt.rank_suffix}{fmt.none}")
        return fmt.tax_separator.join(parts)
    rmin = r if opt.lowest_rank < r else opt.lowest_rank
    rmax = opt.highest_rank if opt.show_lineage else rmin
    return show_lineage_str(db, db.taxonomy.ranked_lineage[node],
                            opt.show_taxa_as, rmin, rmax, fmt)


def show_matches_str(db: Database, cand_tax, cand_hits, lowest: int) -> str:
    """Top-hits list 'name:hits,...' (printing.cpp:334-360)."""
    parts = []
    t = db.taxonomy
    for tax, hits in zip(cand_tax, cand_hits):
        if tax == 0 or hits <= 0:
            break
        if lowest == Rank.SEQUENCE:
            parts.append(f"{t.names[tax]}:{hits}")
        else:
            if int(t.rank[tax]) < lowest:
                anc = int(t.ranked_lineage[tax, lowest])
            else:
                anc = int(tax)
            if anc:
                parts.append(f"{int(t.taxid[anc])}:{hits}")
            else:
                parts.append(f"{t.names[tax]}:{hits}")
    return ",".join(parts)


def show_candidate_ranges_str(db: Database, cand_beg, cand_end,
                              cand_tax) -> str:
    """(printing.cpp:424-436)"""
    w = db.sketch_params.window_stride
    ws = db.sketch_params.window_size
    out = []
    for tax, b, e in zip(cand_tax, cand_beg, cand_end):
        if tax == 0:
            break
        out.append(f"[{w * int(b)},{w * int(e) + ws}] ")
    return "".join(out)


# ---------------------------------------------------------------------------
# query parameters echo block (printing.cpp:40-115)
# ---------------------------------------------------------------------------
def show_query_parameters(out: TextIO, opt) -> None:
    """Byte-compatible rendering of show_query_parameters
    (src/printing.cpp:40-115). `opt` is a QueryModeOptions-shaped object
    (.output, .classify, .evaluate, .pairing, .num_threads).

    The reference's quirks are reproduced verbatim: the clade-exclusion
    line has NO trailing newline (printing.cpp:76-78) and the
    per-taxon-abundance note is gated on showHitsPerTargetList twice
    (printing.cpp:96-104), so both notes print together.
    """
    o = opt.output
    cmt = o.format.comment
    w = out.write
    if o.map_view_mode != MapViewMode.NONE:
        w(f"{cmt}Reporting per-read mappings (non-mapping lines "
          f"start with '{cmt}').\n")
        if o.show_lineage:
            w(f"{cmt}The complete lineage will be reported "
              f"starting with the lowest match.\n")
        else:
            w(f"{cmt}Only the lowest matching rank will be reported.\n")
    else:
        w(f"{cmt}Per-Read mappings will not be shown.\n")

    w(f"{cmt}Classification will be constrained to ranks from "
      f"'{rank_name(_rankcode(opt.classify.lowest_rank))}' to "
      f"'{rank_name(_rankcode(opt.classify.highest_rank))}'.\n")
    w(f"{cmt}Classification hit threshold is "
      f"{opt.classify.hits_min} per query\n")
    w(f"{cmt}At maximum {opt.classify.max_candidates} "
      f"classification candidates will be considered per query.\n")

    if opt.evaluate.exclude_rank != Rank.NONE:
        w(f"{cmt}Clade Exclusion on Rank: "
          f"{rank_name(opt.evaluate.exclude_rank)}")

    if opt.pairing == "files":
        w(f"{cmt}File based paired-end mode:\n")
        w(f"{cmt}  Reads from two consecutive files will be interleaved.\n")
        w(f"{cmt}  Max insert size considered "
          f"{opt.classify.insert_size_max}.\n")
    elif opt.pairing == "sequences":
        w(f"{cmt}Per file paired-end mode:\n")
        w(f"{cmt}  Reads from two consecutive sequences in each file "
          f"will be paired up.\n")
        w(f"{cmt}  Max insert size considered "
          f"{opt.classify.insert_size_max}.\n")

    if o.show_alignment:
        w(f"{cmt}Query sequences will be aligned to best candidate "
          f"target => SLOW!\n")

    if o.show_hits_per_target_list:
        w(f"{cmt}A list of hits per reference sequence "
          f"will be generated after the read mapping.\n")
        w(f"{cmt}A list of absolute and relative abundances per taxon "
          f"will be generated after the read mapping.\n")

    if o.abundance_estimates_rank != Rank.NONE:
        w(f"{cmt}A list of absolute and relative abundances for each '"
          f"{rank_name(o.abundance_estimates_rank)}"
          f"' will be generated after the read mapping.\n")

    w(f"{cmt}Using {opt.num_threads} threads\n")


# ---------------------------------------------------------------------------
# per-read mapping lines (classification.cpp:486-632)
# ---------------------------------------------------------------------------
def show_query_mapping_header(out: TextIO, opt: OutputOptions):
    if opt.map_view_mode == MapViewMode.NONE:
        return
    col = opt.format.column
    s = opt.format.comment + "TABLE_LAYOUT: "
    if opt.show_query_ids:
        s += "query_id" + col
    s += "query_header" + col
    if opt.show_ground_truth:
        s += _taxon_header(opt, "truth_") + col
    if opt.show_all_hits:
        s += "all_hits" + col
    if opt.show_top_hits:
        s += "top_hits" + col
    if opt.show_locations:
        s += "candidate_locations" + col
    s += _taxon_header(opt, "")
    out.write(s + "\n")


def _taxon_header(opt: OutputOptions, prefix: str) -> str:
    """(printing.cpp:240-297)"""
    rmax = opt.highest_rank if opt.show_lineage else opt.lowest_rank
    fmt = opt.format

    def one(r: Optional[int]) -> str:
        rn = (prefix + rank_name(r) + fmt.rank_suffix) if r is not None else \
            (prefix + "rank" + fmt.rank_suffix)
        if opt.show_taxa_as == TaxonPrintMode.RANK_NAME:
            return rn + prefix + "taxname"
        if opt.show_taxa_as == TaxonPrintMode.NAME:
            return prefix + "taxname"
        if opt.show_taxa_as == TaxonPrintMode.RANK_ID:
            return rn + prefix + "taxid"
        if opt.show_taxa_as == TaxonPrintMode.ID:
            return prefix + "taxid"
        if opt.show_taxa_as == TaxonPrintMode.RANK_NAME_ID:
            return (rn + prefix + "taxname" + fmt.taxid_prefix + prefix
                    + "taxid" + fmt.taxid_suffix)
        return (prefix + "taxname" + fmt.taxid_prefix + prefix + "taxid"
                + fmt.taxid_suffix)

    if opt.lowest_rank == rmax:
        return one(None)
    return opt.format.tax_separator.join(
        one(r) for r in range(opt.lowest_rank, rmax + 1))


def show_query_mapping(out: TextIO, db: Database, opt: OutputOptions,
                       query_id: int, header: str, ground_truth: int,
                       best_node: int, cand_tax, cand_hits, cand_beg,
                       cand_end, alignment_suffix: str = ""):
    """One mapping line (classification.cpp:583-632)."""
    if opt.map_view_mode == MapViewMode.NONE or (
            opt.map_view_mode == MapViewMode.MAPPED_ONLY and best_node == 0):
        return
    col = opt.format.column
    parts = []
    if opt.show_query_ids:
        parts.append(str(query_id))
    sp = header.find(" ")
    parts.append(header[:sp] if sp != -1 else header)
    if opt.show_ground_truth:
        parts.append(show_taxon_str(db, opt, ground_truth))
    if opt.show_top_hits:
        parts.append(show_matches_str(db, cand_tax, cand_hits,
                                      opt.lowest_rank))
    if opt.show_locations:
        parts.append(show_candidate_ranges_str(db, cand_beg, cand_end,
                                               cand_tax))
    parts.append(show_taxon_str(db, opt, best_node))
    out.write(col.join(parts) + alignment_suffix + "\n")


def alignment_suffix_str(db: Database, opt: OutputOptions, seq1: str,
                         seq2: str, cand_tax, cand_beg, cand_end,
                         sequence_loader) -> str:
    """The '-align' appendix of a mapping line (show_alignment,
    src/classification.cpp:437-477)."""
    from . import align as align_mod
    from ..db.taxonomy import Rank
    node = int(cand_tax[0])
    if node == 0 or db.taxonomy.rank[node] != Rank.SEQUENCE:
        return ""
    filename = db.taxonomy.source_filename[node]
    index = int(db.taxonomy.source_index[node])
    try:
        tgt_seq = sequence_loader(filename, index)
    except Exception as e:
        if opt.show_errors:
            import sys
            print(e, file=sys.stderr)
        return ""
    if not tgt_seq:
        return ""
    w = db.sketch_params.window_stride
    ws = db.sketch_params.window_size
    beg, end = int(cand_beg[0]), int(cand_end[0])
    subject = tgt_seq[w * beg: w * end + ws]
    score, qa, sa = align_mod.best_alignment_for_query(seq1, seq2, subject)
    cmt = opt.format.comment
    return (f"\n{cmt}  score  {score}  aligned to "
            f"{filename} #{index} in range [{w * beg},{w * end + w}]\n"
            f"{cmt}  query  {qa}\n"
            f"{cmt}  target {sa}")


# ---------------------------------------------------------------------------
# summary + statistics report (printing.cpp:522-641)
# ---------------------------------------------------------------------------
_STAT_RANKS = [Rank.SEQUENCE, Rank.SUBSPECIES, Rank.SPECIES, Rank.GENUS,
               Rank.FAMILY, Rank.ORDER, Rank.CLASS, Rank.PHYLUM,
               Rank.KINGDOM, Rank.DOMAIN, Rank.ROOT]


def show_taxon_statistics(out: TextIO, stats: ClassificationStatistics,
                          prefix: str):
    if stats.assigned() < 1:
        out.write("None of the input sequences could be classified.\n")
        return
    if stats.unassigned() > 0:
        out.write(f"{prefix}unclassified: "
                  f"{fmt_g(100 * stats.unclassified_rate())}% "
                  f"({stats.unassigned()})\n")
    out.write(f"{prefix}classified:\n")
    for r in _STAT_RANKS:
        if stats.assigned(r) > 0:
            rn = rank_name(r).ljust(11)
            out.write(f"{prefix}  {rn}"
                      f"{fmt_g(100 * stats.classification_rate(r))}% "
                      f"({stats.assigned(r)})\n")
    if stats.known() > 0:
        if stats.unknown() > 0:
            out.write(f"{prefix}ground truth unknown: "
                      f"{fmt_g(100 * stats.unknown_rate())}% "
                      f"({stats.unknown()})\n")
        out.write(f"{prefix}ground truth known:\n")
        for r in _STAT_RANKS:
            if stats.assigned(r) > 0:
                rn = rank_name(r).ljust(11)
                out.write(f"{prefix}  {rn}"
                          f"{fmt_g(100 * stats.known_rate(r))}% "
                          f"({stats.known(r)})\n")
        out.write(f"{prefix}correctly classified:\n")
        for r in _STAT_RANKS:
            if stats.assigned(r) > 0:
                rn = rank_name(r).ljust(11)
                out.write(f"{prefix}  {rn}{stats.correct(r)}\n")
        out.write(f"{prefix}precision (correctly classified / classified) "
                  f"if ground truth known:\n")
        for r in _STAT_RANKS:
            if stats.assigned(r) > 0:
                rn = rank_name(r).ljust(11)
                out.write(f"{prefix}  {rn}{fmt_g(100 * stats.precision(r))}%\n")
        out.write(f"{prefix}sensitivity (correctly classified / all) "
                  f"if ground truth known:\n")
        for r in _STAT_RANKS:
            if stats.assigned(r) > 0:
                rn = rank_name(r).ljust(11)
                out.write(f"{prefix}  {rn}"
                          f"{fmt_g(100 * stats.sensitivity(r))}%\n")
        if stats.coverage(Rank.DOMAIN).total() > 0:
            out.write(f"{prefix}false positives "
                      f"(hit on taxa not covered in DB):\n")
            for r in _STAT_RANKS:
                if stats.assigned(r) > 0:
                    rn = rank_name(r).ljust(11)
                    out.write(f"{prefix}  {rn}"
                              f"{stats.coverage(r).false_pos()}\n")


def show_summary(out: TextIO, opt: OutputOptions, stats,
                 time_ms: float, paired: bool):
    """(printing.cpp:622-641)"""
    num_queries = 2 * stats.total() if paired else stats.total()
    minutes = time_ms / 60000.0
    speed = num_queries / minutes if minutes > 0 else 0.0
    c = opt.format.comment
    out.write(f"{c}queries: {num_queries}\n")
    out.write(f"{c}time:    {int(time_ms)} ms\n")
    out.write(f"{c}speed:   {fmt_g(speed)} queries/min\n")
    if stats.total() > 0:
        show_taxon_statistics(out, stats, c)
    else:
        out.write(f"{c}No valid query sequences found.\n")


def show_matches_per_targets(out: TextIO, db: Database, target_matches,
                             opt: OutputOptions):
    """Hits-per-target table (printing.cpp:441-470).

    target_matches: dict target_node -> [(qid, [(win, hits), ...]), ...]
    """
    c, col = opt.format.comment, opt.format.column
    out.write(f"{c}--- list of hits for each reference sequence ---\n")
    out.write(f"{c}window start position within sequence = "
              f"window_index * window_stride(="
              f"{db.query_sketch_params.window_stride})\n")
    out.write(f"{c}TABLE_LAYOUT:  sequence {col} windows_in_sequence "
              f"{col}queryid/window_index:hits/window_index:hits/..."
              f",queryid/...\n")
    for node in target_matches:
        entries = sorted(
            target_matches[node],
            key=lambda e: (e[1][0], e[1][-1], e[0]))
        out.write(show_taxon_str(db, opt, node))
        out.write(f"{col}{int(db.taxonomy.source_windows[node])}{col}")
        parts = []
        for qid, wins in entries:
            parts.append(str(qid) +
                         "".join(f"/{w}:{h}" for w, h in wins))
        out.write(",".join(parts) + "\n")


def show_abundance_table(out: TextIO, db: Database, tax_counts,
                         total_count: int, opt: OutputOptions):
    """(printing.cpp:482-497); tax_counts: list of (node, count) in
    (rank desc, taxid asc) order."""
    col = opt.format.column
    for node, count in tax_counts:
        if node:
            r = int(db.taxonomy.rank[node])
            out.write(f"{rank_name(r)}{opt.format.rank_suffix}"
                      f"{db.taxonomy.names[node]}")
        else:
            out.write("none")
        pct = count / total_count * 100 if total_count else 0.0
        cstr = fmt_g(float(count)) if isinstance(count, float) else str(count)
        out.write(f"{col}{cstr}{col}{fmt_g(pct)}%\n")


def show_abundances(out: TextIO, db: Database, tax_counts, total_count,
                    opt: OutputOptions):
    out.write(f"{opt.format.comment}query summary: number of queries mapped "
              f"per taxon\n")
    show_abundance_table(out, db, tax_counts, total_count, opt)


def show_abundance_estimates(out: TextIO, db: Database, tax_counts,
                             total_count, opt: OutputOptions):
    out.write(f"{opt.format.comment}estimated abundance (number of queries) "
              f"per {rank_name(opt.abundance_estimates_rank)}\n")
    show_abundance_table(out, db, tax_counts, total_count, opt)
