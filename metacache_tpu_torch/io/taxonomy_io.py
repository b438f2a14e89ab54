"""NCBI taxonomy file parsing: names.dmp / nodes.dmp / merged.dmp and
sequence->taxid mapping files (accession2taxid, assembly_summary.txt).

Reference: src/taxonomy_io.cpp:56-314. Semantics mirrored:
  - names.dmp: keep only 'scientific name' category entries
  - merged.dmp: old->new id map; merged old ids become alias nodes
  - nodes.dmp: taxid | parent | rank; ids remapped through mergers;
    missing names -> '--', empty names -> '<taxid>'
  - root (taxid 1) is forced to rank 'root'
  - mapping files: '#'-prefixed header rows; locate 'accession.version' /
    'assembly_accession' key column and 'taxid' column; fall back to
    (col0 -> col1) when no 'taxid' header is present
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Tuple

from ..db.taxonomy import NONE_TAXID, Rank, Taxonomy, rank_from_name


def read_taxon_names(names_file: str) -> Dict[int, str]:
    names: Dict[int, str] = {}
    with open(names_file) as f:
        for line in f:
            # cheap prefilter: the category column must mention 'scientific'
            # (full NCBI names.dmp is ~3.8M rows, most are synonyms)
            if "scientific" not in line:
                continue
            parts = [p.strip() for p in line.split("|")]
            if len(parts) < 4:
                continue
            try:
                taxid = int(parts[0])
            except ValueError:
                continue
            if taxid in names:
                continue  # first (scientific) entry wins, as in the reference
            if "scientific" in parts[3]:
                names[taxid] = parts[1]
    return names


def read_merged_taxa(merged_file: str) -> Dict[int, int]:
    merged: Dict[int, int] = {}
    if not merged_file or not os.path.exists(merged_file):
        return merged
    with open(merged_file) as f:
        for line in f:
            parts = [p.strip() for p in line.split("|")]
            if len(parts) < 2:
                continue
            try:
                merged[int(parts[0])] = int(parts[1])
            except ValueError:
                continue
    return merged


def make_taxonomic_hierarchy(nodes_file: str, names_file: str = "",
                             merged_file: str = "") -> Taxonomy:
    """Parse NCBI dmp files into a dense Taxonomy
    (make_taxonomic_hierarchy, src/taxonomy_io.cpp:56-181)."""
    names = read_taxon_names(names_file) if names_file and \
        os.path.exists(names_file) else {}
    merged = read_merged_taxa(merged_file)

    tax = Taxonomy()
    # merged old ids become alias nodes pointing at the new id
    if merged:
        old_ids = list(merged.keys())
        tax.bulk_add(old_ids, list(merged.values()),
                     [""] * len(old_ids), [Rank.NONE] * len(old_ids))

    if nodes_file and os.path.exists(nodes_file):
        # whole-file parse into columns, then ONE vectorized bulk_add —
        # the full NCBI nodes.dmp (~2.4M rows) ingests in seconds
        ids: List[int] = []
        parents: List[int] = []
        node_names: List[str] = []
        ranks: List[int] = []
        rank_cache: Dict[str, int] = {}
        with open(nodes_file) as f:
            for line in f:
                parts = line.split("|", 3)
                if len(parts) < 3:
                    continue
                try:
                    taxid = int(parts[0])
                    parent = int(parts[1])
                except ValueError:
                    continue
                rank_name_str = parts[2]
                rank_code = rank_cache.get(rank_name_str)
                if rank_code is None:
                    rank_code = rank_from_name(rank_name_str)
                    rank_cache[rank_name_str] = rank_code
                name = names.get(taxid, "--")
                if not name:
                    name = f"<{taxid}>"
                ids.append(merged.get(taxid, taxid))
                parents.append(merged.get(parent, parent))
                node_names.append(name)
                ranks.append(rank_code)
        tax.bulk_add(ids, parents, node_names, ranks)

    # set rank of root (src/taxonomy_io.cpp:176)
    root = tax.node_of_id(1)
    if root:
        tax.rank[root] = Rank.ROOT
        tax.invalidate_caches()
    return tax


def read_sequence_to_taxon_id_mapping(mapping_file: str,
                                      mapping: Dict[str, int]) -> None:
    """Parse one accession->taxid mapping file
    (src/taxonomy_io.cpp:191-285)."""
    if not os.path.exists(mapping_file):
        return
    with open(mapping_file) as f:
        lines = f.readlines()
    if not lines:
        return

    # find the header row: last '#' line within the first 10, else row 0
    # (src/taxonomy_io.cpp:213-222)
    header_row = 0
    for i in range(min(10, len(lines))):
        if not lines[i].startswith("#"):
            break
        header_row += 1
    if header_row > 0:
        header_row -= 1

    # locate key/taxid columns by their true positions. (The reference
    # discards the first header token before counting columns, which works
    # for '#'-prefixed assembly_summary.txt headers but mis-shifts columns
    # for headerless accession2taxid files — we implement the intended
    # column detection instead.)
    keycol, taxcol = 0, 0
    header = lines[header_row].lstrip("#").split()
    for col, token in enumerate(header):
        if token == "taxid":
            taxcol = col
        elif token in ("accession.version", "assembly_accession"):
            keycol = col
    body = lines[header_row + 1:] if taxcol >= 1 else lines
    if taxcol < 1:
        keycol, taxcol = 0, 1

    for line in body:
        if line.startswith("#"):
            continue
        cols = line.rstrip("\n").split("\t")
        if len(cols) <= max(keycol, taxcol):
            cols = line.split()
            if len(cols) <= max(keycol, taxcol):
                continue
        key = cols[keycol].strip()
        try:
            taxid = int(cols[taxcol].strip())
        except ValueError:
            continue
        if key:
            mapping.setdefault(key, taxid)


def make_sequence_to_taxon_id_map(mapping_filenames: Iterable[str],
                                  infilenames: Iterable[str]) -> Dict[str, int]:
    """Gather mapping files from the input files' directories
    (src/taxonomy_io.cpp:292-311)."""
    indirs: List[str] = []
    for f in infilenames:
        d = os.path.dirname(os.path.abspath(f))
        if d not in indirs:
            indirs.append(d)
    mapping: Dict[str, int] = {}
    for d in indirs:
        for mf in mapping_filenames:
            read_sequence_to_taxon_id_mapping(os.path.join(d, mf), mapping)
    return mapping
