"""Annotate mode: rewrite sequence headers with taxon ids from
accession->taxid mapping files (main_mode_annotate,
src/mode_annotate.cpp:54-391)."""
from __future__ import annotations

import os
import sys
from typing import Dict

from ..io import sequence_io, taxonomy_io
from ..utils import ArgsParser


def annotate_file(infile: str, outfile, mapping: Dict[str, int],
                  field_prefix: str = "taxid") -> int:
    """Insert '|taxid|<id>|' after the sequence id of every record whose
    accession is found in the mapping. Returns #annotated."""
    fmt = sequence_io.sniff_format(infile)
    n = 0
    if fmt == "fasta":
        with open(infile) as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    header = line[1:]
                    tid = _lookup(header, mapping)
                    if tid:
                        n += 1
                        outfile.write(f">{_annotated(header, tid)}\n")
                    else:
                        outfile.write(line + "\n")
                else:
                    outfile.write(line + "\n")
    else:
        for rec in sequence_io.read_fastq(infile):
            tid = _lookup(rec.header, mapping)
            if tid:
                n += 1
                header = _annotated(rec.header, tid)
            else:
                header = rec.header
            outfile.write(f"@{header}\n{rec.data}\n+\n{rec.qualities}\n")
    return n


def _lookup(header: str, mapping: Dict[str, int]) -> int:
    for key in (sequence_io.extract_ncbi_accession_version(header),
                sequence_io.extract_ncbi_accession(header),
                header.split(" ")[0]):
        if key and key in mapping:
            return mapping[key]
    return 0


def _annotated(header: str, tid: int) -> str:
    sp = header.find(" ")
    if sp == -1:
        return f"{header}|taxid|{tid}|"
    return f"{header[:sp]}|taxid|{tid}|{header[sp:]}"


def main_mode_annotate(args: ArgsParser) -> int:
    if len(args.positionals) < 3:
        print("usage: metacache annotate <infile> taxid -mapping-files "
              "<files...> [-out <outfile>]", file=sys.stderr)
        return 1
    infile = args.positionals[1]
    mapping: Dict[str, int] = {}
    for mf in args.get_all(["mapping-files", "mapping_files", "taxidmap"]):
        taxonomy_io.read_sequence_to_taxon_id_mapping(mf, mapping)
    if not mapping:
        print("no mapping files given or none readable", file=sys.stderr)
        return 1
    outpath = args.get("out", "")
    if outpath:
        with open(outpath, "w") as out:
            n = annotate_file(infile, out, mapping)
    else:
        n = annotate_file(infile, sys.stdout, mapping)
    print(f"Annotated {n} sequences.", file=sys.stderr)
    return 0
