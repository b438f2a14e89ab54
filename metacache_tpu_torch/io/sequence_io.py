"""Sequence I/O: FASTA/FASTQ readers, paired-end pairing modes, and NCBI
accession extraction.

Reference: src/sequence_io.{h,cpp}. Behaviors mirrored:
  - format sniffing by first non-blank char '>' (fasta) / '@' (fastq)
    with extension hints (src/sequence_io.cpp:527-560)
  - fasta: multi-line sequences concatenated; fastq: 4-line records
  - pairing modes: none / files (two files in lock-step) / sequences
    (consecutive records in one file) (src/sequence_io.cpp:397-520)
  - accession extraction rules incl. the prefix table
    (src/sequence_io.cpp:43-58, :567-750)
"""
from __future__ import annotations

import gzip
import io as _stdio
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

# (src/sequence_io.cpp:43-58)
ACCESSION_PREFIXES = [
    "GCF_",
    "AC_",
    "NC_", "NG_", "NS_", "NT_", "NW_", "NZ_",
    "MKHE",
    "AE", "AJ", "AL", "AM", "AP", "AY",
    "BA", "BK", "BX",
    "CC", "CM", "CP", "CR", "CT", "CU",
    "FM", "FN", "FO", "FP", "FQ", "FR",
    "HE",
    "JH",
]


@dataclass
class SequenceRecord:
    header: str = ""
    data: str = ""
    qualities: str = ""
    index: int = 0  # 1-based index within its file

    @property
    def empty(self) -> bool:
        return not self.header or not self.data


class FormatError(RuntimeError):
    pass


def _open_text(filename: str):
    if filename.endswith(".gz"):
        return _stdio.TextIOWrapper(gzip.open(filename, "rb"))
    return open(filename, "r")


def read_fasta(filename: str) -> Iterator[SequenceRecord]:
    idx = 0
    header = None
    chunks: List[str] = []
    with _open_text(filename) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                if header is not None:
                    idx += 1
                    yield SequenceRecord(header, "".join(chunks), "", idx)
                header = line[1:]
                chunks = []
            else:
                if header is None and line:
                    raise FormatError(
                        "malformed fasta file - expected header char > "
                        "not found")
                chunks.append(line)
        if header is not None:
            idx += 1
            yield SequenceRecord(header, "".join(chunks), "", idx)


def read_fastq(filename: str) -> Iterator[SequenceRecord]:
    idx = 0
    with _open_text(filename) as f:
        while True:
            h = f.readline()
            if not h:
                return
            h = h.rstrip("\n").rstrip("\r")
            if not h:
                return
            if not h.startswith("@"):
                raise FormatError(
                    "malformed fastq file - sequence header: " + h)
            data = f.readline().rstrip("\n").rstrip("\r")
            plus = f.readline().rstrip("\n").rstrip("\r")
            if not plus.startswith("+"):
                raise FormatError(
                    "malformed fastq file - quality header: " + plus)
            quals = f.readline().rstrip("\n").rstrip("\r")
            idx += 1
            yield SequenceRecord(h[1:], data, quals, idx)


def sniff_format(filename: str) -> str:
    """'fasta' or 'fastq' — extension hints, then content
    (src/sequence_io.cpp:527-560)."""
    low = filename.lower()
    for ext in (".gz",):
        if low.endswith(ext):
            low = low[: -len(ext)]
    if low.endswith((".fa", ".fasta", ".fna", ".ffn", ".faa", ".frn")):
        return "fasta"
    if low.endswith((".fq", ".fastq")):
        return "fastq"
    with _open_text(filename) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            if s[0] == ">":
                return "fasta"
            if s[0] == "@":
                return "fastq"
            break
    raise FormatError(f"file format not recognized: {filename}")


def read_sequences(filename: str) -> Iterator[SequenceRecord]:
    fmt = sniff_format(filename)
    return read_fasta(filename) if fmt == "fasta" else read_fastq(filename)


def read_sequence_pairs(filename1: str, filename2: Optional[str],
                        pairing: str) -> Iterator[Tuple[SequenceRecord,
                                                        Optional[SequenceRecord]]]:
    """Yield (read1, read2 or None) according to the pairing mode
    (sequence_pair_reader, src/sequence_io.cpp:397-520).

    pairing: 'none' | 'files' | 'sequences'
    """
    if pairing == "none" or not pairing:
        for r in read_sequences(filename1):
            yield r, None
    elif pairing == "sequences":
        it = read_sequences(filename1)
        for r1 in it:
            r2 = next(it, None)
            yield r1, r2
    elif pairing == "files":
        if not filename2:
            raise ValueError("pairing mode 'files' requires two filenames")
        it1 = read_sequences(filename1)
        it2 = read_sequences(filename2)
        for r1 in it1:
            r2 = next(it2, None)
            yield r1, r2
    else:
        raise ValueError(f"unknown pairing mode {pairing!r}")


# ---------------------------------------------------------------------------
# accession / taxid extraction from headers (src/sequence_io.cpp:567-750)
# ---------------------------------------------------------------------------
_SEPARATORS = "| -_,"


def _end_of_accession(text: str, start: int = 0) -> int:
    if start >= len(text):
        return len(text)
    for sep in "| -_,":
        k = text.find(sep, start)
        if k != -1:
            return k
    return len(text)


def extract_ncbi_accession_version(text: str) -> str:
    """accession.version, e.g. 'NC_001422.1' (sequence_io.cpp:609-646)."""
    if len(text) < 2:
        return ""
    for prefix in ACCESSION_PREFIXES:
        i = text.find(prefix)
        if i == -1:
            continue
        s = text.find(".", i + len(prefix))
        if s == -1 or (s - i) > 25:
            continue
        k = _end_of_accession(text, s + 1)
        return text[i:k].strip()
    s = text.find(".", 1)
    if 0 <= s < 25:
        return text[0:_end_of_accession(text, s + 1)].strip()
    return ""


def extract_ncbi_accession(text: str) -> str:
    """accession without version (sequence_io.cpp:651-684)."""
    if not text:
        return ""
    for prefix in ACCESSION_PREFIXES:
        i = text.find(prefix)
        if i == -1:
            continue
        j = i + len(prefix)
        k = _end_of_accession(text, j)
        l = text.find(".", j)
        if l != -1 and l < k:
            k = l
        return text[i:k].strip()
    return ""


def extract_genbank_identifier(text: str) -> str:
    """'gi|12345|...' -> '12345' (sequence_io.cpp:689-707)."""
    i = text.find("gi|")
    if i == -1:
        return ""
    i += 3
    j = text.find("|", i)
    if j == -1:
        j = text.find(" ", i)
        if j == -1:
            j = len(text)
    return text[i:j].strip()


def extract_accession_string(text: str) -> str:
    return (extract_ncbi_accession_version(text)
            or extract_ncbi_accession(text)
            or extract_genbank_identifier(text))


def extract_taxon_id(text: str) -> int:
    """'...taxid|12345...' -> 12345 (sequence_io.cpp:730-750)."""
    i = text.find("taxid")
    if i == -1:
        return 0
    i += 6  # skip 'taxid' + one separator char
    j = text.find("|", i)
    if j == -1:
        j = text.find(" ", i)
        if j == -1:
            j = len(text)
    try:
        return int(text[i:j])
    except ValueError:
        return 0
