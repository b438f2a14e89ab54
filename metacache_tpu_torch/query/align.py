"""Semi-global alignment for the '-align' display option.

Transcribed semantics of align_semi_global (src/alignment.h:176-279) and
make_semi_global_alignment (src/classification.cpp:77-103): match +2,
mismatch -1, gap -1; best score over the last row/column; backtrace with
tie priority diagonal > up > left; the query (and its mate) are also
aligned reverse-complemented and the better total score wins.

Host-side numpy (display path only — one alignment per mapped read when
the flag is on). The DP rows are vectorized; the in-row gap chain uses the
prefix-max identity row[s] = max_k<=s (base[k] - (s-k)).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

MATCH = 2
MISMATCH = -1
GAP = -1

_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def reverse_complement(s: str) -> str:
    return s.translate(_COMP)[::-1]


def _score_matrix_exact(query: str, subject: str) -> np.ndarray:
    """Straightforward DP (row loop, vectorized columns where possible)."""
    lq, ls = len(query), len(subject)
    q = np.frombuffer(query.encode(), dtype=np.uint8)
    s = np.frombuffer(subject.encode(), dtype=np.uint8)
    match = np.where(s[None, :] == q[:, None], MATCH, MISMATCH).astype(
        np.int32)
    score = np.zeros((lq + 1, ls + 1), dtype=np.int32)
    ar = np.arange(ls, dtype=np.int64)
    for i in range(1, lq + 1):
        base = np.maximum(score[i - 1, :-1] + match[i - 1],
                          score[i - 1, 1:] + GAP)
        # include the left-gap chain exactly:
        # row[s] = max_{k<=s}(base[k] + GAP*(s-k)) with GAP = -1
        acc = np.maximum.accumulate(base + ar)
        score[i, 1:] = acc - ar
    return score


def align_semi_global(query: str, subject: str,
                      backtrace: bool = True):
    """Returns (score, query_aligned, subject_aligned)."""
    lq, ls = len(query), len(subject)
    if lq == 0 or ls == 0:
        return 0, "", ""
    score = _score_matrix_exact(query, subject)

    # best score over last column (q in 1..lq-1), then last row
    # (src/alignment.h:230-251: starts from the corner, strict >)
    bq, bs = lq, ls
    bv = int(score[lq, ls])
    for qq in range(1, lq):
        if score[qq, ls] > bv:
            bq, bs, bv = qq, ls, int(score[qq, ls])
    for ss in range(1, ls):
        if score[lq, ss] > bv:
            bq, bs, bv = lq, ss, int(score[lq, ss])

    if not backtrace:
        return bv, "", ""

    qa, sa = [], []
    qq, ss = bq, bs
    while qq > 0 and ss > 0:
        v = score[qq, ss]
        m = MATCH if query[qq - 1] == subject[ss - 1] else MISMATCH
        # tie priority diag > up > left (relax(), src/alignment.h:100-123)
        if v == score[qq - 1, ss - 1] + m:
            qa.append(query[qq - 1])
            sa.append(subject[ss - 1])
            qq -= 1
            ss -= 1
        elif v == score[qq - 1, ss] + GAP:
            qa.append(query[qq - 1])
            sa.append("_")
            qq -= 1
        else:
            qa.append("_")
            sa.append(subject[ss - 1])
            ss -= 1
    return bv, "".join(reversed(qa)), "".join(reversed(sa))


def best_alignment_for_query(seq1: str, seq2: str, subject: str):
    """make_semi_global_alignment (src/classification.cpp:77-103): align
    forward and reverse-complement (incl. mate scores); return the better
    direction's alignment of seq1."""
    score_f, qa_f, sa_f = align_semi_global(seq1, subject)
    total_f = score_f
    score_r, qa_r, sa_r = align_semi_global(reverse_complement(seq1), subject)
    total_r = score_r
    if seq2:
        total_f += align_semi_global(seq2, subject, backtrace=False)[0]
        total_r += align_semi_global(reverse_complement(seq2), subject,
                                     backtrace=False)[0]
    if total_f > total_r:
        return score_f, qa_f, sa_f
    return score_r, qa_r, sa_r
