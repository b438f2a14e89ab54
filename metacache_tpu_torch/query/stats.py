"""Classification statistics accumulator.

Mirrors classification_statistics (src/classification_statistics.h:40-235):
per-rank cumulative assignment counters (a rank-r assignment increments all
ranks r..root), ground-truth known/correct/wrong counters, and the derived
rates used by the report printer. Vectorized over batches.
"""
from __future__ import annotations

import numpy as np

from ..db.taxonomy import Rank

_NR = Rank.NUM_RANKS + 1  # ranks 0..20 plus 'none' at index 21


class ConfusionStatistics:
    """src/stat_confusion.h:37 — TP/FP/TN/FN counters."""

    def __init__(self):
        self.tp = 0
        self.fp = 0
        self.tn = 0
        self.fn = 0

    def total(self) -> int:
        return self.tp + self.fp + self.tn + self.fn

    def false_pos(self) -> int:
        return self.fp


class ClassificationStatistics:
    def __init__(self):
        self.assigned_ = np.zeros(_NR, dtype=np.int64)
        self.known_ = np.zeros(_NR, dtype=np.int64)
        self.correct_ = np.zeros(_NR, dtype=np.int64)
        self.wrong_ = np.zeros(_NR, dtype=np.int64)
        self.coverage_ = [ConfusionStatistics() for _ in range(_NR)]

    # ------------------------------------------------------------- updates
    def assign(self, assigned_rank: int):
        if assigned_rank >= Rank.NUM_RANKS:
            self.assigned_[Rank.NUM_RANKS] += 1
        else:
            self.assigned_[assigned_rank:Rank.ROOT + 1] += 1

    def assign_batch(self, assigned_ranks: np.ndarray):
        """Vectorized assign() over a batch of rank codes."""
        counts = np.bincount(assigned_ranks, minlength=_NR)
        self.assigned_[Rank.NUM_RANKS] += counts[Rank.NUM_RANKS:].sum()
        # cumulative: assignment at rank r counts for all r' >= r
        per_rank = counts[:Rank.ROOT + 1]
        self.assigned_[:Rank.ROOT + 1] += np.cumsum(per_rank)

    def assign_known_correct(self, assigned: int, known: int, correct: int):
        """(src/classification_statistics.h:92-120)"""
        self.assign(assigned)
        if correct < assigned:
            correct = assigned
        if correct < known:
            correct = known
        if known >= Rank.NUM_RANKS:
            self.known_[Rank.NUM_RANKS] += 1
        else:
            self.known_[known:Rank.ROOT + 1] += 1
            if correct >= Rank.NUM_RANKS:
                self.correct_[Rank.NUM_RANKS] += 1
            else:
                self.correct_[correct:Rank.ROOT + 1] += 1
            if correct > known and correct > assigned:
                self.wrong_[Rank.SEQUENCE:correct] += 1

    def count_coverage_true_pos(self, r):
        self.coverage_[r].tp += 1

    def count_coverage_false_pos(self, r):
        self.coverage_[r].fp += 1

    def count_coverage_true_neg(self, r):
        self.coverage_[r].tn += 1

    def count_coverage_false_neg(self, r):
        self.coverage_[r].fn += 1

    def coverage(self, r) -> ConfusionStatistics:
        return self.coverage_[r]

    # ------------------------------------------------------------- queries
    def assigned(self, r: int = Rank.ROOT) -> int:
        return int(self.assigned_[r])

    def unassigned(self) -> int:
        return int(self.assigned_[Rank.NUM_RANKS])

    def total(self) -> int:
        return self.assigned() + self.unassigned()

    def known(self, r: int = Rank.ROOT) -> int:
        return int(self.known_[r])

    def unknown(self) -> int:
        return int(self.known_[Rank.NUM_RANKS])

    def correct(self, r: int = Rank.ROOT) -> int:
        return int(self.correct_[r])

    def wrong(self, r: int = Rank.ROOT) -> int:
        return int(self.wrong_[r])

    # --------------------------------------------------------------- rates
    def known_rate(self, r: int = Rank.ROOT) -> float:
        return self.known(r) / self.total() if self.total() > 0 else 0.0

    def unknown_rate(self) -> float:
        return self.unknown() / self.total() if self.total() > 0 else 0.0

    def classification_rate(self, r: int) -> float:
        return self.assigned(r) / self.total() if self.total() > 0 else 0.0

    def unclassified_rate(self) -> float:
        return self.unassigned() / self.total() if self.total() > 0 else 0.0

    def sensitivity(self, r: int) -> float:
        return self.correct(r) / self.known(r) if self.known(r) > 0 else 0.0

    def precision(self, r: int) -> float:
        tot = self.correct(r) + self.wrong(r)
        return self.correct(r) / tot if tot > 0 else 0.0
