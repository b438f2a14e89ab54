"""Global configuration: dtypes, sketching defaults, classification defaults.

Mirrors the reference's two-tier config system (compile-time types in
``src/config.h:44-135`` + runtime option structs) as plain dataclasses.

Reference defaults (cited):
  - k=16, sketch=16, window=128, stride=113   (src/mode_build.cpp:65-68)
  - max locations per feature = 254           (src/sketch_database.h:375-378,
                                               bucket_size_type=uint8, cap = 255-1)
  - max candidates per query = 2              (src/query_options.h:135)
  - hitsDiffFraction = 1.0                    (src/query_options.h:129)
  - hitsMin deduced from sketch size s:
      s>=6 -> s/3, s>=4 -> 2, else 1          (src/mode_query.cpp:247-260)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# ----------------------------------------------------------------------------
# dtype configuration (reference: src/config.h:44-135)
#   kmer_type   = uint32  (k <= 16)
#   feature     = uint32  (hash of kmer)
#   target_id   = uint32  (MEDIUM_TARGETS build, CMakeLists.txt:25-28)
#   window_id   = uint32
#   bucket size = uint8   => max 254 locations per feature
# On device we use int32 for target/window ids (XLA-native), uint32 features.
# ----------------------------------------------------------------------------
KMER_DTYPE = np.uint32
FEATURE_DTYPE = np.uint32
TARGET_DTYPE = np.int32
WINDOW_DTYPE = np.int32

#: sentinel for "no feature" — the reference's sketch fill value ``feature_type(~0)``
#: (src/hash_dna.h:126). A hash value equal to this can never enter a sketch
#: (insert requires ``h < sketch.back()``), so it is safe as padding.
FEATURE_SENTINEL = np.uint32(0xFFFFFFFF)

#: sentinel target id used to pad match lists (sorts after all real targets)
TARGET_SENTINEL = np.int32(2**31 - 1)

#: max locations per feature representable (reference bucket_size uint8 => 255-1,
#: src/sketch_database.h:375-378)
MAX_SUPPORTED_LOCS_PER_FEATURE = 254

#: database format version of this framework's shard files
DB_FORMAT_VERSION = 1

#: reference binary DB version we mirror semantics of (src/version.h:29)
REFERENCE_DB_VERSION = 20181001


@dataclasses.dataclass(frozen=True)
class SketchParams:
    """Sketching parameters (reference: src/mode_build.cpp:63-68, hash_dna.h:75)."""
    kmer_size: int = 16
    sketch_size: int = 16
    window_size: int = 128
    window_stride: int = 113  # = window_size - kmer_size + 1

    def __post_init__(self):
        if not (1 <= self.kmer_size <= 16):
            raise ValueError("kmer_size must be in [1,16] (32-bit kmers)")
        if self.sketch_size < 1:
            raise ValueError("sketch_size must be >= 1")
        if self.window_stride < 1:
            raise ValueError("window_stride must be >= 1")

    @property
    def kmers_per_window(self) -> int:
        return self.window_size - self.kmer_size + 1


@dataclasses.dataclass(frozen=True)
class BuildParams:
    """Database build parameters (reference: src/mode_build.cpp:63-84)."""
    sketch: SketchParams = dataclasses.field(default_factory=SketchParams)
    max_locations_per_feature: int = MAX_SUPPORTED_LOCS_PER_FEATURE
    remove_overpopulated_features: bool = False
    # remove features with more than this many distinct taxa on a rank
    remove_ambig_features_rank: Optional[str] = None   # rank name or None
    max_taxa_per_feature: int = 1


@dataclasses.dataclass(frozen=True)
class ClassifyParams:
    """Classification parameters (reference: src/query_options.h:123-136)."""
    lowest_rank: str = "sequence"
    highest_rank: str = "domain"
    hits_min: int = 0            # 0 => deduce from sketch size
    hits_diff_fraction: float = 1.0
    insert_size_max: int = 0
    max_candidates: int = 2

    def resolved_hits_min(self, sketch_size: int) -> int:
        """Deduce hit threshold from sketch size (src/mode_query.cpp:247-260)."""
        if self.hits_min >= 1:
            return self.hits_min
        if sketch_size >= 6:
            return int(sketch_size / 3.0)
        if sketch_size >= 4:
            return 2
        return 1


@dataclasses.dataclass(frozen=True)
class QueryPipelineParams:
    """Fixed shapes of the query pipeline on the card.

    The reference keeps an unbounded std::vector of matches per read; the
    port pads every batch to fixed shapes, so each batch's kernels and
    torch ops keep one shape and their allocations are reused.
    ``max_locations_per_query`` bounds the per-read match list (the
    location gather's [batch, slots] output). If a read's matches exceed
    it, the tail features' locations are dropped deterministically and a
    counter is incremented (visible in query stats).
    """
    batch_size: int = 4096
    max_query_len: int = 320      # reads padded/bucketed to this length
    max_locations_per_query: int = 2048
