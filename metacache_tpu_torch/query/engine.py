"""Query engine: batched read classification on a torch device.

Counterpart of metacache_tpu/query/engine.py (QueryEngine, EngineBase,
BatchResult, compute_features, local_candidates, _query_batch_device).
Per batch of packed reads:

  host:   fuse the six packed arrays into one buffer (one host->device copy)
  device: sketch (CUDA kernel, or its plain version on the CPU) -> lookup
          in the CSR feature table -> contiguous-window-range candidates
          (local_candidates) -> ranked-LCA vote (classify_tail)
  host:   one device->host copy of the [4, B] summary (best, best_rank,
          match total, overflow); candidate tensors only on demand.

The sharded engine (parallel/sharding.py) runs the same stages, with
local_candidates once per shard and a merge before the vote.

Options of the JAX engine kept here: clade exclusion (set_exclusion: the
matches of each read's own clade are dropped after the lookup's cut, see
ops/lookup.py) and per-candidate window hit counts for -hits-per-seq
(target_window_k > 0).

It runs one tier at lmax = max_locations_per_query over the legacy wire;
the JAX engine's direct tier, slim wire and packed summary give the same
results and are not carried. Dispatch does not block on the device:
QueryProcessor dispatches a window of batches before it materializes the
previous one.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import ClassifyParams, QueryPipelineParams
from ..db.database import Database
from ..db.taxonomy import Rank, rank_from_name
from ..ops import encode
from ..ops.candidates import generate_candidates
from ..ops.classify_op import classify_lca
from ..ops.lookup import LOC_SHIFT, lookup_matches
from ..ops.sketch_cuda import sketch_packed

_CHUNK = 1 << 24


def _to_device_int64(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array (possibly a read-only memmap) -> int64 tensor on
    `device`, copied in chunks so no full-size int64 host copy exists."""
    out = torch.empty(len(arr), dtype=torch.int64, device=device)
    for o in range(0, len(arr), _CHUNK):
        part = np.array(arr[o:o + _CHUNK], dtype=np.int64)
        out[o:o + len(part)] = torch.from_numpy(part)
    return out


def tables_from_database(db: Database, device: torch.device,
                         lowest_rank: int = Rank.SEQUENCE,
                         like: Dict[str, torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """The engine's device tables, from the same numpy arrays the JAX
    engine uploads: sorted feature keys, CSR offsets, locations packed as
    (target << 32 | window), the target -> candidate-taxon map and the
    ranked lineage table. All int64.

    Only the candidate-taxon map depends on lowest_rank: given the tables
    of another rank (`like`, same database and device), the others are
    shared instead of uploaded again."""
    tct = _to_device_int64(db.target_cand_tax(lowest_rank), device)
    if like is not None:
        return dict(like, target_cand_tax=tct)
    return dict(feature_tables(db, device), target_cand_tax=tct,
                ranked_lineage=torch.from_numpy(np.asarray(
                    db.taxonomy.ranked_lineage, dtype=np.int64)).to(device))


def feature_tables(db: Database, device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """The feature table's part of tables_from_database: keys, offsets,
    packed locations (one shard's own, in the sharded engine)."""
    keys, offsets, loc_tgt, loc_win = db.features.device_arrays()
    locations = torch.empty(len(loc_tgt), dtype=torch.int64, device=device)
    for o in range(0, len(loc_tgt), _CHUNK):
        t = np.array(loc_tgt[o:o + _CHUNK], dtype=np.int64)
        w = np.array(loc_win[o:o + _CHUNK], dtype=np.int64)
        locations[o:o + len(t)] = torch.from_numpy((t << LOC_SHIFT) | w)
    return {"keys": _to_device_int64(keys, device),
            "offsets": _to_device_int64(offsets, device),
            "locations": locations}


def make_target_groups(db: Database, rank_code: int) -> np.ndarray:
    """[T+1] int64 map target id -> ancestor taxon at `rank_code` (the
    exclusion group of remove_hits_on_rank, src/classification.cpp:141-157);
    the trailing 0 absorbs the pad."""
    anc = db.taxonomy.ranked_lineage[:, rank_code].astype(np.int64)
    groups = np.zeros(db.target_count + 1, np.int64)
    groups[:-1] = anc[db.target_taxon_node]
    return groups


def compute_features(packed1, ambig1, lens1, packed2, ambig2, lens2, *,
                     k: int, sketch_size: int, window_size: int,
                     starts: Sequence[int]) -> torch.Tensor:
    """Sketches of every window of both mates (accumulate_matches for seq1
    and seq2, src/querying.h:787-790) -> [B, NF] int64,
    NF = 2 * len(starts) * sketch_size. CUDA tensors go to the sketch
    kernel, CPU tensors to its plain version."""
    return torch.cat([
        sketch_packed(p, a, ln, k=k, sketch_size=sketch_size,
                      window_size=window_size, starts=starts)
        for p, a, ln in ((packed1, ambig1, lens1), (packed2, ambig2, lens2))
    ], dim=1)


def fuse_host_inputs(p1, a1, l1, p2, a2, l2) -> np.ndarray:
    """The six per-batch host arrays as ONE uint8 buffer [B, 2*(L/4+L/8+4)]
    (the JAX engine's legacy wire), so a batch costs one host->device
    copy."""
    B = p1.shape[0]
    l1b = np.ascontiguousarray(l1, dtype="<i4").view(np.uint8).reshape(B, 4)
    l2b = np.ascontiguousarray(l2, dtype="<i4").view(np.uint8).reshape(B, 4)
    return np.concatenate([p1, a1, l1b, p2, a2, l2b], axis=1)


def unfuse_device_inputs(fused: torch.Tensor, qlen: int):
    """Inverse of fuse_host_inputs on the device -> contiguous
    (packed1, ambig1, lens1, packed2, ambig2, lens2)."""
    out = []
    o = 0
    for _ in range(2):
        for width in (qlen // 4, qlen // 8):
            out.append(fused[:, o:o + width].contiguous())
            o += width
        out.append(fused[:, o:o + 4].contiguous().view(torch.int32)[:, 0])
        o += 4
    return tuple(out)


def target_window_hits(cand: Dict[str, torch.Tensor], tgt: torch.Tensor,
                       win: torch.Tensor, target_window_k: int
                       ) -> torch.Tensor:
    """Per-candidate window hit counts for the hits-per-target report
    (matches_per_target::insert, src/matches_per_target.h:111-155; JAX
    engine target_window_hits): the number of (cand tgt, cand beg + k),
    k < K, in the read's sorted match list, 0 past the candidate's end
    window. -> [B, C, K] int64. Each count is the distance between the
    two searchsorted bounds of a packed (tgt << 32 | window) word."""
    B, C = cand["tgt"].shape
    qwin = cand["beg"][:, :, None] + torch.arange(target_window_k,
                                                  device=tgt.device)
    q = ((cand["tgt"][:, :, None] << LOC_SHIFT) | qwin).reshape(B, -1)
    row = (tgt << LOC_SHIFT) | win
    counts = (torch.searchsorted(row, q, right=True)
              - torch.searchsorted(row, q)).reshape(qwin.shape)
    return torch.where(qwin <= cand["end"][:, :, None], counts, 0)


def local_candidates(features: torch.Tensor, lens1: torch.Tensor,
                     lens2: torch.Tensor, tables: Dict[str, torch.Tensor],
                     *, window_stride: int, lmax: int, max_candidates: int,
                     insert_size_max: int,
                     exclude_groups: torch.Tensor = None) -> Dict:
    """The per-shard half of a batch (JAX local_candidates after the
    sketch): lookup in one feature table -> candidates. Returns cand
    (dict of [B, C]), the sorted match list tgt / win [B, lmax] and the
    per-read match total / overflow [B]. With exclude_groups [B], tables
    must hold "target_groups" (set_exclusion)."""
    tgt, win, total, overflow = lookup_matches(
        features, tables["keys"], tables["offsets"], tables["locations"],
        lmax, exclude_groups=exclude_groups,
        target_groups=tables.get("target_groups"))
    # maxWindowsInRange = 2 + max(len1+len2, insertSizeMax) / winstride
    # (src/classification.cpp:217-219)
    pair_len = (lens1.long() + lens2.long()).clamp(min=insert_size_max)
    num_windows = 2 + pair_len // window_stride
    cand = generate_candidates(tgt, win, num_windows,
                               tables["target_cand_tax"], max_candidates)
    return {"cand": cand, "tgt": tgt, "win": win, "total": total,
            "overflow": overflow}


def classify_tail(cand: Dict[str, torch.Tensor], total: torch.Tensor,
                  overflow: torch.Tensor, ranked_lineage: torch.Tensor, *,
                  hits_min: int, hits_diff_fraction: float,
                  highest_rank: int) -> Dict:
    """The classification half of a batch: the ranked-LCA vote on the
    (merged) candidates, and the [4, B] summary (best, best_rank, match
    total, overflow) that one device->host copy brings back."""
    best, best_rank = classify_lca(cand["tax"], cand["hits"], ranked_lineage,
                                   hits_min, hits_diff_fraction, highest_rank)
    return {"cand": cand, "best": best, "best_rank": best_rank,
            "match_total": total, "match_overflow": overflow,
            "summary": torch.stack([best, best_rank, total, overflow])}


def upload_batch(p1, a1, lens1, p2, a2, lens2, exclude_groups,
                 devices: Sequence[torch.device]):
    """The six per-batch host arrays fused into one buffer, and the
    optional [B] exclusion groups, copied to each device (one fused
    host->device copy per device, from pinned memory on a card) ->
    {device: (fused, exclude_groups or None)}."""
    fused = torch.from_numpy(fuse_host_inputs(p1, a1, lens1, p2, a2, lens2))
    eg = None if exclude_groups is None else \
        torch.from_numpy(np.asarray(exclude_groups, np.int64))
    if any(d.type == "cuda" for d in devices):
        fused = fused.pin_memory()
        eg = None if eg is None else eg.pin_memory()
    return {d: (fused.to(d, non_blocking=True),
                None if eg is None else eg.to(d, non_blocking=True))
            for d in devices}


def fetch_summary(out: Dict) -> Dict:
    """Queue the summary's device->host copy behind the batch without
    waiting for it: into pinned memory, with an event recorded on the
    summary's device that BatchResult waits for."""
    summary = out.pop("summary")
    if summary.device.type == "cuda":
        host = torch.empty(summary.shape, dtype=summary.dtype,
                           pin_memory=True)
        host.copy_(summary, non_blocking=True)
        with torch.cuda.device(summary.device):
            out["_event"] = torch.cuda.Event()
            out["_event"].record()
        summary = host
    out["_summary_host"] = summary
    return out


class BatchResult:
    """Result of one classified batch (first n rows are valid reads).

    best / best_rank / match_total / match_overflow are host int32 arrays;
    candidate fields (and target_window_hits [B, C, K], None unless the
    engine counts them) are copied from the device on first access."""

    def __init__(self, n: int, out: Dict):
        self.n = n
        ev = out.get("_event")
        if ev is not None:
            ev.synchronize()
        s = out["_summary_host"].numpy().astype(np.int32)
        self.best, self.best_rank, self.match_total, self.match_overflow = s
        self._dev = dict(out["cand"])
        self._dev["target_window_hits"] = out.get("target_window_hits")
        self._host: Dict[str, np.ndarray] = {}

    def _field(self, name: str) -> np.ndarray:
        if name not in self._host:
            v = self._dev[name]
            self._host[name] = None if v is None \
                else v.cpu().numpy().astype(np.int32)
        return self._host[name]

    cand_tax = property(lambda self: self._field("tax"))
    cand_hits = property(lambda self: self._field("hits"))
    cand_beg = property(lambda self: self._field("beg"))
    cand_end = property(lambda self: self._field("end"))
    cand_tgt = property(lambda self: self._field("tgt"))
    target_window_hits = property(
        lambda self: self._field("target_window_hits"))


class EngineBase:
    """What the single and the sharded engine share: the parameters of
    the batch program and the host side of a batch (JAX EngineBase).
    Subclasses provide set_exclusion and dispatch_packed."""

    def __init__(self, db: Database, classify: ClassifyParams,
                 pipeline: QueryPipelineParams, target_window_k: int):
        self.db = db
        self.pipeline = pipeline
        self.target_window_k = target_window_k
        p = db.query_sketch_params
        self.sketch_params = p
        self.update_runtime_thresholds(classify)
        self.lowest_rank = Rank.SEQUENCE if classify.lowest_rank is None \
            else _rank_code(classify.lowest_rank)
        self.highest_rank = _rank_code(classify.highest_rank)
        self.starts = tuple(int(s) for s in encode.window_starts(
            pipeline.max_query_len, p.window_size, p.window_stride))
        self.lmax = pipeline.max_locations_per_query
        self.exclude_rank = Rank.NONE

    def update_runtime_thresholds(self, classify: ClassifyParams):
        """Adopt new hits_min / hits_diff_fraction (runtime scalars)."""
        self.classify = classify
        self.hits_min = classify.resolved_hits_min(
            self.db.sketch_params.sketch_size)

    def _check_exclusion(self, exclude_groups) -> None:
        if exclude_groups is not None and self.exclude_rank == Rank.NONE:
            raise ValueError("exclude_groups given but set_exclusion was "
                             "not called")

    def _sketch(self, fused: torch.Tensor):
        """Unfused inputs on one device -> (features [B, NF], lens1,
        lens2)."""
        p = self.sketch_params
        p1, a1, l1, p2, a2, l2 = unfuse_device_inputs(
            fused, self.pipeline.max_query_len)
        return compute_features(p1, a1, l1, p2, a2, l2, k=p.kmer_size,
                                sketch_size=p.sketch_size,
                                window_size=p.window_size,
                                starts=self.starts), l1, l2

    def _candidates(self, features, lens1, lens2, tables, exclude_groups):
        return local_candidates(
            features, lens1, lens2, tables,
            window_stride=self.sketch_params.window_stride, lmax=self.lmax,
            max_candidates=self.classify.max_candidates,
            insert_size_max=self.classify.insert_size_max,
            exclude_groups=exclude_groups)

    def _classify(self, cand, total, overflow, ranked_lineage) -> Dict:
        return classify_tail(
            cand, total, overflow, ranked_lineage, hits_min=self.hits_min,
            hits_diff_fraction=self.classify.hits_diff_fraction,
            highest_rank=self.highest_rank)

    def exclusion_group_of(self, node: int) -> int:
        if node == 0:
            return 0
        return int(self.db.taxonomy.ranked_lineage[node, self.exclude_rank])

    def make_host_buffers(self):
        B, L = self.pipeline.batch_size, self.pipeline.max_query_len
        return (np.zeros((B, L), np.uint8), np.zeros(B, np.int32),
                np.zeros((B, L), np.uint8), np.zeros(B, np.int32))

    def classify_batch(self, codes1, lens1, codes2, lens2, n: int,
                       exclude_groups=None) -> BatchResult:
        """Classify a (padded) batch of 2-bit codes; first n rows valid."""
        p1, a1 = encode.np_pack_codes(codes1)
        p2, a2 = encode.np_pack_codes(codes2)
        return self.materialize(
            self.dispatch_packed(p1, a1, lens1, p2, a2, lens2,
                                 exclude_groups=exclude_groups), n)

    def materialize(self, out: Dict, n: int) -> BatchResult:
        return BatchResult(n, out)

    def materialize_many(self, items: List[Tuple[Dict, int]]
                         ) -> List[BatchResult]:
        """items: [(out, n), ...] from dispatch_packed, in dispatch order."""
        return [BatchResult(n, out) for out, n in items]


class QueryEngine(EngineBase):
    """Device-resident database tables + the batch pipeline."""

    def __init__(self, db: Database, classify: ClassifyParams,
                 pipeline: QueryPipelineParams = QueryPipelineParams(),
                 device: torch.device = torch.device("cpu"),
                 target_window_k: int = 0,
                 tables: Dict[str, torch.Tensor] = None):
        """`tables`: device tables of this database for this lowest rank,
        already uploaded (tables_from_database), to share them."""
        super().__init__(db, classify, pipeline, target_window_k)
        self.device = device
        self.tables = tables if tables is not None else \
            tables_from_database(db, device, self.lowest_rank)

    def set_exclusion(self, rank_code: int):
        """Enable clade exclusion on `rank_code`: per-read exclusion groups
        (exclusion_group_of each read's ground truth) must then be passed
        to dispatch_packed / classify_batch."""
        self.tables = dict(self.tables, target_groups=torch.from_numpy(
            make_target_groups(self.db, rank_code)).to(self.device))
        self.exclude_rank = rank_code

    def dispatch_packed(self, p1, a1, lens1, p2, a2, lens2,
                        exclude_groups=None) -> Dict:
        """Enqueue one packed batch; returns without waiting for the
        device. The summary's device->host copy is queued behind it.
        exclude_groups: optional host [B] clade per read (set_exclusion)."""
        self._check_exclusion(exclude_groups)
        fused, eg = upload_batch(p1, a1, lens1, p2, a2, lens2,
                                 exclude_groups, [self.device])[self.device]
        features, l1, l2 = self._sketch(fused)
        loc = self._candidates(features, l1, l2, self.tables, eg)
        out = self._classify(loc["cand"], loc["total"], loc["overflow"],
                             self.tables["ranked_lineage"])
        if self.target_window_k:
            out["target_window_hits"] = target_window_hits(
                loc["cand"], loc["tgt"], loc["win"], self.target_window_k)
        return fetch_summary(out)


def _rank_code(rank) -> int:
    return rank if isinstance(rank, int) else rank_from_name(rank)


def encode_read_into(buf_codes: np.ndarray, buf_lens: np.ndarray, row: int,
                     data: str, max_len: int):
    """Encode one read into a host batch buffer row (truncating at
    max_len); the rest of the row is ambiguous padding."""
    codes = encode.np_encode_bytes(
        np.frombuffer(data[:max_len].encode(), dtype=np.uint8))
    buf_codes[row, :len(codes)] = codes
    buf_codes[row, len(codes):] = encode.AMBIG_CODE
    buf_lens[row] = len(codes)
