"""Query engine: batched read classification on a torch device.

Counterpart of metacache_tpu/query/engine.py (QueryEngine, EngineBase,
BatchResult, compute_features, local_candidates, _query_batch_device).
Per batch of packed reads:

  host:   fuse the six packed arrays into one reused pinned buffer (one
          host->device copy)
  device: sketch (CUDA kernel, or its plain version on the CPU) -> lookup
          in the CSR feature table -> contiguous-window-range candidates
          (local_candidates) -> ranked-LCA vote (classify_tail)
  host:   one device->host copy of the [4, B] summary (best, best_rank,
          match total, overflow) into a reused pinned buffer; candidate
          tensors only on demand.

The sharded engine (parallel/sharding.py) runs the same stages, with
local_candidates once per shard and a merge before the vote.

Options of the JAX engine kept here: clade exclusion (set_exclusion: the
matches of each read's own clade are dropped after the lookup's cut, see
ops/lookup.py) and per-candidate window hit counts for -hits-per-seq
(target_window_k > 0).

It runs one tier at lmax = max_locations_per_query over the legacy wire;
the JAX engine's direct tier, slim wire and packed summary give the same
results and are not carried. Dispatch does not block on the device:
QueryProcessor dispatches batches on one thread and materializes them on
another.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ClassifyParams, QueryPipelineParams
from ..db.database import Database
from ..db.taxonomy import Rank, rank_from_name
from ..device import resolve_device
from ..ops import encode
from ..ops.candidates import generate_candidates
from ..ops.classify_op import classify_lca
from ..ops.lookup import LOC_SHIFT, lookup_matches
from ..ops.sketch_cuda import sketch_packed
from . import upload


def tables_from_database(db: Database, device: torch.device,
                         lowest_rank: int = Rank.SEQUENCE,
                         like: Dict[str, torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """The engine's device tables, from the same numpy arrays the JAX
    engine uploads: sorted feature keys, CSR offsets, locations packed as
    (target << 32 | window), the target -> candidate-taxon map and the
    ranked lineage table. All int64, streamed up by query/upload.py; a
    database of several shards not yet merged on the host is merged on
    the device.

    Only the candidate-taxon map depends on lowest_rank: given the tables
    of another rank (`like`, same database and device), the others are
    shared instead of uploaded again."""
    with upload.Stager(device) as stager:
        tct = upload.upload_int64(stager, db.target_cand_tax(lowest_rank))
        if like is not None:
            return dict(like, target_cand_tax=tct)
        lineage = np.asarray(db.taxonomy.ranked_lineage)
        return dict(upload.feature_tables(stager, db.shard_features()),
                    target_cand_tax=tct,
                    ranked_lineage=upload.upload_int64(
                        stager, lineage.ravel()).view(lineage.shape))


def feature_tables(db: Database, device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """The feature table's part of tables_from_database: keys, offsets,
    packed locations (one shard's own, in the sharded engine)."""
    with upload.Stager(device) as stager:
        return upload.feature_tables(stager, db.shard_features())


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


def fuse_host_inputs(p1, a1, l1, p2, a2, l2, out=None) -> np.ndarray:
    """The six per-batch host arrays as ONE uint8 buffer [B, 2*(L/4+L/8+4)]
    (the JAX engine's legacy wire), so a batch costs one host->device
    copy; written into `out` when given."""
    B = p1.shape[0]
    l1b = np.ascontiguousarray(l1, dtype="<i4").view(np.uint8).reshape(B, 4)
    l2b = np.ascontiguousarray(l2, dtype="<i4").view(np.uint8).reshape(B, 4)
    return np.concatenate([p1, a1, l1b, p2, a2, l2b], axis=1, out=out)


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


class PinnedSlot:
    """Pinned host buffers, by name, and one event per card, recorded
    after the copies that read or fill them: a slot is written again only
    after its events."""

    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.events: Dict[torch.device, torch.cuda.Event] = {}

    def buffer(self, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
        b = self.buffers.get(name)
        if b is None or tuple(b.shape) != tuple(shape) or b.dtype != dtype:
            b = self.buffers[name] = torch.empty(shape, dtype=dtype,
                                                 pin_memory=True)
        return b

    def record(self, devices: Sequence[torch.device]) -> None:
        """Events on each card's current stream, after the copies queued
        there."""
        for d in devices:
            ev = self.events.get(d)
            if ev is None:
                ev = self.events[d] = torch.cuda.Event()
            with torch.cuda.device(d):
                ev.record()

    def done(self) -> bool:
        return all(ev.query() for ev in self.events.values())

    def wait(self) -> None:
        for ev in self.events.values():
            ev.synchronize()


class HostStaging:
    """The pinned slots a card's batch inputs are staged through, reused
    in turn: the next slot is the oldest once its copies are done, else a
    new one, up to MAX_SLOTS (then the oldest, after its copies)."""

    MAX_SLOTS = 32

    def __init__(self):
        self._ring: "collections.deque[PinnedSlot]" = collections.deque()

    def next(self) -> PinnedSlot:
        ring = self._ring
        if ring and (len(ring) >= self.MAX_SLOTS or ring[0].done()):
            slot = ring.popleft()
            slot.wait()
        else:
            slot = PinnedSlot()
        ring.append(slot)
        return slot


class SummaryPool:
    """Pinned slots the batch summaries come back to the host in: a slot
    is taken by fetch_summary and given back by BatchResult once it has
    read it (after the slot's event), so it may be taken and given on
    different threads."""

    def __init__(self):
        self._free: "collections.deque[PinnedSlot]" = collections.deque()

    def take(self) -> PinnedSlot:
        try:
            return self._free.pop()
        except IndexError:
            return PinnedSlot()

    def give(self, slot: PinnedSlot) -> None:
        self._free.append(slot)


def upload_batch(p1, a1, lens1, p2, a2, lens2, exclude_groups,
                 devices: Sequence[torch.device], staging: HostStaging):
    """The six per-batch host arrays fused into one buffer, and the
    optional [B] exclusion groups, copied to each device (one fused
    host->device copy per device; on a card, from a pinned slot of
    `staging` the arrays are fused straight into) -> {device: (fused,
    exclude_groups or None)}. The devices are all cards or all the CPU."""
    if not any(d.type == "cuda" for d in devices):
        fused = torch.from_numpy(fuse_host_inputs(p1, a1, lens1, p2, a2,
                                                  lens2))
        eg = None if exclude_groups is None else \
            torch.from_numpy(np.asarray(exclude_groups, np.int64))
        return {d: (fused, eg) for d in devices}
    slot = staging.next()
    width = sum(x.shape[1] for x in (p1, a1, p2, a2)) + 8
    fused = slot.buffer("fused", (p1.shape[0], width), torch.uint8)
    fuse_host_inputs(p1, a1, lens1, p2, a2, lens2, out=fused.numpy())
    eg = None
    if exclude_groups is not None:
        eg = slot.buffer("groups", (len(exclude_groups),), torch.int64)
        eg.numpy()[:] = exclude_groups
    on = {d: (fused.to(d, non_blocking=True),
              None if eg is None else eg.to(d, non_blocking=True))
          for d in devices}
    slot.record(devices)
    return on


def fetch_summary(out: Dict, pool: SummaryPool) -> Dict:
    """Queue the summary's device->host copy behind the batch without
    waiting for it: into a pinned slot of `pool`, whose event, recorded
    on the summary's device, BatchResult waits for."""
    summary = out.pop("summary")
    if summary.device.type == "cuda":
        slot = pool.take()
        host = slot.buffer("summary", summary.shape, summary.dtype)
        host.copy_(summary, non_blocking=True)
        slot.record([summary.device])
        out["_summary_slot"] = (pool, slot)
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
        held = out.pop("_summary_slot", None)
        if held is not None:
            held[1].wait()
        s = out["_summary_host"].numpy().astype(np.int32)
        if held is not None:   # the slot is read: back to its pool
            out["_summary_host"] = torch.from_numpy(s)
            held[0].give(held[1])
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
        self.staging = HostStaging()
        self.summaries = SummaryPool()

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
                 device: Optional[torch.device] = None,
                 target_window_k: int = 0,
                 tables: Dict[str, torch.Tensor] = None):
        """`device`: where the tables live and the batches run; the card
        unless the CPU is given (raises when there is no card). `tables`:
        device tables of this database for this lowest rank, already
        uploaded (tables_from_database), to share them."""
        super().__init__(db, classify, pipeline, target_window_k)
        self.device = resolve_device("cuda") if device is None else device
        self.tables = tables if tables is not None else \
            tables_from_database(db, self.device, self.lowest_rank)

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
                                 exclude_groups, [self.device],
                                 self.staging)[self.device]
        features, l1, l2 = self._sketch(fused)
        loc = self._candidates(features, l1, l2, self.tables, eg)
        out = self._classify(loc["cand"], loc["total"], loc["overflow"],
                             self.tables["ranked_lineage"])
        if self.target_window_k:
            out["target_window_hits"] = target_window_hits(
                loc["cand"], loc["tgt"], loc["win"], self.target_window_k)
        return fetch_summary(out, self.summaries)


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
