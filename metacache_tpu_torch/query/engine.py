"""Query engine: batched read classification on a torch device.

Counterpart of metacache_tpu/query/engine.py (QueryEngine, EngineBase,
BatchResult, compute_features, local_candidates, _query_batch_device).
Per batch of packed reads:

  host:   fuse the six packed arrays into one buffer (one host->device copy)
  device: sketch (CUDA kernel, or its plain version on the CPU) -> lookup
          in the CSR feature table -> contiguous-window-range candidates ->
          ranked-LCA vote
  host:   one device->host copy of the [4, B] summary (best, best_rank,
          match total, overflow); candidate tensors only on demand.

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

from metacache_tpu.config import ClassifyParams, QueryPipelineParams
from metacache_tpu.db.database import Database
from metacache_tpu.db.taxonomy import Rank, rank_from_name

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
                         lowest_rank: int = Rank.SEQUENCE
                         ) -> Dict[str, torch.Tensor]:
    """The engine's device tables, from the same numpy arrays the JAX
    engine uploads: sorted feature keys, CSR offsets, locations packed as
    (target << 32 | window), the target -> candidate-taxon map and the
    ranked lineage table. All int64."""
    keys, offsets, loc_tgt, loc_win = db.features.device_arrays()
    locations = torch.empty(len(loc_tgt), dtype=torch.int64, device=device)
    for o in range(0, len(loc_tgt), _CHUNK):
        t = np.array(loc_tgt[o:o + _CHUNK], dtype=np.int64)
        w = np.array(loc_win[o:o + _CHUNK], dtype=np.int64)
        locations[o:o + len(t)] = torch.from_numpy((t << LOC_SHIFT) | w)
    return {
        "keys": _to_device_int64(keys, device),
        "offsets": _to_device_int64(offsets, device),
        "locations": locations,
        "target_cand_tax": _to_device_int64(
            db.target_cand_tax(lowest_rank), device),
        "ranked_lineage": torch.from_numpy(np.asarray(
            db.taxonomy.ranked_lineage, dtype=np.int64)).to(device),
    }


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


def query_batch(packed1, ambig1, lens1, packed2, ambig2, lens2,
                tables: Dict[str, torch.Tensor], *, k: int,
                sketch_size: int, window_size: int, window_stride: int,
                starts: Sequence[int], lmax: int, max_candidates: int,
                insert_size_max: int, hits_min: int,
                hits_diff_fraction: float, highest_rank: int) -> Dict:
    """One batch: packed reads -> classification (the port of
    _query_batch_device / local_candidates)."""
    features = compute_features(
        packed1, ambig1, lens1, packed2, ambig2, lens2, k=k,
        sketch_size=sketch_size, window_size=window_size, starts=starts)
    tgt, win, total, overflow = lookup_matches(
        features, tables["keys"], tables["offsets"], tables["locations"],
        lmax)
    # maxWindowsInRange = 2 + max(len1+len2, insertSizeMax) / winstride
    # (src/classification.cpp:217-219)
    pair_len = (lens1.long() + lens2.long()).clamp(min=insert_size_max)
    num_windows = 2 + pair_len // window_stride
    cand = generate_candidates(tgt, win, num_windows,
                               tables["target_cand_tax"], max_candidates)
    best, best_rank = classify_lca(cand["tax"], cand["hits"],
                                   tables["ranked_lineage"], hits_min,
                                   hits_diff_fraction, highest_rank)
    return {"cand": cand, "best": best, "best_rank": best_rank,
            "match_total": total, "match_overflow": overflow}


class BatchResult:
    """Result of one classified batch (first n rows are valid reads).

    best / best_rank / match_total / match_overflow are host int32 arrays;
    candidate fields are copied from the device on first access."""

    def __init__(self, n: int, out: Dict):
        self.n = n
        ev = out.get("_event")
        if ev is not None:
            ev.synchronize()
        s = out["_summary_host"].numpy().astype(np.int32)
        self.best, self.best_rank, self.match_total, self.match_overflow = s
        self._cand = out["cand"]
        self._host: Dict[str, np.ndarray] = {}

    def _field(self, name: str) -> np.ndarray:
        v = self._host.get(name)
        if v is None:
            v = self._cand[name].cpu().numpy().astype(np.int32)
            self._host[name] = v
        return v

    cand_tax = property(lambda self: self._field("tax"))
    cand_hits = property(lambda self: self._field("hits"))
    cand_beg = property(lambda self: self._field("beg"))
    cand_end = property(lambda self: self._field("end"))
    cand_tgt = property(lambda self: self._field("tgt"))


class QueryEngine:
    """Device-resident database tables + the batch pipeline."""

    def __init__(self, db: Database, classify: ClassifyParams,
                 pipeline: QueryPipelineParams = QueryPipelineParams(),
                 device: torch.device = torch.device("cpu")):
        self.db = db
        self.pipeline = pipeline
        self.device = device
        p = db.query_sketch_params
        self.sketch_params = p
        self.update_runtime_thresholds(classify)
        self.lowest_rank = Rank.SEQUENCE if classify.lowest_rank is None \
            else _rank_code(classify.lowest_rank)
        self.highest_rank = _rank_code(classify.highest_rank)
        self.starts = tuple(int(s) for s in encode.window_starts(
            pipeline.max_query_len, p.window_size, p.window_stride))
        self.lmax = pipeline.max_locations_per_query
        self.tables = tables_from_database(db, device, self.lowest_rank)

    def update_runtime_thresholds(self, classify: ClassifyParams):
        """Adopt new hits_min / hits_diff_fraction (runtime scalars)."""
        self.classify = classify
        self.hits_min = classify.resolved_hits_min(
            self.db.sketch_params.sketch_size)

    def make_host_buffers(self):
        B, L = self.pipeline.batch_size, self.pipeline.max_query_len
        return (np.zeros((B, L), np.uint8), np.zeros(B, np.int32),
                np.zeros((B, L), np.uint8), np.zeros(B, np.int32))

    def classify_batch(self, codes1, lens1, codes2, lens2,
                       n: int) -> BatchResult:
        """Classify a (padded) batch of 2-bit codes; first n rows valid."""
        p1, a1 = encode.np_pack_codes(codes1)
        p2, a2 = encode.np_pack_codes(codes2)
        return self.materialize(
            self.dispatch_packed(p1, a1, lens1, p2, a2, lens2), n)

    def dispatch_packed(self, p1, a1, lens1, p2, a2, lens2) -> Dict:
        """Enqueue one packed batch; returns without waiting for the
        device. The summary's device->host copy is queued behind it."""
        qlen = self.pipeline.max_query_len
        fused = torch.from_numpy(fuse_host_inputs(p1, a1, lens1,
                                                  p2, a2, lens2))
        cuda = self.device.type == "cuda"
        if cuda:
            fused = fused.pin_memory().to(self.device, non_blocking=True)
        p = self.sketch_params
        out = query_batch(
            *unfuse_device_inputs(fused, qlen), self.tables,
            k=p.kmer_size, sketch_size=p.sketch_size,
            window_size=p.window_size, window_stride=p.window_stride,
            starts=self.starts, lmax=self.lmax,
            max_candidates=self.classify.max_candidates,
            insert_size_max=self.classify.insert_size_max,
            hits_min=self.hits_min,
            hits_diff_fraction=self.classify.hits_diff_fraction,
            highest_rank=self.highest_rank)
        summary = torch.stack([out["best"], out["best_rank"],
                               out["match_total"], out["match_overflow"]])
        if cuda:
            host = torch.empty(summary.shape, dtype=summary.dtype,
                               pin_memory=True)
            host.copy_(summary, non_blocking=True)
            out["_event"] = torch.cuda.Event()
            out["_event"].record()
            summary = host
        out["_summary_host"] = summary
        return out

    def materialize(self, out: Dict, n: int) -> BatchResult:
        return BatchResult(n, out)

    def materialize_many(self, items: List[Tuple[Dict, int]]
                         ) -> List[BatchResult]:
        """items: [(out, n), ...] from dispatch_packed, in dispatch order."""
        return [BatchResult(n, out) for out, n in items]


def _rank_code(rank) -> int:
    return rank if isinstance(rank, int) else rank_from_name(rank)
