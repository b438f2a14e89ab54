"""Sharded query: database shards on several devices and ranks.

Counterpart of metacache_tpu/parallel/sharding.py::ShardedQueryEngine, the
replacement of the reference's MPI query distribution
(query_batched_parallel2, src/querying.h:721-1173):

  reference                                port
  ---------                                ----
  per-rank DB shard file (t % P == rank)   each shard's own device tables
                                           (several shards may share a
                                           device); shards s % P == r on
                                           rank r
  every rank reads the same read block     the batch copied once to each
                                           device and sketched once there
  log2(P) MPI_Send/Recv candidate tree     per-shard candidates merged on
  + re-insert into per-qid lists           the process's first device, then
                                           all-gathered across ranks and
                                           merged again (merge_candidates)
  rank 0 classifies + formats              every rank votes on the merged
                                           candidates; rank 0 writes

The merge keeps per taxon the max hits, smallest target id on ties, and
orders by (hits desc, target id asc): each target's matches live on one
shard and target ids are global, so the result is the single engine's,
shard-count invariant, as long as no shard truncates its match list.
Each shard truncates at max_locations_per_query on its own, so a read
whose fused list would overflow may keep more matches here.

Not carried from the JAX engine, as they change no result: padding the
shard tables to common sizes, the Pallas opt-in, the direct tier, seg
encoding, the optimization barrier and the slim wire / packed summary.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..config import ClassifyParams, QueryPipelineParams
from ..db.database import Database
from ..ops.candidates import merge_candidates
from ..query.engine import (EngineBase, feature_tables, fetch_summary,
                            make_target_groups, tables_from_database,
                            target_window_hits, upload_batch)
from . import distributed

CAND_FIELDS = ("tax", "hits", "beg", "end", "tgt")


def _concrete(d) -> torch.device:
    """'cuda' -> 'cuda:<current card>', so equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class ShardedQueryEngine(EngineBase):
    """Query engine over database shards, one device per shard (devices
    may repeat). The API is QueryEngine's (make_host_buffers,
    classify_batch, dispatch_packed, materialize, materialize_many,
    set_exclusion, exclusion_group_of, update_runtime_thresholds,
    target_window_k), so QueryProcessor takes either."""

    def __init__(self, dbs: List[Database], classify: ClassifyParams,
                 pipeline: QueryPipelineParams,
                 devices: Sequence[torch.device], target_window_k: int = 0):
        """dbs: this process's shards (all of them in one process; with
        several ranks, the shards s with s % P == rank); devices: one per
        shard. The taxonomy and target ids are the same in every shard."""
        if not dbs or len(devices) != len(dbs):
            raise ValueError(f"{len(dbs)} shards for {len(devices)} "
                             "devices: need one device per shard")
        super().__init__(dbs[0], classify, pipeline, target_window_k)
        self.devices = [_concrete(d) for d in devices]
        #: distinct devices in order; merge and vote run on the first
        self.distinct = list(dict.fromkeys(self.devices))
        self.home = self.distinct[0]
        # the candidate-taxon map and lineage are uploaded once per
        # device, with the first shard placed there; each shard adds only
        # its own feature table
        self._shared: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self.tables: List[Dict[str, torch.Tensor]] = []
        for db, d in zip(dbs, self.devices):
            if d not in self._shared:
                self._shared[d] = tables_from_database(db, d,
                                                       self.lowest_rank)
                self.tables.append(self._shared[d])
            else:
                self.tables.append(dict(self._shared[d],
                                        **feature_tables(db, d)))

    def set_exclusion(self, rank_code: int):
        """Enable clade exclusion on `rank_code` (QueryEngine.set_exclusion);
        the target -> clade map is uploaded once per device."""
        groups = torch.from_numpy(make_target_groups(self.db, rank_code))
        on = {d: groups.to(d) for d in self.distinct}
        self.tables = [dict(t, target_groups=on[d])
                       for t, d in zip(self.tables, self.devices)]
        self.exclude_rank = rank_code

    def dispatch_packed(self, p1, a1, lens1, p2, a2, lens2,
                        exclude_groups=None) -> Dict:
        """Enqueue one packed batch on every shard, merge, vote; the
        summary's device->host copy is queued behind it. With several
        ranks, every rank must dispatch the same batches in the same
        order (the collectives pair them up)."""
        self._check_exclusion(exclude_groups)
        inputs = upload_batch(p1, a1, lens1, p2, a2, lens2, exclude_groups,
                              self.distinct, self.staging)
        sketched = {d: (*self._sketch(fused), eg)
                    for d, (fused, eg) in inputs.items()}
        local = []
        for tables, d in zip(self.tables, self.devices):
            features, l1, l2, eg = sketched[d]
            local.append(self._candidates(features, l1, l2, tables, eg))
        home = self.home
        width = local[0]["cand"]["tax"].shape[1]
        merged = merge_candidates(
            {n: torch.cat([loc["cand"][n].to(home) for loc in local], dim=1)
             for n in CAND_FIELDS}, width)
        counts = sum(torch.stack([loc["total"], loc["overflow"]]).to(home)
                     for loc in local)
        if distributed.world_size() > 1:
            merged = merge_candidates(
                distributed.all_gather_candidates(merged), width)
            counts = distributed.all_reduce_sum(counts)
        out = self._classify(merged, counts[0], counts[1],
                             self._shared[home]["ranked_lineage"])
        if self.target_window_k:
            # each shard counts the merged candidates in its own match
            # list; a target's matches live on one shard, so the sum is
            # the global count (src/matches_per_target.h:111-155)
            twh = sum(target_window_hits(
                {n: merged[n].to(d) for n in ("tgt", "beg", "end")},
                loc["tgt"], loc["win"], self.target_window_k).to(home)
                for loc, d in zip(local, self.devices))
            out["target_window_hits"] = distributed.all_reduce_sum(twh)
        return fetch_summary(out, self.summaries)
