"""The port's sharded query (metacache_tpu_torch/parallel/sharding.py)
against the JAX ShardedQueryEngine on the conftest's 8-device CPU mesh and
against the port's single QueryEngine, on mock worlds
(tests/util_mockdata.py); and the port's candidate merge against JAX
_dedup_topk. Exact equality.

lmax stays >= 64 (the JAX engine's fast-tier floor) and, where window hit
counts are compared, every match list stays below lmax (the JAX
target_window_hits fault on full lists, ROADMAP Queue 3).

The port's side gets the JAX-built shards through plain arrays
(database_from_arrays) and its parameters from its own config."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metacache_tpu import config as jconfig
from metacache_tpu.config import TARGET_SENTINEL
from metacache_tpu.db.build import BuildOptions, build_database
from metacache_tpu.ops.candidates import _dedup_topk
from metacache_tpu.parallel import ShardedQueryEngine as JaxSharded
from metacache_tpu.parallel import make_mesh
from metacache_tpu.query.engine import encode_read_into
from metacache_tpu_torch.config import ClassifyParams, QueryPipelineParams
from metacache_tpu_torch.db.taxonomy import Rank
from metacache_tpu_torch.ops.candidates import merge_candidates
from metacache_tpu_torch.parallel import ShardedQueryEngine, place_shards
from metacache_tpu_torch.query.engine import QueryEngine
from tests import util_mockdata as mock
from tests.test_torch_self_contained import port_db

torch.set_num_threads(1)

FIELDS = ("best", "best_rank", "match_total", "match_overflow", "cand_tax",
          "cand_hits", "cand_beg", "cand_end", "cand_tgt")
CAND = ("tax", "hits", "beg", "end", "tgt")



def shard_lists(seed, B, P, C, n_targets, empty_rate):
    """[B, P*C] per-shard candidate lists as a shard would make them:
    target t lives on shard t % P and maps to taxon t // 3 + 1 (so
    several targets, on several shards, share a taxon), taxa are distinct
    within a shard's list, hits are small (ties on purpose), and some
    slots are empty (tax 0, tgt TARGET_SENTINEL)."""
    rng = np.random.default_rng(seed)
    out = {n: np.zeros((B, P * C), np.int32) for n in CAND}
    out["tgt"][:] = TARGET_SENTINEL
    for b in range(B):
        for p in range(P):
            own = rng.permutation(np.arange(p, n_targets, P))
            taxa, j = set(), 0
            for t in own:
                if j == C or rng.random() < empty_rate:
                    break
                if t // 3 + 1 in taxa:
                    continue
                taxa.add(t // 3 + 1)
                col = p * C + j
                beg = int(rng.integers(0, 50))
                out["tax"][b, col] = t // 3 + 1
                out["hits"][b, col] = int(rng.integers(1, 4))
                out["beg"][b, col] = beg
                out["end"][b, col] = beg + int(rng.integers(0, 4))
                out["tgt"][b, col] = t
                j += 1
    return out


@pytest.mark.parametrize("B,P,C,n_targets,empty_rate", [
    (64, 2, 2, 12, 0.1), (64, 4, 2, 40, 0.2), (32, 8, 3, 60, 0.3),
    (16, 3, 5, 9, 0.0)])
def test_merge_candidates_matches_jax(B, P, C, n_targets, empty_rate):
    lists = shard_lists(B * P + C, B, P, C, n_targets, empty_rate)
    want = _dedup_topk(*(jnp.asarray(lists[n]) for n in CAND), C)
    got = merge_candidates(
        {n: torch.from_numpy(lists[n].astype(np.int64)) for n in CAND}, C)
    for n in CAND:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]),
                                      err_msg=n)
    # the cases hold cross-shard taxon duplicates and hit ties
    assert (got["hits"][:, :-1] == got["hits"][:, 1:]).any()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """3 species x 4 strains (shared features, so match lists are long),
    and 96 reads, some with an N, some random."""
    tmp = str(tmp_path_factory.mktemp("torchsharding"))
    fasta, nodes, names, merged, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=3, genome_len=3000, seed=41)
    rng = np.random.default_rng(42)
    recs = []
    for i, g in enumerate(genomes):
        for v in range(4):
            recs.append((f"NC_{10 * i + v:06d}.1|taxid|{taxids[i]}| v",
                         g if v == 0 else mock.mutate(rng, g, 0.015)))
    mock.write_fasta(fasta, recs)
    opt = BuildOptions(taxonomy_nodes=nodes, taxonomy_names=names,
                       taxonomy_merged=merged)
    seqs = [s for _, s in recs]
    reads = []
    for q in range(96):
        g = seqs[int(rng.integers(0, len(seqs)))]
        p = int(rng.integers(0, len(g) - 300))
        a = mock.mutate(rng, g[p:p + 100], 0.01)
        b = mock.mutate(rng, g[p + 150:p + 250], 0.01)
        if q % 11 == 0:
            a = a[:50] + "N" + a[51:]
        if q % 13 == 0:
            a, b = mock.random_genome(rng, 100), ""
        reads.append((a, b))
    jshards = {n: [build_database([fasta], opt, num_shards=n, shard_id=s)
                   for s in range(n)] for n in (2, 4, 8)}
    shards = {n: [port_db(d) for d in dbs] for n, dbs in jshards.items()}
    return (port_db(build_database([fasta], opt)), shards, reads, jshards)


def batch(reads, pipeline, paired):
    B, L = pipeline.batch_size, pipeline.max_query_len
    c1, l1 = np.zeros((B, L), np.uint8), np.zeros(B, np.int32)
    c2, l2 = np.zeros((B, L), np.uint8), np.zeros(B, np.int32)
    for i, (a, b) in enumerate(reads):
        encode_read_into(c1, l1, i, a, L)
        if paired and b:
            encode_read_into(c2, l2, i, b, L)
    return c1, l1, c2, l2


def engines(world, nshards, classify, pipeline, twk=0):
    """(port sharded, JAX sharded, port single) engines; the JAX one gets
    its own ClassifyParams / QueryPipelineParams of the same values."""
    single, shards, _, jshards = world
    port = ShardedQueryEngine(shards[nshards], classify, pipeline,
                              place_shards(range(nshards), "cpu"),
                              target_window_k=twk)
    jx = JaxSharded(jshards[nshards],
                    jconfig.ClassifyParams(**dataclasses.asdict(classify)),
                    jconfig.QueryPipelineParams(
                        **dataclasses.asdict(pipeline)),
                    make_mesh(jax.devices()[:nshards]), target_window_k=twk)
    return port, jx, QueryEngine(single, classify, pipeline,
                                 device=torch.device("cpu"),
                                 target_window_k=twk)


def assert_equal(got, want, n, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f)[:n],
                                      np.asarray(getattr(want, f))[:n],
                                      err_msg=f)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("nshards", [2, 4, 8])
def test_sharded_matches_jax_and_single(world, nshards, paired):
    reads = world[2]
    classify = ClassifyParams(lowest_rank="species", max_candidates=3)
    pipeline = QueryPipelineParams(batch_size=128, max_query_len=128,
                                   max_locations_per_query=512)
    port, jx, one = engines(world, nshards, classify, pipeline)
    inputs = batch(reads, pipeline, paired)
    n = len(reads)
    got = port.classify_batch(*inputs, n)
    assert_equal(got, jx.classify_batch(*inputs, n), n)
    # no shard truncates at lmax 512, so the single engine agrees too,
    # match totals included
    assert (got.match_overflow[:n] == 0).all()
    assert_equal(got, one.classify_batch(*inputs, n), n)
    assert (got.cand_hits[:n, 0] > 0).sum() > 80


@pytest.mark.parametrize("rank", ["species", "genus"])
def test_sharded_exclusion_matches_jax(world, rank):
    single, _, reads, _ = world
    classify = ClassifyParams(lowest_rank="species", max_candidates=3)
    pipeline = QueryPipelineParams(batch_size=128, max_query_len=128,
                                   max_locations_per_query=512)
    port, jx, one = engines(world, 4, classify, pipeline)
    rcode = getattr(Rank, rank.upper())
    for e in (port, jx, one):
        e.set_exclusion(rcode)
    rng = np.random.default_rng(len(rank))
    nodes = single.target_taxon_node[rng.integers(0, single.target_count,
                                                  128)]
    nodes[::5] = 0
    groups = np.array([port.exclusion_group_of(int(x)) for x in nodes])
    inputs = batch(reads, pipeline, True)
    n = len(reads)
    got = port.classify_batch(*inputs, n, exclude_groups=groups)
    assert_equal(got, jx.classify_batch(
        *inputs, n, exclude_groups=groups.astype(np.int32)), n)
    assert_equal(got, one.classify_batch(*inputs, n, exclude_groups=groups),
                 n)
    plain = port.classify_batch(*inputs, n)
    assert (plain.best[:n] != got.best[:n]).sum() > 10


@pytest.mark.parametrize("paired", [False, True])
def test_sharded_target_window_hits_matches_jax(world, paired):
    reads = world[2]
    classify = ClassifyParams(lowest_rank="sequence", max_candidates=3)
    pipeline = QueryPipelineParams(batch_size=128, max_query_len=128,
                                   max_locations_per_query=512)
    port, jx, one = engines(world, 4, classify, pipeline, twk=16)
    inputs = batch(reads, pipeline, paired)
    n = len(reads)
    got = port.classify_batch(*inputs, n)
    fields = FIELDS + ("target_window_hits",)
    assert_equal(got, jx.classify_batch(*inputs, n), n, fields)
    assert_equal(got, one.classify_batch(*inputs, n), n, fields)
    assert got.target_window_hits[:n].max() >= 1


def test_sharded_truncates_per_shard(world):
    """At lmax 64 each shard cuts its own list: reads the single engine
    truncates keep more matches here, and the JAX sharded engine agrees."""
    reads = world[2]
    classify = ClassifyParams(lowest_rank="species", max_candidates=3)
    pipeline = QueryPipelineParams(batch_size=128, max_query_len=128,
                                   max_locations_per_query=64)
    port, jx, one = engines(world, 2, classify, pipeline)
    inputs = batch(reads, pipeline, True)
    n = len(reads)
    got = port.classify_batch(*inputs, n)
    assert_equal(got, jx.classify_batch(*inputs, n), n)
    fused = one.classify_batch(*inputs, n)
    assert (fused.match_overflow[:n] > 0).sum() > 10
    assert (got.match_total[:n] > 64).any()


def test_sharded_dispatch_window(world):
    """materialize_many over several dispatched batches gives what each
    batch gives alone."""
    reads = world[2]
    pipeline = QueryPipelineParams(batch_size=32, max_query_len=128,
                                   max_locations_per_query=64)
    port, _, _ = engines(world, 2, ClassifyParams(), pipeline)
    from metacache_tpu_torch.ops.encode import np_pack_codes
    packed = []
    for o in range(0, 96, 32):
        c1, l1, c2, l2 = batch(reads[o:o + 32], pipeline, True)
        packed.append((*np_pack_codes(c1), l1, *np_pack_codes(c2), l2))
    many = port.materialize_many([(port.dispatch_packed(*b), 32)
                                  for b in packed])
    for b, res in zip(packed, many):
        one = port.materialize(port.dispatch_packed(*b), 32)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(res, f), getattr(one, f))


def test_sharded_engine_rejects_bad_placement(world):
    shards = world[1]
    with pytest.raises(ValueError):
        ShardedQueryEngine(shards[2], ClassifyParams(), QueryPipelineParams(),
                           [torch.device("cpu")])
    with pytest.raises(ValueError):
        ShardedQueryEngine(shards[2], ClassifyParams(), QueryPipelineParams(),
                           place_shards([0, 1], "cpu")).classify_batch(
            *batch([], QueryPipelineParams(batch_size=8, max_query_len=64),
                   False), 0, exclude_groups=np.zeros(8, np.int64))
