"""The port's QueryEngine (metacache_tpu_torch/query/engine.py) against the
JAX QueryEngine on mock worlds (tests/util_mockdata.py): per-read best,
best_rank, match total / overflow and candidate tensors are equal, also
for reads whose match lists overflow lmax. Exact equality.

lmax stays >= 64: the JAX engine's fast tier has a floor of 64 slots, so
below that it classifies untruncated where a single-tier run (the port)
truncates at lmax.

The port's side gets the JAX-built database through plain arrays
(database_from_arrays) and its parameters from its own config."""
import numpy as np
import pytest
import torch

from metacache_tpu import config as jconfig
from metacache_tpu.db.build import BuildOptions, build_database
from metacache_tpu.query.engine import QueryEngine as JaxEngine
from metacache_tpu.query.engine import encode_read_into
from metacache_tpu_torch import config as tconfig
from metacache_tpu_torch.db.taxonomy import Rank
from metacache_tpu_torch.query import engine as teng
from tests import util_mockdata as mock
from tests.test_torch_self_contained import port_db

torch.set_num_threads(1)

FIELDS = ("best", "best_rank", "match_total", "match_overflow", "cand_tax",
          "cand_hits", "cand_beg", "cand_end", "cand_tgt")



def params(**pipeline):
    """(JAX, port) QueryPipelineParams with the same values."""
    return (jconfig.QueryPipelineParams(**pipeline),
            tconfig.QueryPipelineParams(**pipeline))


def classify_params(**classify):
    """(JAX, port) ClassifyParams with the same values."""
    return (jconfig.ClassifyParams(**classify),
            tconfig.ClassifyParams(**classify))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torchengine"))
    fasta, nodes, names, merged, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=3, genome_len=3000, seed=31)
    rng = np.random.default_rng(32)
    recs = []
    for i, g in enumerate(genomes):      # 4 strains per species
        for v in range(4):
            recs.append((f"NC_{10 * i + v:06d}.1|taxid|{taxids[i]}| v",
                         g if v == 0 else mock.mutate(rng, g, 0.015)))
    mock.write_fasta(fasta, recs)
    jdb = build_database([fasta], BuildOptions(
        taxonomy_nodes=nodes, taxonomy_names=names, taxonomy_merged=merged))
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
    return jdb, port_db(jdb), reads


def batch(reads, eng, paired):
    """Host buffers of the port's engine, filled with the reads (mate 2
    left empty, length 0, unless paired)."""
    c1, l1, c2, l2 = eng.make_host_buffers()
    for i, (a, b) in enumerate(reads):
        encode_read_into(c1, l1, i, a, eng.pipeline.max_query_len)
        if paired and b:
            encode_read_into(c2, l2, i, b, eng.pipeline.max_query_len)
    return c1, l1, c2, l2


@pytest.mark.parametrize("lowest", ["sequence", "species"])
@pytest.mark.parametrize("lmax", [64, 512])
@pytest.mark.parametrize("paired", [False, True])
def test_engine_matches_jax(world, lowest, lmax, paired):
    jdb, db, reads = world
    jclassify, classify = classify_params(lowest_rank=lowest,
                                          max_candidates=3)
    jpipeline, pipeline = params(batch_size=128, max_query_len=128,
                                 max_locations_per_query=lmax)
    eng = teng.QueryEngine(db, classify, pipeline, device=torch.device("cpu"))
    inputs = batch(reads, eng, paired)
    n = len(reads)
    want = JaxEngine(jdb, jclassify, jpipeline).classify_batch(*inputs, n)
    got = eng.classify_batch(*inputs, n)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[:n],
                                      np.asarray(getattr(want, f))[:n],
                                      err_msg=f)
    if lmax == 64 and paired:
        assert (got.match_overflow[:n] > 0).sum() > 10


@pytest.mark.parametrize("rank", ["species", "genus"])
@pytest.mark.parametrize("lmax", [64, 512])
def test_engine_with_exclusion_matches_jax(world, rank, lmax):
    """Clade exclusion: each read excludes the clade (on `rank`) of a
    target drawn for it, or nothing."""
    jdb, db, reads = world
    jclassify, classify = classify_params(lowest_rank="species",
                                          max_candidates=3)
    jpipeline, pipeline = params(batch_size=128, max_query_len=128,
                                 max_locations_per_query=lmax)
    rcode = getattr(Rank, rank.upper())
    eng = teng.QueryEngine(db, classify, pipeline, device=torch.device("cpu"))
    jeng = JaxEngine(jdb, jclassify, jpipeline)
    eng.set_exclusion(rcode)
    jeng.set_exclusion(rcode)
    rng = np.random.default_rng(lmax)
    nodes = db.target_taxon_node[rng.integers(0, db.target_count, 128)]
    nodes[::5] = 0
    groups = np.array([eng.exclusion_group_of(int(x)) for x in nodes])
    assert groups.tolist() == [jeng.exclusion_group_of(int(x)) for x in nodes]
    inputs = batch(reads, eng, True)
    n = len(reads)
    want = jeng.classify_batch(*inputs, n,
                               exclude_groups=groups.astype(np.int32))
    got = eng.classify_batch(*inputs, n, exclude_groups=groups)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[:n],
                                      np.asarray(getattr(want, f))[:n],
                                      err_msg=f)
    # exclusion changed results against a run without it
    plain = teng.QueryEngine(db, classify, pipeline).classify_batch(*inputs, n)
    assert (plain.best[:n] != got.best[:n]).sum() > 10


@pytest.mark.parametrize("paired", [False, True])
def test_engine_target_window_hits_matches_jax(world, paired):
    """-hits-per-seq: per-candidate window hit counts, K = 16. No match
    list fills all lmax slots here: on a full list the JAX engine counts
    one too many in the last (target, window) run (see
    test_torch_ops.py::test_target_window_hits_on_full_rows)."""
    jdb, db, reads = world
    jclassify, classify = classify_params(lowest_rank="sequence",
                                          max_candidates=3)
    jpipeline, pipeline = params(batch_size=128, max_query_len=128,
                                 max_locations_per_query=512)
    eng = teng.QueryEngine(db, classify, pipeline, target_window_k=16)
    inputs = batch(reads, eng, paired)
    n = len(reads)
    want = JaxEngine(jdb, jclassify, jpipeline,
                     target_window_k=16).classify_batch(*inputs, n)
    got = eng.classify_batch(*inputs, n)
    for f in FIELDS + ("target_window_hits",):
        np.testing.assert_array_equal(getattr(got, f)[:n],
                                      np.asarray(getattr(want, f))[:n],
                                      err_msg=f)
    assert got.target_window_hits.shape == (128, 3, 16)
    assert got.target_window_hits[:n].max() >= 1
    assert (got.match_total[:n] < 512).all()


def test_dispatch_window_equals_single_batches(world):
    """materialize_many over several dispatched batches gives what each
    batch gives alone."""
    _, db, reads = world
    pipeline = tconfig.QueryPipelineParams(batch_size=32, max_query_len=128,
                                           max_locations_per_query=64)
    eng = teng.QueryEngine(db, tconfig.ClassifyParams(), pipeline)
    from metacache_tpu_torch.ops.encode import np_pack_codes
    packed = []
    for o in range(0, 96, 32):
        c1, l1, c2, l2 = batch(reads[o:o + 32], eng, True)
        packed.append((*np_pack_codes(c1), l1, *np_pack_codes(c2), l2))
    outs = [(eng.dispatch_packed(p1, a1, l1, p2, a2, l2), 32)
            for p1, a1, l1, p2, a2, l2 in packed]
    many = eng.materialize_many(outs)
    for (p1, a1, l1, p2, a2, l2), res in zip(packed, many):
        one = eng.materialize(eng.dispatch_packed(p1, a1, l1, p2, a2, l2),
                              32)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(res, f), getattr(one, f))


def test_tables_from_database(world):
    _, db, _ = world
    t = teng.tables_from_database(db, torch.device("cpu"), Rank.SPECIES)
    ft = db.features
    np.testing.assert_array_equal(t["keys"].numpy(), ft.keys)
    np.testing.assert_array_equal(t["offsets"].numpy(), ft.offsets)
    np.testing.assert_array_equal(t["locations"].numpy() >> 32, ft.loc_tgt)
    np.testing.assert_array_equal(t["locations"].numpy() & 0xFFFFFFFF,
                                  ft.loc_win)
    np.testing.assert_array_equal(t["target_cand_tax"].numpy(),
                                  db.target_cand_tax(Rank.SPECIES))
    np.testing.assert_array_equal(t["ranked_lineage"].numpy(),
                                  db.taxonomy.ranked_lineage)
    assert all(v.dtype == torch.int64 for v in t.values())


def test_fuse_roundtrip():
    rng = np.random.default_rng(0)
    B, L = 5, 64
    arrs = [rng.integers(0, 256, (B, L // 4), dtype=np.uint8),
            rng.integers(0, 256, (B, L // 8), dtype=np.uint8),
            rng.integers(0, 65, B).astype(np.int32),
            rng.integers(0, 256, (B, L // 4), dtype=np.uint8),
            rng.integers(0, 256, (B, L // 8), dtype=np.uint8),
            rng.integers(0, 65, B).astype(np.int32)]
    fused = torch.from_numpy(teng.fuse_host_inputs(*arrs))
    for a, b in zip(arrs, teng.unfuse_device_inputs(fused, L)):
        assert b.is_contiguous()
        np.testing.assert_array_equal(b.numpy(), a)
