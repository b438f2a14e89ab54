"""A fused query over several shards merges them on its device as they
stream up (metacache_tpu_torch/query/upload.py, the kernel csrc/merge.cu
and its plain version ops/merge.py), held on the CPU at toy size:

- the chunked merge equals the host merge (native.merge_shard_tables)
  array for array on random shard tables of 2, 3 and 4 shards that share
  keys, leave a shard without keys in some chunks and hold equal
  (target, window) pairs in several shards (the tie rule), on tables
  with a bucket wider than a chunk in every shard, and on tables that
  are all ties, with chunks cut every few keys;
- the streamed fused tables equal the host-merged database's tables
  tensor for tensor on the multi-shard worlds of test_torch_scale.py and
  test_torch_mesh_one_device.py;
- the fused CLI query, merged in many chunks, writes the JAX CLI's bytes;
- the key count that sizes the fused table (merge_cuda.count_keys, summed
  over the planned chunks) equals the key count of the JAX package's
  FeatureTable.concat_shards for 1-4 shards, keys at and above 2^31,
  disjoint and identical shards and an empty shard.

Tolerance: exact equality throughout.
"""
import os

import numpy as np
import pytest
import torch

from metacache_tpu.db.feature_table import FeatureTable as JaxFeatureTable
from metacache_tpu_torch import native
from metacache_tpu_torch.db.feature_table import FeatureTable
from metacache_tpu_torch.ops import merge_cuda
from metacache_tpu_torch.ops.lookup import LOC_SHIFT
from metacache_tpu_torch.query import upload
from tests import test_torch_cuda as cuda_tests
from tests.test_torch_cli import _result_lines, port_cli, world  # noqa: F401
from tests.test_torch_scale import FLAGS, repeat_world  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")


def random_shards(P, seed, n_keys=60):
    """test_torch_cuda.py's random shard tables at toy size."""
    return cuda_tests.random_shards(np.random.default_rng(seed), P, n_keys)


def emptied(table, keys):
    """`table` with the buckets of `keys` emptied, the keys kept."""
    sizes = np.diff(table.offsets)
    drop = np.isin(table.keys, np.asarray(keys, np.uint32))
    keep = ~np.repeat(drop, sizes)
    offsets = np.zeros_like(table.offsets)
    np.cumsum(np.where(drop, 0, sizes), out=offsets[1:])
    return FeatureTable(keys=table.keys, offsets=offsets,
                        loc_tgt=table.loc_tgt[keep],
                        loc_win=table.loc_win[keep])


def host_merged(tables):
    keys, offsets, tgt, win = native.merge_shard_tables(tables)
    return {"keys": keys.astype(np.int64), "offsets": offsets,
            "locations": (tgt.astype(np.int64) << LOC_SHIFT) | win}


def assert_tables_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        g = got[name]
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = want[name].numpy() if isinstance(want[name], torch.Tensor) \
            else want[name]
        assert g.dtype == np.int64, name
        np.testing.assert_array_equal(g, w, err_msg=name)


#: (tables, P, cap) cases; the random tables keep their ids "P-cap"
MERGE_CASES = [pytest.param(t, P, cap, id=f"{P}-{cap}" if t == "random"
                            else f"{t}-{P}-{cap}")
               for t in ("random", "giant_bucket", "all_ties")
               for cap in (9, 40, 1 << 24) for P in (2, 3, 4)]


@pytest.mark.parametrize("tables,P,cap", MERGE_CASES)
def test_chunked_merge_equals_host_merge(tables, P, cap, monkeypatch):
    """Random tables; tables with one key whose bucket holds 3,000
    locations in every shard (wider than any cap here and than a merge
    tile of the kernel); and P copies of one table (every triple tied
    across the shards)."""
    monkeypatch.setattr(upload, "CHUNK", cap)
    seed = 10 * P + cap % 7
    if tables == "random":
        tables = random_shards(P, seed=seed)
    elif tables == "giant_bucket":
        tables = cuda_tests.giant_bucket_shards(
            np.random.default_rng(seed), P, 60, 3000)
    else:
        tables = cuda_tests.tied_shards(np.random.default_rng(seed), P, 60)
    want = host_merged(tables)
    # a chunk holds at most cap locations, or one key's bucket
    total, widest = want["offsets"][-1], np.diff(want["offsets"]).max()
    assert len(upload.plan_chunks(tables, cap)) >= \
        -(-total // max(cap, widest))
    before = merge_cuda.merge_launches, merge_cuda.count_launches
    got = upload.merged_feature_tables(upload.Stager(CPU), tables)
    assert (merge_cuda.merge_launches, merge_cuda.count_launches) == before
    assert_tables_equal(got, want)


def test_plan_chunks_cuts_between_buckets():
    """Each chunk holds at most cap locations summed over the shards
    (a bucket wider than cap gets a chunk of its own), chunks follow each
    other without a gap, and no key's locations are split."""
    tables = random_shards(3, seed=5)
    cap = 9
    plan = upload.plan_chunks(tables, cap)
    assert plan[0][0] == [0, 0, 0]
    assert plan[-1][1] == [len(t.keys) for t in tables]
    last_key = -1
    for (begin, end), nxt in zip(plan, plan[1:] + [None]):
        if nxt is not None:
            assert nxt[0] == end
        n = sum(int(t.offsets[e] - t.offsets[b])
                for t, b, e in zip(tables, begin, end))
        keys = np.unique(np.concatenate(
            [t.keys[b:e] for t, b, e in zip(tables, begin, end)]))
        assert n <= cap or len(keys) == 1
        assert n > 0 and keys[0] > last_key
        last_key = keys[-1]


def test_empty_buckets_are_dropped(monkeypatch):
    """A key whose bucket is empty in every shard is dropped, as the host
    merge drops it; one empty in a single shard keeps the others'
    locations (the planner and the count see such keys; the fused tables
    still come out at their exact sizes)."""
    tables = random_shards(2, seed=3)
    shared = np.intersect1d(tables[0].keys, tables[1].keys)
    both, one = [shared[0], shared[1], 0xFFFFFFFF], shared[2]
    tables = [emptied(tables[0], both + [one]), emptied(tables[1], both)]
    want = host_merged(tables)
    assert shared[0] not in want["keys"] and one in want["keys"]
    for cap in (5, 1 << 24):
        monkeypatch.setattr(upload, "CHUNK", cap)
        got = upload.merged_feature_tables(upload.Stager(CPU), tables)
        assert_tables_equal(got, want)


def count_key_sets(kind, P, rng):
    """P sorted unique u32 key arrays of one count case: random keys over
    the whole u32 range (about half at or above 2^31, many shared), keys
    all at or above 2^31 and interleaved across the shards, disjoint
    shards, identical shards, or random shards with the middle one
    empty."""
    def draw(lo, hi, n):
        return np.unique(rng.integers(lo, hi, n, dtype=np.uint64)).astype(
            np.uint32)
    if kind == "random":
        space = draw(0, 1 << 32, 400)
        return [np.sort(rng.choice(space, 250, replace=False))
                for _ in range(P)]
    if kind == "high_keys":
        return [draw((1 << 31) - 20, (1 << 31) + 400, 200)
                for _ in range(P)]
    if kind == "disjoint":
        keys = draw(0, 1 << 32, 300 * P)
        return [keys[s::P] for s in range(P)]
    if kind == "identical":
        return [draw(0, 1 << 32, 300)] * P
    sets = [draw(0, 1 << 32, 300) for _ in range(P)]
    sets[P // 2] = np.zeros(0, np.uint32)
    return sets


def tables_of(key_sets, rng, cls):
    """A CSR table of class `cls` per key array: buckets of 1-4 random
    (target, window) locations, sorted (no empty bucket: no build writes
    one, the host merge drops it, the count does not)."""
    out = []
    for keys in key_sets:
        sizes = rng.integers(1, 5, len(keys))
        offsets = np.zeros(len(keys) + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        pair = rng.integers(0, 64, int(offsets[-1]))
        pair = pair[np.lexsort((pair, np.repeat(np.arange(len(keys)),
                                                sizes)))]
        out.append(cls(keys=keys, offsets=offsets,
                       loc_tgt=(pair // 8).astype(np.int32),
                       loc_win=(pair % 8).astype(np.int32)))
    return out


COUNT_CASES = [pytest.param("random", P, id=f"P{P}") for P in (1, 2, 3, 4)] \
    + [pytest.param(kind, P, id=kind) for kind, P in
       (("high_keys", 3), ("disjoint", 3), ("identical", 4),
        ("one_empty", 3))]


@pytest.mark.parametrize("kind,P", COUNT_CASES)
def test_chunked_key_count_equals_jax_concat(kind, P):
    """The fused key count, summed over the planned chunks (cut every ~40
    locations, so a shard's keys fall into many chunks), equals the key
    count of the JAX package's concatenated shard table built from the
    same arrays. Tolerance: exact."""
    key_sets = count_key_sets(kind, P, np.random.default_rng(100 + P))
    port = tables_of(key_sets, np.random.default_rng(7), FeatureTable)
    jax_tables = tables_of(key_sets, np.random.default_rng(7),
                           JaxFeatureTable)
    want = len(JaxFeatureTable.concat_shards(jax_tables).keys)
    assert want == len(np.unique(np.concatenate(key_sets)))
    plan = upload.plan_chunks(port, 40)
    assert len(plan) > 10
    count = torch.zeros(1, dtype=torch.int64)
    stager = upload.Stager(CPU)
    for begin, end in plan:
        chunk = upload._Chunk(stager, port, begin, end, locations=False)
        merge_cuda.count_keys(chunk.keys, chunk.bounds, count)
    assert int(count) == want


@pytest.mark.parametrize("dtype", ["uint32", "int32", "int64"])
def test_stager_keeps_bits(dtype):
    """The stager hands over a host array (here read-only, as a memory
    map is) in its own width, every bit in place."""
    info = np.iinfo(dtype)
    arr = np.random.default_rng(1).integers(info.min, info.max, 37,
                                            dtype=dtype, endpoint=True)
    arr.setflags(write=False)
    got = upload.Stager(CPU).staged(arr)
    assert got.dtype == upload._torch_int(arr.dtype.itemsize)
    np.testing.assert_array_equal(got.numpy(), arr.view(got.numpy().dtype))


def _fused_tables_equal(db_name, monkeypatch):
    from metacache_tpu_torch.config import ClassifyParams
    from metacache_tpu_torch.db.database import FusedDatabase
    from metacache_tpu_torch.modes.query import (load_all_shards,
                                                 open_all_shards)
    from metacache_tpu_torch.query.engine import (QueryEngine,
                                                  tables_from_database)
    from metacache_tpu_torch.db.taxonomy import Rank
    want = tables_from_database(load_all_shards(db_name), CPU, Rank.SPECIES)
    monkeypatch.setattr(upload, "CHUNK", 64)
    db = open_all_shards(db_name)
    assert isinstance(db, FusedDatabase) and len(db.shard_features()) > 1
    eng = QueryEngine(db, ClassifyParams(lowest_rank="species"),
                      device=CPU)
    assert not db.merged_on_host
    assert set(eng.tables) == set(want)
    for name, w in want.items():
        assert torch.equal(eng.tables[name], w), name
    assert len(upload.plan_chunks(db.shard_features(), 64)) > 10


def test_streamed_fused_tables_on_repeat_world(repeat_world, monkeypatch):  # noqa: F811
    """test_torch_scale.py's world: buckets at the 254 cap in both
    shards, 508 fused, wider than a 64-location chunk."""
    _fused_tables_equal(os.path.join(repeat_world, "tdb"), monkeypatch)


def test_streamed_fused_tables_on_mock_world(world, monkeypatch):  # noqa: F811
    """test_torch_mesh_one_device.py's database: test_torch_cli.py's world
    in 2 shards."""
    r = port_cli(["build", "tdb2m", "genomes.fa", "-taxonomy", "tax",
                  "-num-shards", "2", "-device", "cpu"], world)
    assert r.returncode == 0, r.stderr
    _fused_tables_equal(os.path.join(world, "tdb2m"), monkeypatch)


CONTENT_PROPERTIES = ("targets ", "ranked targets ", "taxa in tree ",
                      "buckets ", "bucket size  ", "features ",
                      "dead features ", "locations ")


@pytest.mark.parametrize("tuning", [[], ["-max-locations-per-feature", "3"],
                                    ["-verbose"]],
                         ids=["merged-on-device", "bucket-cap-on-host",
                              "verbose-on-device"])
def test_fused_query_in_chunks_equals_jax(repeat_world, monkeypatch, capsys,  # noqa: F811
                                          tuning):
    """The port's fused query over 2 shards, merged 64 locations at a
    time through the CLI entry point, writes the JAX CLI's bytes. A flag
    that rewrites buckets needs the fused table on the host: that query
    merges there, and only there. -verbose prints the fused table's
    content properties as the JAX CLI does, read from the device tables
    (no host merge)."""
    from metacache_tpu_torch import cli
    from tests.test_torch_cli import run
    monkeypatch.setattr(upload, "CHUNK", 64)
    monkeypatch.chdir(repeat_world)
    tag = "".join(tuning)
    args = ["reads_1.fa", "reads_2.fa"] + FLAGS + tuning
    rj = run("metacache_tpu.cli", ["query", "jdb"] + args
             + ["-out", f"jchunks{tag}.txt"], repeat_world)
    assert rj.returncode == 0, rj.stderr
    merges = []
    monkeypatch.setattr(upload, "merged_feature_tables",
                        lambda *a: merges.append(a) or
                        MERGED_FEATURE_TABLES(*a))
    assert cli.main(["query", "tdb"] + args
                    + ["-device", "cpu", "-out", f"tchunks{tag}.txt"]) == 0
    out, err = capsys.readouterr()
    on_host = "-max-locations-per-feature" in tuning
    assert ("# 2 shards merged on cpu" in err) == (not on_host)
    assert len(merges) == (0 if on_host else 1)
    props = [[ln for ln in text.splitlines()
              if ln.startswith(CONTENT_PROPERTIES)]
             for text in (rj.stdout, out)]
    assert props[0] == props[1]
    assert (len(props[0]) == 8) == ("-verbose" in tuning)
    want = _result_lines(os.path.join(repeat_world, f"jchunks{tag}.txt"))
    assert len(want) > 240
    assert _result_lines(os.path.join(repeat_world,
                                      f"tchunks{tag}.txt")) == want


MERGED_FEATURE_TABLES = upload.merged_feature_tables
