"""What config-3 brings to the port, held on the CPU at toy size.

- A feature bucket wider than the match list: a 200 bp repeat inserted
  64 times into each of 8 targets stores 254 locations (the cap) for some
  features in each of 2 shards, 508 fused, against 256 match slots per
  read, so a read's list is cut inside one feature's run. The port's
  shards equal the JAX build's array for array, and its `query -device
  cpu`, fused and `-mesh`, writes the JAX CLI's bytes.
- The table upload (9 GB of int64 device tables at config-3): chunks
  cross in their own width and are widened on the device.
- The build's peak host RSS where /proc has no VmHWM (getrusage).
- The entry points: `QueryEngine` runs on the card unless given the CPU
  (so it raises here, where there is no card), and `python -m
  metacache_tpu_torch` is the port's CLI.
- chip_smoke.py's config3 and config3_mesh phases, rehearsed on the CPU
  on a world cut from bench.py's config-3 generator.
"""
import os

import numpy as np
import pytest
import torch

from tests import util_mockdata as mock
from tests.test_torch_cli import _result_lines, jax_cli, port_cli, run

torch.set_num_threads(1)

REPEAT_COPIES = 64
FLAGS = ["-pairfiles", "-lowest", "species", "-max-locations-per-query",
         "256"]


@pytest.fixture(scope="module")
def repeat_world(tmp_path_factory):
    """Two species of four 1%-strains each; every strain holds the same
    200 bp repeat REPEAT_COPIES times between random spacers. 240 read
    pairs from the strains, many of them on the repeat. Built in 2 shards
    by both CLIs."""
    tmp = str(tmp_path_factory.mktemp("torchscale"))
    fasta, _, _, _, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=2, genome_len=1000, seed=31)
    rng = np.random.default_rng(32)
    repeat = mock.random_genome(rng, 200)
    recs = []
    for i in range(2):
        for v in range(4):
            parts = []
            for _ in range(REPEAT_COPIES):
                parts.append(mock.random_genome(
                    rng, int(rng.integers(150, 350))))
                parts.append(repeat)
            parts.append(mock.random_genome(rng, 300))
            recs.append((f"NC_{10 * i + v:06d}.1|taxid|{taxids[i]}| v{v}",
                         "".join(parts)))
    mock.write_fasta(fasta, recs)
    r1, r2 = [], []
    for q in range(240):
        g = recs[int(rng.integers(0, len(recs)))][1]
        p = int(rng.integers(0, len(g) - 400))
        r1.append((f"q{q}", mock.mutate(rng, g[p:p + 100], 0.01)))
        r2.append((f"q{q}", mock.mutate(rng, g[p + 250:p + 350], 0.01)))
    mock.write_fasta(os.path.join(tmp, "reads_1.fa"), r1)
    mock.write_fasta(os.path.join(tmp, "reads_2.fa"), r2)
    for cli, db in ((jax_cli, "jdb"), (port_cli, "tdb")):
        r = cli(["build", db, fasta, "-taxonomy", "tax", "-num-shards", "2"],
                tmp)
        assert r.returncode == 0, r.stderr
    return tmp


def test_repeat_buckets_wider_than_match_list(repeat_world):
    """The port's shards equal the JAX build's; each shard holds features
    at the 254-location cap, and the fused table buckets of 508."""
    from metacache_tpu_torch.db.database import Database
    from metacache_tpu_torch.modes.query import load_all_shards
    for s in range(2):
        with np.load(os.path.join(repeat_world, f"jdb_{s}.npz"),
                     allow_pickle=True) as want, \
                np.load(os.path.join(repeat_world, f"tdb_{s}.npz"),
                        allow_pickle=True) as got:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        sizes = Database.load(os.path.join(repeat_world, "tdb"),
                              s).features.bucket_sizes()
        assert sizes.max() == 254 and (sizes == 254).sum() >= 5
    fused = load_all_shards(os.path.join(repeat_world, "tdb"))
    assert fused.features.bucket_sizes().max() == 508


@pytest.mark.parametrize("mesh", [False, True], ids=["fused", "mesh"])
def test_wide_bucket_query_equals_jax(repeat_world, mesh):
    """Match lists cut inside one feature's run: the port's query (2
    shards fused, or each shard cut on its own with -mesh) writes the JAX
    CLI's lines and reports the same overflow."""
    tag = "mesh" if mesh else "fused"
    extra = ["-mesh"] if mesh else []
    args = ["reads_1.fa", "reads_2.fa"] + FLAGS + extra
    rj = run("metacache_tpu.cli", ["query", "jdb"] + args
             + ["-out", f"j{tag}.txt"], repeat_world,
             env={"XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    assert rj.returncode == 0, rj.stderr
    rt = port_cli(["query", "tdb"] + args + ["-device", "cpu", "-out",
                                             f"t{tag}.txt"], repeat_world)
    assert rt.returncode == 0, rt.stderr
    for r in (rj, rt):
        assert "falling back" not in r.stderr
    # fused, the port merges the 2 shards on its device as they stream up
    assert ("# 2 shards merged on cpu" in rt.stderr) == (not mesh)
    want = _result_lines(os.path.join(repeat_world, f"j{tag}.txt"))
    assert sum(not ln.startswith("#") and "\t|\t" in ln
               for ln in want) == 240
    assert _result_lines(os.path.join(repeat_world, f"t{tag}.txt")) == want
    overflow = [[ln for ln in r.stderr.splitlines() if "overflow" in ln]
                for r in (rt, rj)]
    assert overflow[0] == overflow[1] and len(overflow[0]) == 1


@pytest.mark.parametrize("dtype", ["uint32", "int32", "int64"])
def test_table_upload_widens_in_chunks(monkeypatch, dtype):
    """The engine's tables cross to the device in their own width, chunk
    by chunk, and are widened to int64 there: unsigned keys keep their
    value, signed words their sign, across chunk edges and a short last
    chunk; locations pack as (target << 32) | window."""
    from metacache_tpu_torch.db.feature_table import FeatureTable
    from metacache_tpu_torch.ops.lookup import LOC_SHIFT
    from metacache_tpu_torch.query import engine, upload
    monkeypatch.setattr(upload, "CHUNK", 7)
    info = np.iinfo(dtype)
    arr = np.random.default_rng(7).integers(info.min, info.max, 45,
                                            dtype=dtype, endpoint=True)
    got = upload.upload_int64(upload.Stager(torch.device("cpu")), arr)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), arr.astype(np.int64))

    table = FeatureTable(keys=arr[:3], offsets=np.array([0, 9, 20, 45]),
                         loc_tgt=np.arange(45, dtype=np.int32),
                         loc_win=np.arange(45, dtype=np.int32)[::-1].copy())
    db = type("Db", (), {"shard_features": lambda self: [table]})()
    tables = engine.feature_tables(db, torch.device("cpu"))
    np.testing.assert_array_equal(tables["keys"].numpy(),
                                  arr[:3].astype(np.int64))
    np.testing.assert_array_equal(tables["offsets"].numpy(), table.offsets)
    np.testing.assert_array_equal(
        tables["locations"].numpy(),
        (np.arange(45) << LOC_SHIFT) | np.arange(45)[::-1])


def test_peak_rss_without_vmhwm(monkeypatch):
    """Where /proc/self/status has no VmHWM line, the peak host RSS the
    build reports comes from getrusage."""
    from metacache_tpu_torch.utils import memory
    monkeypatch.setattr(memory, "_status_mb", lambda field: None)
    peak = memory.vm_peak_mb()
    assert peak is not None and peak > 1.0


def test_query_engine_needs_a_card(repeat_world):
    """Without a device argument the engine asks for the card, and there
    is none here: it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from metacache_tpu_torch.config import ClassifyParams, QueryPipelineParams
    from metacache_tpu_torch.db.database import Database
    from metacache_tpu_torch.query.engine import QueryEngine
    db = Database.load(os.path.join(repeat_world, "tdb"), 0)
    with pytest.raises(RuntimeError, match="is_available"):
        QueryEngine(db, ClassifyParams(), QueryPipelineParams())
    eng = QueryEngine(db, ClassifyParams(), QueryPipelineParams(),
                      device=torch.device("cpu"))
    assert eng.tables["locations"].device.type == "cpu"


def test_query_engine_uploads_to_its_own_device(repeat_world, monkeypatch):
    """Without a device argument, the tables go to the device the engine
    resolved (the card), the one its batches are sent to."""
    from metacache_tpu_torch.config import ClassifyParams, QueryPipelineParams
    from metacache_tpu_torch.db.database import Database
    from metacache_tpu_torch.query import engine
    card = torch.device("cuda", 3)
    uploads = []
    monkeypatch.setattr(engine, "resolve_device", lambda name: card)
    monkeypatch.setattr(engine, "tables_from_database",
                        lambda db, device, rank: uploads.append(device) or {})
    db = Database.load(os.path.join(repeat_world, "tdb"), 0)
    eng = engine.QueryEngine(db, ClassifyParams(), QueryPipelineParams())
    assert eng.device == card and uploads == [card]


@pytest.mark.parametrize("topic", [[], ["query"]], ids=["quick", "query"])
def test_module_entry_point_is_the_cli(tmp_path, topic):
    """python -m metacache_tpu_torch help == python -m metacache_tpu help."""
    rj = run("metacache_tpu", ["help"] + topic, str(tmp_path))
    rt = run("metacache_tpu_torch", ["help"] + topic, str(tmp_path))
    assert rj.returncode == 0 and len(rj.stdout.splitlines()) > 10
    assert (rt.returncode, rt.stdout, rt.stderr) == \
        (rj.returncode, rj.stdout, rj.stderr)


def test_config3_phases_rehearsed_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's config3 and config3_mesh phases end to end on the
    CPU, on bench.py's config-3 generator cut to 8 targets x 200 kbp and
    8,192 pairs: the build, the fused query with its spans and the
    captured gather batch, the -mesh query, cuda-vs-cpu line checks and
    the clean-up. The card's own calls are stubbed (no launches, no
    device clocks); the checks tied to the uncut world are skipped by the
    phase itself."""
    import bench
    import chip_smoke
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for k, v in dict(C3=bench.C3, C3_BASES=2, C3_GLEN=200_000,
                     C3_PAIRS=8192).items():
        monkeypatch.setattr(bench, k, v)
    for name, stub in (("synchronize", lambda *a: None),
                       ("reset_peak_memory_stats", lambda *a: None),
                       ("max_memory_allocated", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, stub)
    launched = []
    monkeypatch.setattr(chip_smoke, "check_launched",
                        lambda path, name, n, expected=None:
                        launched.append((path, name, expected)))

    def timed(name, fn, plain, library, bound_ms, bound_by, **kw):
        for f in (fn, plain, library or plain):
            f()
        return dict({k: 0.0 for k in chip_smoke.TIMES}, bound_ms=bound_ms,
                    bound_by=bound_by)
    monkeypatch.setattr(chip_smoke, "timed", timed)

    c3 = chip_smoke.phase_config3()
    assert not chip_smoke.c3_world_is_full()
    assert ("config3", "sketch_packed", 2) in launched
    assert ("config3", "gather_rows", 1) in launched
    # the 2 shards were merged as they streamed up (on the CPU through the
    # merge's plain version), once per planned chunk: here one
    assert ("config3", "merge_shards", 1) in launched
    assert ("config3", "merge_count", 1) in launched
    m = c3["merge"]
    assert m["merge_shards"]["err"] == 0 and m["merge_count"]["err"] == 0
    assert m["merge_shards"]["shape"].startswith("config3_P2_")
    assert m["merge_shards"]["bound_by"] == "bytes"
    g = c3["gather"]
    assert g["err"] == 0 and g["shape"].endswith("B16384xL256")
    assert 0 < g["bound_ms"] < 0.05 and g["bound_by"] == "bytes"
    lines = chip_smoke.mapping_lines(c3["out"])
    assert len(lines) == 8192
    assert chip_smoke.classified_fraction(lines) > 0.9
    chip_smoke.phase_config3_mesh(c3)
    assert not os.path.exists(c3["dir"])
    assert len(chip_smoke.mapping_lines(
        os.path.join(str(tmp_path), "c3_mesh_gpu.txt"))) == 8192
