"""The port's benchmark (bench_torch/, BENCHMARK.json) on the CPU: its
world copies write bench.py's files byte for byte at the default seed
(at reduced constants set alike on both modules) and other reads at
another seed; its numpy reference writes the JAX CLI's mapping lines on a
world whose match lists truncate (single-end, -pairfiles over two shards
fused) and the port's -mesh lines, and takes the targets' taxa from the
world, not from the database; `--rehearse` runs every cell of
BENCHMARK.json end to end on tiny worlds and reports correct; a database
is built again when the port's sources change; without a card the
benchmark exits non-zero."""
import filecmp
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from bench_torch import reference, runner, worlds

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = runner.load_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]
SPEC_CELL = {c["name"]: c for c in SPEC["workloads"]}
ENV = dict(os.environ, METACACHE_PLATFORM="cpu", PYTHONPATH=REPO,
           OMP_NUM_THREADS="1")
FLAGS = ["-lowest", "species", "-max-locations-per-query", "64"]

#: each world at reduced constants: bench.py's names and worlds.py's
SMALL = {
    "config2": (dict(C2_GENOMES=30, C2_READS=500),
                dict(genomes=30, reads=500), "C2"),
    "realistic": (dict(BIG_BASES=2, BIG_VARIANTS=3, BIG_GLEN=6000,
                       BIG_TP_LEN=300, BIG_TP_COPIES=2, BIG_PAIRS=300),
                  dict(bases=2, variants=3, glen=6000, tp_len=300,
                       tp_copies=2, pairs=300), "BIG"),
    "config3": (dict(C3_BASES=2, C3_VARIANTS=3, C3_GLEN=6000, C3_TP_LEN=300,
                     C3_TP_COPIES=2, C3_PAIRS=300),
                dict(bases=2, variants=3, glen=6000, tp_len=300,
                     tp_copies=2, pairs=300), "C3"),
}


def files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("world", sorted(SMALL))
def test_world_copy_writes_bench_files(world, tmp_path, monkeypatch):
    consts, scale, dirname = SMALL[world]
    for k, v in consts.items():
        monkeypatch.setattr(bench, k, v)
    monkeypatch.setattr(bench, dirname, str(tmp_path / "bench"))
    getattr(bench, f"make_{world}_world")()
    worlds.WORLDS[world][0](str(tmp_path / "copy"), 0, **scale)
    names = files_under(tmp_path / "bench")
    assert names == files_under(tmp_path / "copy") and len(names) >= 5
    for n in names:
        if n == "world_ok":          # the marker: the copy's names its scale
            continue
        assert filecmp.cmp(tmp_path / "bench" / n, tmp_path / "copy" / n,
                           shallow=False), n


def read_file_records(path):
    return list(reference.read_records(str(path)))


@pytest.mark.parametrize("world", sorted(SMALL))
def test_another_seed_gives_other_reads_of_the_same_shape(world, tmp_path):
    _, scale, _ = SMALL[world]
    make = worlds.WORLDS[world][0]
    for seed in (0, 5):
        make(str(tmp_path / f"s{seed}"), seed, **scale)
    reads = [f for f in files_under(tmp_path / "s0") if f.startswith("reads")]
    assert reads
    for name in reads:
        a = read_file_records(tmp_path / "s0" / name)
        b = read_file_records(tmp_path / "s5" / name)
        assert len(a) == len(b) == runner.read_count(world, scale)
        assert [len(s) for _, s in a] == [len(s) for _, s in b]
        assert sum(x != y for (_, x), (_, y) in zip(a, b)) > len(a) // 2


def cli(module, args, cwd):
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                       env=ENV, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """A strain-rich world (a transposon in every genome) whose match
    lists overflow 64 slots, built by the JAX CLI in 1 and in 2 shards."""
    tmp = str(tmp_path_factory.mktemp("benchref"))
    worlds.make_realistic_world(tmp, 0, bases=2, variants=4, glen=12_000,
                                tp_len=500, tp_copies=5, pairs=600)
    for shards in (1, 2):
        cli("metacache_tpu.cli", ["build", f"db{shards}", "genomes.fa",
                                  "-taxonomy", "tax", "-num-shards",
                                  str(shards)], tmp)
    return tmp


def mapping_lines(path):
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f
                if not ln.startswith("#") and "\t|\t" in ln]


def reference_lines(db, reads, flags, world=None):
    world = world or reference.World(os.path.dirname(db))
    ref = reference.Reference(reference.shard_paths(db), world.taxonomy,
                              **reference.flag_options(flags))
    recs = reference.sampled_reads(reads, range(600))
    return [ref.line(h, a, b) for h, a, b in recs], \
        sum(ref.classify(a, b)[1] for _, a, b in recs)


@pytest.mark.parametrize("case", ["single_1shard", "paired_2shards_fused"])
def test_reference_equals_jax_cli(jax_world, case):
    shards = 1 if case.startswith("single") else 2
    reads = ["reads_1.fa"] if shards == 1 else ["reads_1.fa", "reads_2.fa"]
    flags = FLAGS + ([] if shards == 1 else ["-pairfiles",
                                             "-max-query-len", "104"])
    out = os.path.join(jax_world, f"jax_{case}.txt")
    cli("metacache_tpu.cli", ["query", f"db{shards}"] + reads + flags
        + ["-out", out], jax_world)
    want = mapping_lines(out)
    db = os.path.join(jax_world, f"db{shards}")
    paths = [os.path.join(jax_world, r) for r in reads]
    got, truncated = reference_lines(db, paths, flags)
    assert len(want) == 600 and got == want
    assert truncated > 30           # the cut at 64 slots is exercised
    # and it matters: without the cut some lines differ
    wide, _ = reference_lines(db, paths,
                              ["4096" if f == "64" else f for f in flags])
    assert wide != want


def test_reference_mesh_equals_port_mesh(jax_world):
    """-mesh: each shard cuts its own list; the reference's merge gives
    the port's lines (the port's -mesh is held to the JAX CLI's in
    tests/test_torch_mesh_one_device.py), which differ from fused."""
    reads = ["reads_1.fa", "reads_2.fa"]
    flags = FLAGS + ["-pairfiles", "-mesh"]
    out = os.path.join(jax_world, "port_mesh.txt")
    cli("metacache_tpu_torch", ["query", "db2"] + reads + flags
        + ["-device", "cpu", "-out", out], jax_world)
    paths = [os.path.join(jax_world, r) for r in reads]
    db = os.path.join(jax_world, "db2")
    got, _ = reference_lines(db, paths, flags)
    assert got == mapping_lines(out)
    fused, _ = reference_lines(db, paths, FLAGS + ["-pairfiles"])
    assert fused != got


def test_reference_takes_taxa_from_the_world(jax_world, tmp_path):
    """The same database read against a world whose headers hang two
    targets of different species the other way round gives other lines:
    the database's own target-to-taxon link is not what the reference
    reads, so a build that links targets wrongly disagrees with it."""
    shutil.copytree(os.path.join(jax_world, "tax"), tmp_path / "tax")
    recs = list(reference.read_records(os.path.join(jax_world,
                                                    "genomes.fa")))
    taxid = [h.split("|")[2] for h, _ in recs]
    a, b = 0, next(i for i, t in enumerate(taxid) if t != taxid[0])
    with open(tmp_path / "genomes.fa", "w") as f:
        for i, (h, seq) in enumerate(recs):
            if i in (a, b):
                h = h.replace(f"|taxid|{taxid[i]}|",
                              f"|taxid|{taxid[b if i == a else a]}|")
            f.write(f">{h}\n{seq}\n")
    db = os.path.join(jax_world, "db1")
    paths = [os.path.join(jax_world, "reads_1.fa")]
    true, _ = reference_lines(db, paths, FLAGS)
    swapped, _ = reference_lines(db, paths, FLAGS,
                                 reference.World(str(tmp_path)))
    assert sum(x != y for x, y in zip(true, swapped)) > 50


def test_database_is_rebuilt_when_the_port_changes(tmp_path, monkeypatch):
    """ensure_db keys its database on the world and the port's sources."""
    (tmp_path / "world_ok").write_text("{}")
    built = []

    def fake_port(args, device, tag, logdir, probe=()):
        built.append(tag)
        return 1.0, {}, "", ""

    monkeypatch.setattr(runner, "port", fake_port)
    for digest in ("a", "a", "b"):
        monkeypatch.setattr(runner, "port_digest", lambda: digest)
        runner.ensure_db(str(tmp_path), 1, "cpu")
    assert built == ["db1_build", "db1_build"]


@pytest.fixture(scope="module")
def rehearsal_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("rehearsal"))


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_runs_the_cell(rehearsal_dir, cell, capsys):
    rc = runner.main(["--rehearse", "--cell", cell, "--work", rehearsal_dir])
    out = capsys.readouterr().out
    assert rc == 0, out[-3000:]
    lines = out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["ok"] and last["correct"] and last["rehearsal"]
    assert last["device"]["platform"] == "cpu"
    line = json.loads(next(ln for ln in lines if ln.startswith('{"cell"')))
    assert line["cell"] == cell and line["correct"]
    checks = line["checks"]
    assert checks["windows_resketched"] == runner.BUILD_WINDOWS
    assert checks["features_found"] > 0
    if SPEC_CELL[cell]["mode"] == "query":
        assert checks["reference_differ"] == 0
        assert checks["reference_sample"] == checks["lines"]
    assert "median" not in out        # no device metric on the CPU


def test_without_a_card_the_benchmark_fails(tmp_path):
    assert not torch.cuda.is_available()
    r = subprocess.run([sys.executable, "-m", "bench_torch", "--cell",
                        "config2-query", "--work", str(tmp_path / "w")],
                       cwd=REPO, env=ENV, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "no CUDA card" in r.stderr
    assert '"ok"' not in r.stdout and not (tmp_path / "w").exists()


def test_benchmark_json_names_the_cells():
    assert CELLS == ["config2-query", "realistic-paired", "config3-query",
                     "config3-query-2048", "config3-mesh2", "config3-build"]
    for c in SPEC["workloads"]:
        assert c["chips"] == 1 and c["reduced"] == []
        assert 0 < len(c["source"]) <= 200 and c["why"]
        assert set(c["metrics"]) <= set(SPEC["metrics"])
        assert set(c["bounds"]) == set(c["metrics"])
        assert c["world"] in worlds.WORLDS
        assert c["trials"] >= (3 if c["mode"] == "build" else 5)
    flags = {c["name"]: c.get("flags", []) for c in SPEC["workloads"]}
    assert "-mesh" in flags["config3-mesh2"]
    assert flags["config3-query-2048"][-1] == "2048"


def test_summary_statistics():
    s = runner.summary([5.0, 1.0, 4.0, 2.0, 3.0], "higher")
    assert (s["median"], s["best"], s["q1"], s["q3"], s["n"]) == \
        (3.0, 5.0, 2.0, 4.0, 5)
    assert s["spread"] == pytest.approx(2.0 / 3.0)
    assert runner.summary([5.0, 1.0, 4.0], "lower")["best"] == 1.0


def test_database_size_of_fused_shards(jax_world):
    """features, locations and max bucket of two shards fused equal the
    numbers of the one-shard build of the same world."""
    one = runner.database_size(reference.shard_paths(
        os.path.join(jax_world, "db1")))
    two = runner.database_size(reference.shard_paths(
        os.path.join(jax_world, "db2")))
    assert one == two and one["max_bucket"] > 8
    with np.load(os.path.join(jax_world, "db1_0.npz")) as z:
        assert one["locations"] == int(z["offsets"][-1])


def test_probe_records_the_threaded_query_driver(tmp_path):
    """bench_torch.probe --record --trace on the realistic world's
    rehearsal scale, 32 batches written on the query driver's writer
    thread: the spans the traced trial checks are counted once per batch,
    and the overflowing rows are recorded as many as the CLI counted, in
    reading order, the rows a one-batch query records."""
    wdir, scale = runner.make_world(str(tmp_path), "realistic", SPEC["seed"],
                                    True)
    db = runner.ensure_db(wdir, 1, "cpu")
    reads = [os.path.join(wdir, r)
             for r in SPEC_CELL["realistic-paired"]["reads"]]
    n = runner.read_count("realistic", scale)
    base = ["query", db] + reads + ["-pairfiles", "-lowest", "species",
                                    "-max-locations-per-query", "64"]
    rows = {}
    for batch in ("16", "512"):
        _, rec, _, err = runner.port(
            base + ["-batch-size", batch, "-out",
                    str(tmp_path / f"b{batch}.txt")],
            "cpu", f"b{batch}", str(tmp_path),
            ["--record", "--trace", str(tmp_path / f"b{batch}.trace.json")])
        spans = rec["layers"]["spans"]
        batches = -(-n // int(batch))
        for s in ("dispatch", "materialize", "finalize_window"):
            assert spans.get(s) == batches, spans
        rows[batch] = rec["overflow_rows"]
        assert 0 < len(rows[batch]) == runner.overflow_count(err)
        assert rows[batch] == sorted(set(rows[batch]))
        assert rows[batch][-1] < n
    assert rows["16"] == rows["512"]
