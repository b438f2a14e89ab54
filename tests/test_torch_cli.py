"""The port's CLI (python -m metacache_tpu_torch.cli) against the JAX CLI
(python -m metacache_tpu.cli) on a mock world: `build` (native and
WindowBatcher paths) and `modify` write shard files equal array by array;
`query -device cpu` (with -exclude, -hits-per-seq, -align, -mesh and in
interactive mode), `merge`, `info`, `help` and `annotate` write
byte-identical output (the run-dependent '# time:' / '# speed:' lines
aside). Also: the port runs with JAX and the JAX package made
unimportable, and it maps shard tables instead of reading them."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests import util_mockdata as mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(module, args, tmp, stdin=None, env=None):
    env = dict(os.environ, METACACHE_PLATFORM="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1", **(env or {}))
    return subprocess.run([sys.executable, "-m", module] + args,
                          capture_output=True, text=True, cwd=tmp, env=env,
                          timeout=600, input=stdin)


def jax_cli(args, tmp, stdin=None):
    return run("metacache_tpu.cli", args, tmp, stdin)


def port_cli(args, tmp, stdin=None):
    return run("metacache_tpu_torch.cli", args, tmp, stdin)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two base genomes with five 1%-strain variants each, so features are
    shared by several targets and paired reads overflow 64 match slots."""
    tmp = str(tmp_path_factory.mktemp("torchcli"))
    fasta, _, _, _, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=2, genome_len=4000, seed=21)
    rng = np.random.default_rng(22)
    recs, seqs = [], []
    for i, g in enumerate(genomes):
        for v in range(6):
            s = g if v == 0 else mock.mutate(rng, g, 0.01)
            recs.append((f"NC_{10 * i + v:06d}.1|taxid|{taxids[i]}| v{v}", s))
            seqs.append(s)
    mock.write_fasta(fasta, recs)
    r1, r2 = [], []
    for q in range(240):
        g = seqs[int(rng.integers(0, len(seqs)))]
        p = int(rng.integers(0, len(g) - 400))
        a = mock.mutate(rng, g[p:p + 100], 0.01)
        b = mock.mutate(rng, g[p + 250:p + 350], 0.01)
        if q % 17 == 0:      # ambiguous bases
            a = a[:30] + "NN" + a[32:]
        if q % 23 == 0:      # shorter than k, and random sequence
            a, b = "ACGTACG", mock.random_genome(rng, 100)
        r1.append((f"q{q}_NC_{q % 12:06d}.1 extra", a))
        r2.append((f"q{q}_NC_{q % 12:06d}.1 extra", b))
    mock.write_fasta(os.path.join(tmp, "reads_1.fa"), r1)
    mock.write_fastq(os.path.join(tmp, "reads_2.fq"), r2)
    for cli, db in ((jax_cli, "jdb"), (port_cli, "tdb")):
        r = cli(["build", db, fasta, "-taxonomy", "tax"], tmp)
        assert r.returncode == 0, r.stderr
    return tmp


def _npz(path):
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("shards", [1, 2])
def test_build_shards_equal_jax(world, shards):
    tag = f"s{shards}"
    for cli, db in ((jax_cli, "j" + tag), (port_cli, "t" + tag)):
        r = cli(["build", db, "genomes.fa", "-taxonomy", "tax",
                 "-num-shards", str(shards)], world)
        assert r.returncode == 0, r.stderr
    for s in range(shards):
        want = _npz(os.path.join(world, f"j{tag}_{s}.npz"))
        got = _npz(os.path.join(world, f"t{tag}_{s}.npz"))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _timeless(lines):
    """Lines without the run-dependent '# time:' / '# speed:' lines (an
    interactive prompt may precede them)."""
    return [ln for ln in lines if not ln.replace("$> ", "").startswith(
        ("# time:", "# speed:"))]


def _result_lines(path):
    with open(path) as f:
        return _timeless(f)


QUERY_FLAGS = [
    pytest.param(["-pairfiles", "-lowest", "species"], id="paired-species"),
    pytest.param([], id="single-end"),
    pytest.param(["-pairfiles", "-lowest", "species",
                  "-max-locations-per-query", "64"], id="paired-lmax64"),
    pytest.param(["-pairfiles", "-tophits", "-allhits", "-locations",
                  "-queryids", "-lineage"], id="paired-hits"),
    pytest.param(["-abundances", "-abundance-per", "species", "-precision",
                  "-mapped-only"], id="single-abundances"),
    pytest.param(["-pairfiles", "-exclude", "species", "-precision",
                  "-tophits", "-lowest", "subspecies"], id="exclude-species"),
    pytest.param(["-exclude", "sequence", "-precision"],
                 id="single-exclude-sequence"),
    pytest.param(["-pairfiles", "-hits-per-seq", "-tophits"],
                 id="hits-per-seq"),
    pytest.param(["-pairfiles", "-align"], id="paired-align"),
]


@pytest.mark.parametrize("flags", QUERY_FLAGS)
def test_query_output_equals_jax(world, flags):
    tag = str(abs(hash(tuple(flags))))
    reads = ["reads_1.fa", "reads_2.fq"]
    rj = jax_cli(["query", "jdb"] + reads + flags + ["-out", f"j{tag}.txt"],
                 world)
    assert rj.returncode == 0, rj.stderr
    rt = port_cli(["query", "tdb"] + reads + flags
                  + ["-device", "cpu", "-out", f"t{tag}.txt"], world)
    assert rt.returncode == 0, rt.stderr
    want = _result_lines(os.path.join(world, f"j{tag}.txt"))
    got = _result_lines(os.path.join(world, f"t{tag}.txt"))
    assert len(want) > 200
    assert got == want
    if "-hits-per-seq" in flags:
        assert any("list of hits for each reference" in ln for ln in got)
    if "-align" in flags:
        assert any("aligned to" in ln for ln in got)
    if "64" in flags:   # the truncation contract is exercised, and equal
        assert "match-list overflow" in rj.stderr
        assert [ln for ln in rt.stderr.splitlines() if "overflow" in ln] \
            == [ln for ln in rj.stderr.splitlines() if "overflow" in ln]


def test_splitout_equals_jax(world):
    reads = ["reads_1.fa", "reads_2.fq"]
    for cli, tag in ((jax_cli, "jsplit"), (port_cli, "tsplit")):
        extra = ["-device", "cpu"] if tag == "tsplit" else []
        r = cli(["query", tag[0] + "db"] + reads + extra
                + ["-splitout", tag], world)
        assert r.returncode == 0, r.stderr
    for name in reads:
        assert _result_lines(os.path.join(world, f"tsplit_{name}")) == \
            _result_lines(os.path.join(world, f"jsplit_{name}"))


_NO_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["metacache_tpu"] = None
from metacache_tpu_torch.cli import main
rc = main(["build", "nojaxdb", "genomes.fa", "-taxonomy", "tax", "-silent"])
assert rc == 0, rc
rc = main(["query", "nojaxdb", "reads_1.fa", "reads_2.fq", "-pairfiles",
           "-lowest", "species", "-device", "cpu", "-out", "nojax.txt"])
assert rc == 0, rc
rc = main(["build", "nojaxdb2", "genomes.fa", "-taxonomy", "tax", "-silent",
           "-num-shards", "2"])
assert rc == 0, rc
rc = main(["query", "nojaxdb2", "reads_1.fa", "reads_2.fq", "-pairfiles",
           "-lowest", "species", "-device", "cpu", "-mesh", "-out",
           "nojax_mesh.txt"])
assert rc == 0, rc
for f, r in (("nojax_1.txt", "reads_1.fa"), ("nojax_2.txt", "reads_2.fq")):
    rc = main(["query", "nojaxdb", r, "-tophits", "-queryids", "-lowest",
               "species", "-device", "cpu", "-out", f])
    assert rc == 0, rc
rc = main(["merge", "nojax_1.txt", "nojax_2.txt", "-taxonomy", "tax",
           "-device", "cpu", "-out", "nojax_merged.txt"])
assert rc == 0, rc
rc = main(["info", "nojaxdb", "rank", "species"])
assert rc == 0, rc
rc = main(["modify", "nojaxdb", "extra.fa", "-device", "cpu"])
assert rc == 0, rc
rc = main(["help", "query"])
assert rc == 0, rc
rc = main(["annotate", "extra.fa", "taxid", "-mapping-files", "extra.map",
           "-out", "nojax_annotated.fa"])
assert rc == 0, rc
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
assert not any(m == "metacache_tpu" or m.startswith("metacache_tpu.")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_runs_without_jax(world):
    """The port's modes with both JAX and the JAX package unimportable."""
    mock.write_fasta(os.path.join(world, "extra.fa"),
                     [("NC_777777.1 extra", mock.random_genome(
                         np.random.default_rng(5), 3000))])
    with open(os.path.join(world, "extra.map"), "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n"
                "NC_777777\tNC_777777.1\t4242\t1\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True,
                       text=True, cwd=world, env=env, timeout=600)
    assert r.returncode == 0, r.stderr
    rt = port_cli(["query", "tdb", "reads_1.fa", "reads_2.fq", "-pairfiles",
                   "-lowest", "species", "-device", "cpu", "-out",
                   "withjax.txt"], world)
    assert rt.returncode == 0, rt.stderr
    assert _result_lines(os.path.join(world, "nojax.txt")) == \
        _result_lines(os.path.join(world, "withjax.txt"))
    assert _result_lines(os.path.join(world, "nojax_mesh.txt")) == \
        _result_lines(os.path.join(world, "nojax.txt"))
    assert "shard 1 on cpu" in r.stderr
    assert "Added 1 reference sequences." in r.stdout
    assert 'mode "query"' in r.stdout
    with open(os.path.join(world, "nojax_annotated.fa")) as f:
        assert f.readline() == ">NC_777777.1|taxid|4242| extra\n"


@pytest.mark.parametrize("topic", [[], ["build"], ["query"], ["modify"],
                                   ["info"], ["annotate"], ["merge"],
                                   ["nonsense"]],
                         ids=["quick", "build", "query", "modify", "info",
                              "annotate", "merge", "unknown"])
def test_help_equals_jax(world, topic):
    rj = jax_cli(["help"] + topic, world)
    rt = port_cli(["help"] + topic, world)
    assert (rt.returncode, rt.stdout, rt.stderr) == \
        (rj.returncode, rj.stdout, rj.stderr)
    assert len(rt.stdout.splitlines()) > 10 or topic == ["nonsense"]


def test_annotate_equals_jax(world):
    """annotate: FASTA to stdout and FASTQ to -out; two ids are in the
    mapping, one is not."""
    with open(os.path.join(world, "annot.map"), "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n"
                "NC_000001\tNC_000001.1\t101\t1\n"
                "NC_000002\tNC_000002.3\t102\t2\n")
    recs = [("NC_000001.1 first", "ACGT" * 10),
            ("NC_000002.3 second", "GGCC" * 10),
            ("NC_000003.1 unknown", "TTAA" * 10)]
    mock.write_fasta(os.path.join(world, "annot.fa"), recs)
    mock.write_fastq(os.path.join(world, "annot.fq"), recs)
    outs = []
    for cli, tag in ((jax_cli, "j"), (port_cli, "t")):
        fa = cli(["annotate", "annot.fa", "taxid", "-mapping-files",
                  "annot.map"], world)
        fq = cli(["annotate", "annot.fq", "taxid", "-mapping-files",
                  "annot.map", "-out", f"{tag}annot.fq"], world)
        with open(os.path.join(world, f"{tag}annot.fq")) as f:
            outs.append((fa.returncode, fa.stdout, fa.stderr, fq.returncode,
                         fq.stdout, fq.stderr, f.read()))
    assert outs[1] == outs[0]
    assert "|taxid|101|" in outs[0][1] and "|taxid|102|" in outs[0][6]
    assert "Annotated 2 sequences." in outs[0][2]


@pytest.fixture(scope="module")
def db8(world):
    """The world's genomes in 8 shards, built by the port."""
    r = port_cli(["build", "tdb8", "genomes.fa", "-taxonomy", "tax",
                  "-num-shards", "8"], world)
    assert r.returncode == 0, r.stderr
    return "tdb8"


#: the flag sets of tests/test_cli_mesh.py; the port's -mesh is held to
#: the JAX CLI's -mesh (8 virtual devices) on two, to its own fused query
#: on the others
MESH_FLAGS = [
    pytest.param([], "jax", id="default"),
    pytest.param(["-tophits", "-queryids"], "fused", id="tophits"),
    pytest.param(["-allhits", "-locations"], "fused",
                 id="allhits-locations"),
    pytest.param(["-hits-per-seq"], "fused", id="hits-per-seq"),
    pytest.param(["-abundances", "-abundance-per", "species"], "fused",
                 id="abundances"),
    pytest.param(["-maxcand", "4", "-hitmin", "4", "-hitdiff", "80"],
                 "fused", id="canonical"),
    pytest.param(["-ground-truth", "-precision", "-exclude", "species"],
                 "jax", id="exclude-species"),
    # query-time tuning applies per shard, so it differs from fused
    pytest.param(["-remove-overpopulated-features",
                  "-max-locations-per-feature", "3"], "jax",
                 id="overpopulated-per-shard"),
]


@pytest.mark.parametrize("flags,oracle", MESH_FLAGS)
def test_mesh_query_equals(world, db8, flags, oracle):
    tag = "mesh" + str(abs(hash(tuple(flags))))
    base = ["query", db8, "reads_1.fa", "reads_2.fq", "-pairfiles",
            "-lowest", "species"] + flags
    rt = port_cli(base + ["-mesh", "-device", "cpu", "-out", f"t{tag}.txt"],
                  world)
    assert rt.returncode == 0, rt.stderr
    assert "falling back" not in rt.stderr
    assert "shard 7 on cpu" in rt.stderr
    if oracle == "jax":
        env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
        ro = run("metacache_tpu.cli", base + ["-mesh", "-out", f"o{tag}.txt"],
                 world, env=env)
        assert "falling back" not in ro.stderr
    else:
        ro = port_cli(base + ["-device", "cpu", "-out", f"o{tag}.txt"], world)
        # the fused oracle merges the 8 shards on its device
        assert "# 8 shards merged on cpu" in ro.stderr
    assert ro.returncode == 0, ro.stderr
    want = _result_lines(os.path.join(world, f"o{tag}.txt"))
    assert sum(not ln.startswith("#") for ln in want) >= 240
    assert _result_lines(os.path.join(world, f"t{tag}.txt")) == want


def test_mesh_on_one_shard_runs_fused(world):
    rt = port_cli(["query", "tdb", "reads_1.fa", "-mesh", "-device", "cpu",
                   "-out", "mesh1.txt"], world)
    assert rt.returncode == 0, rt.stderr
    assert "falling back to fused single-device query" in rt.stderr
    rf = port_cli(["query", "tdb", "reads_1.fa", "-device", "cpu", "-out",
                   "fused1.txt"], world)
    assert rf.returncode == 0, rf.stderr
    assert _result_lines(os.path.join(world, "mesh1.txt")) == \
        _result_lines(os.path.join(world, "fused1.txt"))


def test_cuda_without_a_card_raises(world):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = port_cli(["query", "tdb", "reads_1.fa", "-device", "cuda"], world)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr


def test_interactive_query_equals_jax(world):
    """Two lines on stdin; the second changes only -hitmin, so its engine
    is reused."""
    lines = ("reads_1.fa reads_2.fq -pairfiles -lowest species -tophits\n"
             "reads_1.fa reads_2.fq -pairfiles -lowest species -tophits "
             "-hitmin 6\n")
    rj = jax_cli(["query", "jdb"], world, stdin=lines)
    rt = port_cli(["query", "tdb", "-device", "cpu"], world, stdin=lines)
    assert rj.returncode == 0, rj.stderr
    assert rt.returncode == 0, rt.stderr
    want = _timeless(rj.stdout.splitlines())
    assert len(want) > 400 and want[-1] == "$> Terminate."
    assert _timeless(rt.stdout.splitlines()) == want
    assert rt.stderr.count("(reusing loaded engine)") == 1


def test_interactive_mesh_line_runs_fused(world, db8):
    """A stdin line with -mesh runs on the fused database, as in the JAX
    interactive mode."""
    lines = ("reads_1.fa reads_2.fq -pairfiles -lowest species -mesh\n"
             "reads_1.fa -tophits -lowest species\n")
    rj = jax_cli(["query", db8], world, stdin=lines)
    rt = port_cli(["query", db8, "-device", "cpu"], world, stdin=lines)
    assert rj.returncode == 0, rj.stderr
    assert rt.returncode == 0, rt.stderr
    want = _timeless(rj.stdout.splitlines())
    assert len(want) > 480 and want[-1] == "$> Terminate."
    assert _timeless(rt.stdout.splitlines()) == want
    assert "not yet ported" not in rt.stderr


def test_merge_equals_jax(world):
    """merge of two -tophits -queryids result files (one per mate)."""
    for name, reads in (("m1.txt", "reads_1.fa"), ("m2.txt", "reads_2.fq")):
        r = jax_cli(["query", "jdb", reads, "-tophits", "-queryids",
                     "-lowest", "species", "-out", name], world)
        assert r.returncode == 0, r.stderr
    args = ["merge", "m1.txt", "m2.txt", "-taxonomy", "tax", "-verbose"]
    rj = jax_cli(args + ["-out", "jmerged.txt"], world)
    rt = port_cli(args + ["-device", "cpu", "-out", "tmerged.txt"], world)
    assert rj.returncode == 0, rj.stderr
    assert rt.returncode == 0, rt.stderr
    want = _result_lines(os.path.join(world, "jmerged.txt"))
    assert len(want) > 240
    assert _result_lines(os.path.join(world, "tmerged.txt")) == want


@pytest.mark.parametrize("what", [[], ["rank", "species"], ["lineages"],
                                  ["targets"]],
                         ids=["statistics", "rank", "lineages", "targets"])
def test_info_equals_jax(world, what):
    rj = jax_cli(["info", "jdb"] + what, world)
    rt = port_cli(["info", "jdb"] + what, world)
    assert rj.returncode == 0, rj.stderr
    assert rt.returncode == 0, rt.stderr
    assert len(rj.stdout.splitlines()) > 2
    assert rt.stdout == rj.stdout


def _assert_shards_equal(world, jdb, tdb, shards=1):
    for s in range(shards):
        want = _npz(os.path.join(world, f"{jdb}_{s}.npz"))
        got = _npz(os.path.join(world, f"{tdb}_{s}.npz"))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _read_fasta(path):
    recs = []
    with open(path) as f:
        for ln in f:
            if ln.startswith(">"):
                recs.append([ln[1:].rstrip("\n"), ""])
            else:
                recs[-1][1] += ln.strip()
    return recs


def test_modify_equals_jax(world):
    """modify A with B: B holds new records, one already in A and an empty
    one (both skipped)."""
    recs = _read_fasta(os.path.join(world, "genomes.fa"))
    mock.write_fasta(os.path.join(world, "part_a.fa"), recs[:8])
    mock.write_fasta(os.path.join(world, "part_b.fa"),
                     recs[8:] + [recs[2], ("NC_999999.1 empty", "")])
    for cli, db, extra in ((jax_cli, "jmod", []),
                           (port_cli, "tmod", ["-device", "cpu"])):
        r = cli(["build", db, "part_a.fa", "-taxonomy", "tax"], world)
        assert r.returncode == 0, r.stderr
        r = cli(["modify", db, "part_b.fa"] + extra, world)
        assert r.returncode == 0, r.stderr
        assert "Added 4 reference sequences." in r.stdout
    _assert_shards_equal(world, "jmod", "tmod")


@pytest.mark.parametrize("case", ["dup-empty", "dup-empty-2shards",
                                  "sketch80"])
def test_window_batcher_build_equals_jax(world, case):
    """Builds that take the WindowBatcher path: a file with an empty
    record and a repeated id between two files the native pass takes, or
    a sketch size over the native sketcher's 64."""
    recs = _read_fasta(os.path.join(world, "genomes.fa"))
    sub = os.path.join(world, "wb_" + case)
    os.makedirs(sub, exist_ok=True)
    mock.write_fasta(os.path.join(sub, "a.fa"), recs[:4])
    mock.write_fasta(os.path.join(sub, "b.fa"),
                     [recs[4], ("NC_888888.1 empty", ""), recs[1], recs[5]]
                     if case != "sketch80" else recs[4:8])
    mock.write_fasta(os.path.join(sub, "c.fa"), recs[8:])
    extra = {"dup-empty": [], "dup-empty-2shards": ["-num-shards", "2"],
             "sketch80": ["-sketchlen", "80"]}[case]
    for cli, db, dev in ((jax_cli, "jwb", []),
                         (port_cli, "twb", ["-device", "cpu"])):
        r = cli(["build", db, "a.fa", "b.fa", "c.fa", "-taxonomy",
                 os.path.join(world, "tax")] + extra + dev, sub)
        assert r.returncode == 0, r.stderr
    _assert_shards_equal(sub, "jwb", "twb", 2 if "2shards" in case else 1)
    # the empty record and the repeated id were skipped, the rest renumbered
    targets = _npz(os.path.join(sub, "twb_0.npz"))["target_taxon_node"]
    assert len(targets) == (10 if case.startswith("dup") else 12)


def test_load_all_shards_maps_tables(world):
    from metacache_tpu.db.database import Database
    from metacache_tpu_torch.modes.query import load_all_shards
    db = load_all_shards(os.path.join(world, "tdb"))
    want = Database.load(os.path.join(world, "tdb"), 0)
    for name in ("keys", "offsets", "loc_tgt", "loc_win"):
        got = getattr(db.features, name)
        assert isinstance(got, np.memmap), name
        np.testing.assert_array_equal(got, getattr(want.features, name))
    np.testing.assert_array_equal(db.target_taxon_node,
                                  want.target_taxon_node)
