"""The port's CLI (python -m metacache_tpu_torch.cli) against the JAX CLI
(python -m metacache_tpu.cli) on a mock world: `build` writes shard files
equal array by array, `query -device cpu` writes byte-identical mapping
files (the run-dependent '# time:' / '# speed:' lines aside). Also: the
port runs with JAX made unimportable, and options outside the ported
slice fail with a clear message."""
import os
import subprocess
import sys

import numpy as np
import pytest

from tests import util_mockdata as mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(module, args, tmp):
    env = dict(os.environ, METACACHE_PLATFORM="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module] + args,
                          capture_output=True, text=True, cwd=tmp, env=env,
                          timeout=600)


def jax_cli(args, tmp):
    return run("metacache_tpu.cli", args, tmp)


def port_cli(args, tmp):
    return run("metacache_tpu_torch.cli", args, tmp)


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


def _result_lines(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith(("# time:", "# speed:"))]


QUERY_FLAGS = [
    pytest.param(["-pairfiles", "-lowest", "species"], id="paired-species"),
    pytest.param([], id="single-end"),
    pytest.param(["-pairfiles", "-lowest", "species",
                  "-max-locations-per-query", "64"], id="paired-lmax64"),
    pytest.param(["-pairfiles", "-tophits", "-allhits", "-locations",
                  "-queryids", "-lineage"], id="paired-hits"),
    pytest.param(["-abundances", "-abundance-per", "species", "-precision",
                  "-mapped-only"], id="single-abundances"),
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
from metacache_tpu_torch.cli import main
rc = main(["build", "nojaxdb", "genomes.fa", "-taxonomy", "tax", "-silent"])
assert rc == 0, rc
rc = main(["query", "nojaxdb", "reads_1.fa", "reads_2.fq", "-pairfiles",
           "-lowest", "species", "-device", "cpu", "-out", "nojax.txt"])
assert rc == 0, rc
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
"""


def test_port_runs_without_jax(world):
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


@pytest.mark.parametrize("args", [
    pytest.param(["query", "tdb", "reads_1.fa", "-mesh"], id="mesh"),
    pytest.param(["query", "tdb", "reads_1.fa", "-exclude", "species"],
                 id="exclude"),
    pytest.param(["query", "tdb", "reads_1.fa", "-hits-per-seq"],
                 id="hits-per-seq"),
    pytest.param(["query", "tdb"], id="interactive"),
    pytest.param(["merge", "x.txt", "-taxonomy", "tax"], id="merge-mode"),
])
def test_unported_options_fail_clearly(world, args):
    r = port_cli(args + ["-device", "cpu"], world)
    assert r.returncode == 1
    assert "not yet ported" in r.stderr


def test_cuda_without_a_card_raises(world):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = port_cli(["query", "tdb", "reads_1.fa", "-device", "cuda"], world)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
