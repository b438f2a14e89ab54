"""Bad input files in the port's `build` and `modify`, held to the JAX
package as the oracle: a file in no known format (a header-only NCBI
assembly_summary.txt beside the genomes, as a RefSeq download lays it
out) and a FASTQ with a broken record after good ones are reported as
`FAIL: <path>: <error>` (build: stdout, modify: stderr) and left out,
and the run exits 0 with the JAX CLI's shards. On the native paths the
whole bad file is left out; on the WindowBatcher path (a sketch size over
64) and in `modify` the records read before the break stay. In process:
the spill path deletes a bad file's chunks, and a chunk that cannot be
written still ends the build."""
import os

import numpy as np
import pytest

from tests import util_mockdata as mock
from tests.test_torch_cli import _assert_shards_equal, jax_cli, port_cli

#: a header-only assembly_summary.txt, as NCBI's genome directories hold it
ASSEMBLY_SUMMARY = (
    "#   See ftp://ftp.ncbi.nlm.nih.gov/genomes/README_assembly_summary.txt"
    " for a description of the columns in this file.\n"
    "# assembly_accession\tbioproject\tbiosample\twgs_master\t"
    "refseq_category\ttaxid\tspecies_taxid\torganism_name\t"
    "infraspecific_name\tisolate\tversion_status\tassembly_level\t"
    "release_type\tgenome_rep\tseq_rel_date\tasm_name\tsubmitter\t"
    "gff_ftp_path\texcluded_from_refseq\n")
#: a FASTQ record whose quality header is missing (the file ends there)
BROKEN_RECORD = "@NC_000099.1 broken\nACGTACGTAC\n"
NOT_RECOGNIZED = ("FAIL: genomes/assembly_summary.txt: file format not "
                  "recognized: genomes/assembly_summary.txt")
BROKEN_FASTQ = "FAIL: genomes/b.fq: malformed fastq file - quality header: "


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Six genomes: a.fa (0-1), b.fq (2-3, then a broken record), c.fa
    (4-5) and a header-only assembly_summary.txt in genomes/; the one
    FASTA of the reproduction in summary/."""
    tmp = str(tmp_path_factory.mktemp("torchbuilderr"))
    fasta, _, _, _, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=6, genome_len=3000, seed=31)
    recs = [(f"NC_{i:06d}.1|taxid|{taxids[i]}| Mock genome {i}", g)
            for i, g in enumerate(genomes)]
    for sub in ("genomes", "summary"):
        os.makedirs(os.path.join(tmp, sub))
        with open(os.path.join(tmp, sub, "assembly_summary.txt"), "w") as f:
            f.write(ASSEMBLY_SUMMARY)
    mock.write_fasta(os.path.join(tmp, "summary", "genomes.fa"), recs[:4])
    mock.write_fasta(os.path.join(tmp, "genomes", "a.fa"), recs[:2])
    mock.write_fastq(os.path.join(tmp, "genomes", "b.fq"), recs[2:4])
    with open(os.path.join(tmp, "genomes", "b.fq"), "a") as f:
        f.write(BROKEN_RECORD)
    mock.write_fasta(os.path.join(tmp, "genomes", "c.fa"), recs[4:])
    return tmp


def _fail_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("FAIL: ")]


def _targets(path):
    with np.load(path, allow_pickle=True) as z:
        return len(z["target_taxon_node"])


BUILD_CASES = [
    # the reproduction: one FASTA of 4 genomes beside the summary file
    pytest.param("summary", [], 1, [NOT_RECOGNIZED.replace(
        "genomes/", "summary/")], 4, id="assembly-summary"),
    # native in-RAM path: all of b.fq is left out
    pytest.param("genomes", [], 1, [NOT_RECOGNIZED, BROKEN_FASTQ], 4,
                 id="native-broken-fastq"),
    # WindowBatcher path: b.fq's two good records stay
    pytest.param("genomes", ["-sketchlen", "80"], 1,
                 [NOT_RECOGNIZED, BROKEN_FASTQ], 6, id="window-batcher"),
    pytest.param("genomes", ["-num-shards", "2"], 2,
                 [NOT_RECOGNIZED, BROKEN_FASTQ], 4, id="2-shards"),
]


@pytest.mark.parametrize("inputs,flags,shards,fails,targets", BUILD_CASES)
def test_build_skips_bad_files_as_jax(world, inputs, flags, shards, fails,
                                      targets):
    tag = str(abs(hash((inputs,) + tuple(flags))))
    outs = []
    for cli, db, dev in ((jax_cli, "j" + tag, []),
                         (port_cli, "t" + tag, ["-device", "cpu"])):
        r = cli(["build", db, inputs, "-taxonomy", "tax"] + flags + dev,
                world)
        assert r.returncode == 0, r.stderr
        outs.append(_fail_lines(r.stdout))
    assert outs[1] == outs[0] == fails
    _assert_shards_equal(world, "j" + tag, "t" + tag, shards)
    assert _targets(os.path.join(world, f"t{tag}_0.npz")) == targets


def test_modify_skips_bad_file_as_jax(world):
    """modify adds b.fq (its two good records stay) and c.fa beside the
    summary file to a database of a.fa."""
    outs = []
    for cli, db, dev in ((jax_cli, "jmodbad", []),
                         (port_cli, "tmodbad", ["-device", "cpu"])):
        r = cli(["build", db, "genomes/a.fa", "-taxonomy", "tax"] + dev,
                world)
        assert r.returncode == 0, r.stderr
        r = cli(["modify", db, "genomes/assembly_summary.txt",
                 "genomes/b.fq", "genomes/c.fa"] + dev, world)
        assert r.returncode == 0, r.stderr
        outs.append((_fail_lines(r.stderr), [
            ln for ln in r.stdout.splitlines() if ln.startswith("Added ")]))
    assert outs[1] == outs[0] == (
        [NOT_RECOGNIZED, BROKEN_FASTQ], ["Added 4 reference sequences."])
    _assert_shards_equal(world, "jmodbad", "tmodbad")


def _spill_build(monkeypatch, world, build_mod, opt, files, out):
    """One in-process build of `files` with every file on the spill path
    (SPILL_MIN_BYTES 0); the database is saved to `out`."""
    monkeypatch.setattr(build_mod, "SPILL_MIN_BYTES", 0)
    monkeypatch.chdir(world)
    db = build_mod.build_database_shards(files, opt)[0]
    db.save(os.path.join(world, out))


SPILL_FILES = ["genomes/a.fa", "genomes/b.fq", "genomes/c.fa"]


def test_spill_path_skips_bad_file_and_deletes_its_chunks(
        world, monkeypatch, capsys):
    import metacache_tpu.db.build as jbuild
    from metacache_tpu_torch import native
    from metacache_tpu_torch.db import build as tbuild
    from metacache_tpu_torch.io import sequence_io
    chunk = 200
    _spill_build(monkeypatch, world, jbuild,
                 jbuild.BuildOptions(chunk_triples=chunk), SPILL_FILES,
                 "jspill")
    want = _fail_lines(capsys.readouterr().out)

    deleted, seen = [], {}
    spill, unlink = native.sketch_file_spill, os.unlink

    def spy(path, *args, prefix, **kw):
        """The spill pass of one file; for a bad one, its chunk files as
        the error leaves them, and those deleted."""
        try:
            return spill(path, *args, prefix=prefix, **kw)
        except sequence_io.FormatError:
            d, name = os.path.split(prefix)
            mine = name + "."
            seen[path] = ([f for f in os.listdir(d) if f.startswith(mine)],
                          [p for p in deleted
                           if os.path.basename(p).startswith(mine)])
            raise

    monkeypatch.setattr(native, "sketch_file_spill", spy)
    monkeypatch.setattr(os, "unlink", lambda p, *a, **k: (
        deleted.append(p), unlink(p, *a, **k))[1])
    monkeypatch.setattr(tbuild, "CHUNK_TRIPLES", chunk)
    _spill_build(monkeypatch, world, tbuild,
                 tbuild.BuildOptions(device="cpu"), SPILL_FILES, "tspill")
    assert _fail_lines(capsys.readouterr().out) == want == [BROKEN_FASTQ]
    # b.fq wrote chunks before its broken record; none is left
    left, gone = seen["genomes/b.fq"]
    assert left == [] and len(gone) >= 2
    _assert_shards_equal(world, "jspill", "tspill")


def test_spill_chunk_write_failure_ends_the_build(world, monkeypatch,
                                                  tmp_path):
    """A spill directory that cannot take a chunk: the build raises
    (kept divergence: the JAX build reports the file and goes on)."""
    from metacache_tpu_torch.db import build as tbuild
    missing = str(tmp_path / "no" / "such" / "dir")
    mkdtemp = tbuild.tempfile.mkdtemp
    monkeypatch.setattr(tbuild.tempfile, "mkdtemp", lambda prefix, **kw: (
        missing if prefix == "mc_spill_" else mkdtemp(prefix=prefix, **kw)))
    with pytest.raises(OSError, match="can't create spill chunk"):
        _spill_build(monkeypatch, world, tbuild,
                     tbuild.BuildOptions(device="cpu"), ["genomes/a.fa"],
                     "tspillio")
