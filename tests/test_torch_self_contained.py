"""The port stands on its own: no module of metacache_tpu_torch, nor
chip_smoke.py, imports the JAX package (metacache_tpu); the port tracks no
prebuilt library and builds libmcio from its own copy of the source; and
the database files of the two packages are one format: each package
reads what the other writes, array for array, and the port's engine gives
the same per-read results on a database carried over as plain arrays
(database_from_arrays) as on one read from a file. Exact equality."""
import ast
import dataclasses
import glob
import os
import subprocess

import numpy as np
import pytest
import torch

from metacache_tpu import config as jconfig
from metacache_tpu.db.build import BuildOptions, build_database
from metacache_tpu.db.database import Database as JaxDatabase
from metacache_tpu.query.engine import QueryEngine as JaxEngine
from metacache_tpu.query.engine import encode_read_into
from metacache_tpu_torch import config as tconfig
from metacache_tpu_torch import native
from metacache_tpu_torch.db.database import Database, database_from_arrays
from metacache_tpu_torch.ops.cuda_build import BUILD_DIR
from metacache_tpu_torch.query.engine import QueryEngine
from tests import util_mockdata as mock

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "metacache_tpu_torch")
SOURCES = sorted(glob.glob(os.path.join(PORT, "**", "*.py"),
                           recursive=True)) \
    + [os.path.join(REPO, "chip_smoke.py")]
IMPORTERS = {"import_module", "__import__"}


def _package_of(path, root):
    """The dotted package a file's relative imports start from."""
    rel = os.path.relpath(os.path.dirname(path), root)
    return [] if rel == "." else rel.split(os.sep)


def jax_package_imports(path, root=REPO):
    """Every import of the JAX package in one file: absolute, relative
    (resolved from the file's package; one that climbs out of the top
    package counts), or a module name given as a string to
    importlib.import_module / __import__. -> [(line, module name)]."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    pkg = _package_of(path, root)
    found = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names = [node.module]
            elif node.level - 1 >= len(pkg):
                names = ["<outside the package>"]
            else:
                base = pkg[:len(pkg) - (node.level - 1)]
                names = [".".join(base + ([node.module] if node.module
                                          else []))]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in IMPORTERS:
                names = [node.args[0].value]
        for n in names:
            if n == "<outside the package>" or n == "metacache_tpu" \
                    or n.startswith("metacache_tpu."):
                found.append((node.lineno, n))
    return found


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, REPO) for p in SOURCES])
def test_no_import_of_the_jax_package(path):
    assert jax_package_imports(path) == []


def test_scan_finds_every_kind_of_import(tmp_path):
    """The scan itself, on a module of the port's layout that imports the
    JAX package in each way it looks for."""
    sub = tmp_path / "metacache_tpu_torch" / "ops"
    sub.mkdir(parents=True)
    src = sub / "bad.py"
    src.write_text(
        "import importlib\n"
        "import metacache_tpu\n"
        "import numpy, metacache_tpu.config as c\n"
        "from metacache_tpu.db import database\n"
        "from ... import metacache_tpu\n"
        "from . import encode\n"
        "from ..db import taxonomy\n"
        "m = importlib.import_module('metacache_tpu.native')\n"
        "n = __import__('metacache_tpu')\n"
        "o = importlib.import_module('metacache_tpu_torch.cli')\n")
    assert jax_package_imports(str(src), str(tmp_path)) == [
        (2, "metacache_tpu"), (3, "metacache_tpu.config"),
        (4, "metacache_tpu.db"), (5, "<outside the package>"),
        (8, "metacache_tpu.native"), (9, "metacache_tpu")]


def test_port_tracks_no_library():
    """No prebuilt shared object lies in the port's package (libmcio and
    the kernels are built into build/ at first use), none is tracked."""
    libs = [p for ext in ("so", "dylib", "pyd")
            for p in glob.glob(os.path.join(PORT, "**", f"*.{ext}"),
                               recursive=True)]
    assert libs == []
    if os.path.isdir(os.path.join(REPO, ".git")):
        tracked = subprocess.run(
            ["git", "ls-files", "metacache_tpu_torch"], cwd=REPO,
            capture_output=True, text=True, check=True).stdout.split()
        assert tracked and not [t for t in tracked if t.endswith(".so")]


def test_libmcio_is_built_from_the_port_source():
    path = native.library_path()
    assert os.path.dirname(path) == BUILD_DIR
    name = os.path.basename(path)
    assert name.startswith("libmcio_") and name.endswith(".so")
    assert native._SRC == os.path.join(PORT, "native", "mcio.cpp")
    lib = native.load_mcio()
    assert lib._name == path


# ----------------------------------------------------------------- formats
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A JAX-built database (3 species x 3 strains, with a taxonomy) and
    64 read pairs."""
    tmp = str(tmp_path_factory.mktemp("selfcontained"))
    fasta, nodes, names, merged, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=3, genome_len=2500, seed=51)
    rng = np.random.default_rng(52)
    recs = []
    for i, g in enumerate(genomes):
        for v in range(3):
            recs.append((f"NC_{10 * i + v:06d}.1|taxid|{taxids[i]}| v",
                         g if v == 0 else mock.mutate(rng, g, 0.015)))
    mock.write_fasta(fasta, recs)
    jdb = build_database([fasta], BuildOptions(
        taxonomy_nodes=nodes, taxonomy_names=names, taxonomy_merged=merged))
    reads = []
    for _ in range(64):
        g = recs[int(rng.integers(0, len(recs)))][1]
        p = int(rng.integers(0, len(g) - 300))
        reads.append((mock.mutate(rng, g[p:p + 100], 0.01),
                      mock.mutate(rng, g[p + 150:p + 250], 0.01)))
    return tmp, jdb, reads


def arrays(db):
    """Every array and value a shard file holds, by name."""
    ft = db.features
    out = {"keys": ft.keys, "offsets": ft.offsets, "loc_tgt": ft.loc_tgt,
           "loc_win": ft.loc_win, "target_taxon_node": db.target_taxon_node,
           "sketch": dataclasses.astuple(db.sketch_params),
           "query_sketch": dataclasses.astuple(db.query_sketch_params),
           "max_locations_per_feature": db.max_locations_per_feature,
           "num_shards": db.num_shards, "shard_id": db.shard_id}
    out.update({f"tax_{k}": v for k, v in db.taxonomy.to_arrays().items()})
    return out


def assert_same(got, want):
    a, b = arrays(got), arrays(want)
    assert sorted(a) == sorted(b)
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def port_db(jdb):
    """A JAX-built database (or shard) as the port's Database, through
    plain arrays; the port's engine tests share it."""
    ft = jdb.features
    return database_from_arrays(
        sketch=dataclasses.astuple(jdb.sketch_params),
        query_sketch=dataclasses.astuple(jdb.query_sketch_params),
        max_locations_per_feature=jdb.max_locations_per_feature,
        taxonomy=jdb.taxonomy.to_arrays(),
        target_taxon_node=jdb.target_taxon_node,
        features=dict(keys=ft.keys, offsets=ft.offsets, loc_tgt=ft.loc_tgt,
                      loc_win=ft.loc_win),
        num_shards=jdb.num_shards, shard_id=jdb.shard_id)


@pytest.mark.parametrize("mmap", [False, True])
def test_jax_written_database_loads_in_port(world, mmap):
    tmp, jdb, _ = world
    base = os.path.join(tmp, "by_jax")
    jdb.save(base)
    assert_same(Database.load(base, 0, mmap=mmap), jdb)


def test_port_written_database_loads_in_jax(world):
    tmp, jdb, _ = world
    base = os.path.join(tmp, "by_port")
    got = port_db(jdb).save(base)
    assert_same(JaxDatabase.load(base, 0), jdb)
    want = jdb.save(os.path.join(tmp, "by_jax_ref"))
    with np.load(got, allow_pickle=True) as a, \
            np.load(want, allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("paired", [False, True])
def test_database_from_arrays_serves_the_engine(world, paired):
    """The port's engine on the JAX-built database carried over as plain
    arrays, on the same database read from the JAX package's file, and the
    JAX engine: equal per-read results."""
    tmp, jdb, reads = world
    base = os.path.join(tmp, "for_engine")
    jdb.save(base)
    kw = dict(lowest_rank="species", max_candidates=3)
    pw = dict(batch_size=64, max_query_len=128, max_locations_per_query=256)
    classify, pipeline = tconfig.ClassifyParams(**kw), \
        tconfig.QueryPipelineParams(**pw)
    engines = [QueryEngine(db, classify, pipeline)
               for db in (port_db(jdb), Database.load(base, 0))]
    c1, l1, c2, l2 = engines[0].make_host_buffers()
    for i, (a, b) in enumerate(reads):
        encode_read_into(c1, l1, i, a, 128)
        if paired:
            encode_read_into(c2, l2, i, b, 128)
    n = len(reads)
    got = [e.classify_batch(c1, l1, c2, l2, n) for e in engines]
    want = JaxEngine(jdb, jconfig.ClassifyParams(**kw),
                     jconfig.QueryPipelineParams(**pw)).classify_batch(
        c1, l1, c2, l2, n)
    for f in ("best", "best_rank", "match_total", "cand_tax", "cand_hits",
              "cand_tgt"):
        for g in got:
            np.testing.assert_array_equal(getattr(g, f)[:n],
                                          np.asarray(getattr(want, f))[:n],
                                          err_msg=f)
    assert (got[0].best[:n] > 0).sum() > n // 2
