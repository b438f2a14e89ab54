"""The query driver's pipeline (modes/query.py) on the CPU: the batches
dispatched on one thread and written in dispatch order on a writer
thread give the result file of the sequential driver and of the JAX CLI,
byte for byte (fused, -mesh, -pairfiles, -query-limit; the batches end
mid-window and the last one is short); the formatter's numpy taxon-string
rows equal the per-read loop they replace; a failure while formatting,
dispatching or reading surfaces from process_files at once and leaves no
thread running; and no more than IN_FLIGHT batches are ever dispatched
and not yet written."""
import io
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from metacache_tpu_torch import cli, native
from metacache_tpu_torch.modes import query as qm
from metacache_tpu_torch.utils import ArgsParser
from tests import util_mockdata as mock
from tests.test_torch_cli import _result_lines, jax_cli, run

torch.set_num_threads(1)

#: 230 reads (pairs) in batches of 16: 14 full batches and one of 6, so
#: the last batch is short and the count is no multiple of 8 batches
READS = 230
BATCH = "16"
THREADS = ("metacache-reader", "metacache-writer")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two base genomes with strain variants, paired reads, and the JAX
    CLI's database in one and in two shards."""
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    fasta, _, _, _, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=2, genome_len=4000, seed=31)
    rng = np.random.default_rng(32)
    recs, seqs = [], []
    for i, g in enumerate(genomes):
        for v in range(4):
            s = g if v == 0 else mock.mutate(rng, g, 0.01)
            recs.append((f"NC_{10 * i + v:06d}.1|taxid|{taxids[i]}| v{v}", s))
            seqs.append(s)
    mock.write_fasta(fasta, recs)
    r1, r2 = [], []
    for q in range(READS):
        g = seqs[int(rng.integers(0, len(seqs)))]
        p = int(rng.integers(0, len(g) - 400))
        a = mock.mutate(rng, g[p:p + 100], 0.01)
        b = mock.mutate(rng, g[p + 250:p + 350], 0.01)
        if q % 19 == 0:      # unclassified: random sequence
            a = b = mock.random_genome(rng, 100)
        r1.append((f"q{q}_NC_{q % 8:06d}.1 extra", a))
        r2.append((f"q{q}_NC_{q % 8:06d}.1 extra", b))
    mock.write_fasta(os.path.join(tmp, "reads_1.fa"), r1)
    mock.write_fastq(os.path.join(tmp, "reads_2.fq"), r2)
    for db, shards in (("db1", "1"), ("db2", "2")):
        r = jax_cli(["build", db, fasta, "-taxonomy", "tax", "-num-shards",
                     shards], tmp)
        assert r.returncode == 0, r.stderr
    return tmp


CASES = {
    "fused": ["db1", "reads_1.fa"],
    "mesh": ["db2", "reads_1.fa", "reads_2.fq", "-pairfiles", "-mesh"],
    "pairfiles": ["db1", "reads_1.fa", "reads_2.fq", "-pairfiles",
                  "-lowest", "species", "-abundances", "-abundance-per",
                  "species", "-mapped-only"],
    "query-limit": ["db2", "reads_1.fa", "reads_2.fq", "-pairfiles",
                    "-query-limit", "100"],
}


def port_query(world, args, out, monkeypatch, threaded):
    """The port's CLI in this process, its writer on a thread or not."""
    monkeypatch.setattr(qm.QueryProcessor, "write_on_thread", threaded)
    monkeypatch.chdir(world)
    rc = cli.main(["query"] + args + ["-batch-size", BATCH, "-device", "cpu",
                                      "-out", out])
    assert rc == 0
    assert not [t for t in threading.enumerate() if t.name in THREADS]
    return _result_lines(os.path.join(world, out))


@pytest.mark.parametrize("case", sorted(CASES))
def test_threaded_driver_equals_sequential_and_jax(world, case, monkeypatch):
    args = CASES[case]
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    rj = run("metacache_tpu.cli", ["query"] + args + [
        "-batch-size", BATCH, "-out", f"j_{case}.txt"], world, env=env)
    assert rj.returncode == 0, rj.stderr
    assert "falling back" not in rj.stderr
    want = _result_lines(os.path.join(world, f"j_{case}.txt"))
    mapped = sum(not ln.startswith("#") for ln in want)
    if "-mapped-only" in args:
        assert 0 < mapped < READS
    else:
        assert mapped == (100 if "-query-limit" in args else READS)
    seq = port_query(world, args, f"s_{case}.txt", monkeypatch, False)
    thr = port_query(world, args, f"t_{case}.txt", monkeypatch, True)
    assert seq == want
    assert thr == want


def old_rows(table, order, best, mapped_only):
    """The per-read loop the numpy rows replace: each new node of the
    batch (in np.unique's order) appended, then a dict lookup per read."""
    for nd in np.unique(best).tolist():
        if nd not in table:
            table[nd] = len(order)
            order.append(f"taxon<{nd}>".encode())
    sidx = np.fromiter((table[nd] for nd in best.tolist()), np.int64,
                       len(best))
    if mapped_only:
        sidx = np.where(best == 0, np.int64(-1), sidx)
    return sidx


@pytest.mark.parametrize("mapped_only", [False, True])
def test_taxon_rows_equal_per_read_loop(mapped_only):
    rng = np.random.default_rng(5)
    strings = qm.TaxonStrings(lambda nd: f"taxon<{nd}>".encode())
    table, order = {}, []
    for batch in range(40):
        # a few nodes at first, then unseen ones; node 0 in every batch
        hi = 5 + batch * 50
        best = rng.integers(0, hi, size=int(rng.integers(1, 300)))
        best[rng.random(len(best)) < 0.2] = 0
        best = best.astype(np.int32)
        nodes, inverse = np.unique(best, return_inverse=True)
        got = strings.rows(best, nodes, inverse, mapped_only)
        want = old_rows(table, order, best, mapped_only)
        np.testing.assert_array_equal(got, want)
        strs, soff = strings.table()
        assert strs.tobytes() == b"".join(order)
        np.testing.assert_array_equal(
            soff, np.concatenate([[0], np.cumsum([len(x) for x in order])]))


@pytest.fixture
def processor(world):
    """A QueryProcessor over the one-shard database on the CPU, batches
    of 4 reads (58 batches)."""
    args = ArgsParser(["query", "db1", "-batch-size", "4", "-device", "cpu"])
    dev = torch.device("cpu")
    opt = qm.get_query_options(args, dev)
    db = qm.open_all_shards(os.path.join(world, "db1"))
    qm._adapt_options_to_database(opt, db)
    engine = qm.QueryEngine(db, opt.classify, opt.pipeline, device=dev)
    return lambda: qm.QueryProcessor(db, opt, engine)


def run_bounded(fn, seconds):
    """fn() on a thread -> (its exception or None, seconds it took);
    fails if it is still running after `seconds`."""
    got = {}

    def body():
        try:
            fn()
        except BaseException as e:
            got["error"] = e
    t0 = time.time()
    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "process_files hangs"
    return got.get("error"), time.time() - t0


@pytest.mark.parametrize("where", ["format", "dispatch", "reader"])
def test_failure_surfaces_and_stops_threads(world, processor, where,
                                            monkeypatch):
    calls = [0]

    def fail_third(fn):
        def run_(*a, **k):
            calls[0] += 1
            if calls[0] == 3:
                raise RuntimeError(f"injected {where} failure")
            return fn(*a, **k)
        return run_

    if where == "format":
        monkeypatch.setattr(native, "format_mapping_lines",
                            fail_third(native.format_mapping_lines))
    elif where == "dispatch":
        monkeypatch.setattr(qm.QueryEngine, "dispatch_packed",
                            fail_third(qm.QueryEngine.dispatch_packed))
    else:
        monkeypatch.setattr(native.NativeBatchReader, "__next__",
                            fail_third(native.NativeBatchReader.__next__))
    proc = processor()
    err, took = run_bounded(lambda: proc.process_files(
        [os.path.join(world, "reads_1.fa")], io.StringIO()), 60)
    assert isinstance(err, RuntimeError) and where in str(err)
    assert took < 30
    assert not [t for t in threading.enumerate() if t.name in THREADS]


def test_in_flight_bounded_and_text_output(world, processor, monkeypatch):
    """While the first batch is being written, the dispatcher stops at
    IN_FLIGHT batches not yet written; with the threads switched every
    10 us, the lines written to a StringIO (no binary buffer) equal the
    sequential driver's in a file."""
    state = dict(dispatched=0, written=0, most=0)
    dispatch = qm.QueryEngine.dispatch_packed
    finalize = qm.QueryProcessor._finalize_window

    def counted_dispatch(self, *a, **k):
        state["dispatched"] += 1
        state["most"] = max(state["most"],
                            state["dispatched"] - state["written"])
        return dispatch(self, *a, **k)

    def slow_finalize(self, window, out):
        if state["written"] == 0:   # give the dispatcher time to overrun
            t0 = time.time()
            while state["dispatched"] <= qm.IN_FLIGHT \
                    and time.time() - t0 < 3:
                time.sleep(0.01)
        finalize(self, window, out)
        state["written"] += len(window)

    monkeypatch.setattr(qm.QueryEngine, "dispatch_packed", counted_dispatch)
    monkeypatch.setattr(qm.QueryProcessor, "_finalize_window", slow_finalize)
    reads = [os.path.join(world, "reads_1.fa")]
    text = io.StringIO()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        err, _ = run_bounded(lambda: processor().process_files(reads, text),
                             120)
    finally:
        sys.setswitchinterval(interval)
    assert err is None
    assert state["written"] == state["dispatched"] == -(-READS // 4)
    assert state["most"] == qm.IN_FLIGHT
    monkeypatch.setattr(qm.QueryProcessor, "write_on_thread", False)
    path = os.path.join(world, "pipeline_file.txt")
    with open(path, "w") as f:
        processor().process_files(reads, f)
    assert _result_lines(path) == [
        ln + "\n" for ln in text.getvalue().split("\n")[:-1]]
    assert sum(1 for ln in _result_lines(path)
               if not ln.startswith("#")) == READS


def test_default_output_never_decodes_headers(world, monkeypatch):
    """Without -exclude or an evaluation flag, no read's header is decoded
    in Python: the native formatter prints them from the raw bytes."""
    def no_decode(self):
        raise AssertionError("a batch's headers were decoded")

    monkeypatch.setattr(native.PackedBatch, "headers", property(no_decode))
    for case in ("fused", "mesh", "pairfiles"):
        got = port_query(world, CASES[case], f"h_{case}.txt", monkeypatch,
                         True)
        assert sum(not ln.startswith("#") for ln in got) > 0
