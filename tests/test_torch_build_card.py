"""The card path of the port's build (db/build.py::build_shards_on_card:
the native record stream, the window sketch, the device triple stores
sorted and finalized on their device) run on the CPU, where the window
sketch is its plain version (ops/sketch.py::sketch_windows_reference),
against the JAX CLI's build of the same files (run as
tests/test_torch_cli.py runs it): every array of every shard file equal,
zero tolerance. Worlds: genomes with N runs, IUPAC codes, lower case and
tail windows, a record shorter than a window and one shorter than k, a
repeat that puts features past the 254-location cap across many records,
and a FASTQ that breaks after two good records. Stores small enough to
spill several chunks give the same arrays as stores that never spill."""
import os

import numpy as np
import pytest
import torch

from tests import util_mockdata as mock
from tests.test_torch_cli import _assert_shards_equal, _npz, jax_cli

W, STRIDE = 128, 113
#: the record stream's batches in these tests: a few records each
BATCH_BYTES = 4096
BROKEN_RECORD = "@NC_000777.1 broken\nACGTACGTAC\n"


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _with_noise(rng, seq: str) -> str:
    """seq with runs of N, single IUPAC codes and a lower-case stretch."""
    a = np.array(list(seq))
    for _ in range(3):
        p = int(rng.integers(0, len(a) - 20))
        a[p:p + int(rng.integers(1, 20))] = "N"
    for p in rng.integers(0, len(a), 6):
        a[p] = rng.choice(list("RYKMSW"))
    p = int(rng.integers(0, len(a) - 200))
    a[p:p + 200] = np.char.lower(a[p:p + 200])
    return "".join(a)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """a.fa: six genomes with noise and lengths that leave tail windows,
    one of 90 bases (one short window) and one of 10 (shorter than k);
    rep.fa: 24 records holding a 200-base repeat 14 times each (features
    past the 254 cap in one shard); bad.fq: two good records, then a
    broken one; c.fa: three more genomes; dup.fa: an empty record and one
    that repeats an id of a.fa between two new ones (the WindowBatcher's
    file)."""
    tmp = str(tmp_path_factory.mktemp("torchbuildcard"))
    _, _, _, _, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=6, genome_len=2000, seed=61)
    rng = np.random.default_rng(62)
    recs = [(f"NC_{i:06d}.1|taxid|{taxids[i]}| g{i}",
             _with_noise(rng, g[:2000 - 37 * i]))
            for i, g in enumerate(genomes)]
    recs += [("NC_000090.1 short", mock.random_genome(rng, 90)),
             ("NC_000091.1 tiny", mock.random_genome(rng, 10))]
    mock.write_fasta(os.path.join(tmp, "a.fa"), recs)
    repeat = mock.random_genome(rng, 200)
    rep = []
    for r in range(24):
        parts = []
        for _ in range(14):
            parts.append(mock.random_genome(rng, int(rng.integers(60, 200))))
            parts.append(repeat)
        rep.append((f"NC_{100 + r:06d}.1|taxid|{taxids[r % 6]}| rep",
                    "".join(parts)))
    mock.write_fasta(os.path.join(tmp, "rep.fa"), rep)
    good = [(f"NC_{200 + i:06d}.1|taxid|{taxids[i]}| q",
             _with_noise(rng, mock.random_genome(rng, 6000)))
            for i in range(2)]
    mock.write_fastq(os.path.join(tmp, "bad.fq"), good)
    with open(os.path.join(tmp, "bad.fq"), "a") as f:
        f.write(BROKEN_RECORD)
    mock.write_fasta(os.path.join(tmp, "c.fa"), [
        (f"NC_{300 + i:06d}.1|taxid|{taxids[i]}| c", mock.mutate(
            rng, genomes[i], 0.02)) for i in range(3)])
    mock.write_fasta(os.path.join(tmp, "dup.fa"), [
        (f"NC_000400.1|taxid|{taxids[0]}| new", mock.random_genome(rng, 900)),
        ("NC_000401.1 empty", ""), recs[1],
        (f"NC_000402.1|taxid|{taxids[1]}| new", mock.random_genome(rng, 700))])
    return tmp


_jax_builds = {}


def _jax_build(world, files, flags):
    """The JAX CLI's build of `files` (once per arguments) -> (its name,
    its FAIL lines)."""
    key = (tuple(files), tuple(flags))
    if key not in _jax_builds:
        name = f"j{len(_jax_builds)}"
        r = jax_cli(["build", name] + files + ["-taxonomy", "tax"] + flags,
                    world)
        assert r.returncode == 0, r.stderr
        _jax_builds[key] = (name, [ln for ln in r.stdout.splitlines()
                                   if ln.startswith("FAIL: ")])
    return _jax_builds[key]


def _card_build(world, monkeypatch, files, flags, name, shard_ids=None,
                store_triples=None):
    """The card path on the CPU with the CLI's options for `flags`, in
    batches of at most BATCH_BYTES sequence bytes (a longer record gets a
    buffer of its own); the shards it built saved as '<name>_<s>.npz'."""
    from metacache_tpu_torch.db import build as tbuild
    from metacache_tpu_torch.modes.build import get_build_options
    from metacache_tpu_torch.utils import ArgsParser
    monkeypatch.chdir(world)
    monkeypatch.setattr(tbuild, "BATCH_BYTES", BATCH_BYTES)
    args = ArgsParser(["build", name] + files + ["-taxonomy", "tax"]
                      + flags)
    shards = args.get("num-shards", 1, int)
    dbs = tbuild.build_shards_on_card(
        files, get_build_options(args), torch.device("cpu"), shards,
        shard_ids=shard_ids, store_triples=store_triples)
    for db in dbs:
        db.save(name)
    return dbs


CASES = [
    pytest.param(["a.fa", "rep.fa"], [], None, None, id="1-shard"),
    pytest.param(["a.fa", "rep.fa", "c.fa"], ["-num-shards", "3"], None,
                 None, id="3-shards"),
    pytest.param(["a.fa", "rep.fa", "c.fa"], ["-num-shards", "3"], [1],
                 None, id="rank-owns-shard-1-of-3"),
    pytest.param(["a.fa", "rep.fa", "c.fa"], ["-num-shards", "3",
                                              "-max-locations-per-feature",
                                              "3"], [0, 2], None,
                 id="cap-3-shards-0-2"),
    pytest.param(["a.fa", "rep.fa"], [], None, 2500, id="1-shard-spilled"),
    pytest.param(["a.fa", "rep.fa", "c.fa"], ["-num-shards", "3"], None,
                 900, id="3-shards-spilled"),
    pytest.param(["a.fa", "dup.fa", "c.fa"], ["-num-shards", "2"], None,
                 None, id="window-batcher-file"),
    pytest.param(["a.fa", "dup.fa", "c.fa"], ["-num-shards", "2"], None,
                 400, id="window-batcher-file-spilled"),
]


@pytest.mark.parametrize("files,flags,shard_ids,budget", CASES)
def test_card_build_equals_jax(world, monkeypatch, files, flags, shard_ids,
                               budget):
    from metacache_tpu_torch.db import device_store
    spilled = []
    merge = device_store.DeviceTripleStore.merge_spilled
    monkeypatch.setattr(device_store.DeviceTripleStore, "merge_spilled",
                        lambda self, cap: (spilled.append(len(self.chunks)),
                                           merge(self, cap))[1])
    jname, _ = _jax_build(world, files, flags)
    tname = "t" + jname + ("" if shard_ids is None else
                           "r" + "".join(map(str, shard_ids))) \
        + ("" if budget is None else f"b{budget}")
    dbs = _card_build(world, monkeypatch, files, flags, tname, shard_ids,
                      budget)
    for db in dbs:
        want = _npz(os.path.join(world, f"{jname}_{db.shard_id}.npz"))
        got = _npz(os.path.join(world, f"{tname}_{db.shard_id}.npz"))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    built = [db.shard_id for db in dbs]
    assert built == (shard_ids or sorted(built))
    if budget is None:
        assert spilled == []
    else:   # every store spilled several chunks, its remainder the last
        assert len(spilled) == len(dbs) and min(spilled) >= 3
    keys = np.concatenate([db.features.keys for db in dbs])
    assert keys.max() >= 2**31 > keys.min()     # u32 above int32's range
    if flags == [] and "rep.fa" in files:
        assert dbs[0].features.bucket_sizes().max() == 254
    if "dup.fa" in files:   # its empty record and repeated id skipped
        assert dbs[0].target_count == 8 + 2 + 3


@pytest.mark.parametrize("budget", [None, 700], ids=["unspilled",
                                                     "spilled-mid-file"])
def test_malformed_file_after_good_one(world, monkeypatch, capsys, budget):
    """a.fa, bad.fq (two good records, then a broken one), c.fa in 2
    shards: bad.fq is reported and leaves nothing (not its good records'
    triples, not a chunk file written while it streamed), as in the JAX
    CLI's build."""
    from metacache_tpu_torch.db import device_store
    files, flags = ["a.fa", "bad.fq", "c.fa"], ["-num-shards", "2"]
    jname, want_fails = _jax_build(world, files, flags)
    assert want_fails == ["FAIL: bad.fq: malformed fastq file - quality "
                          "header: "]
    dropped = []       # the chunk files each rollback deleted
    rollback = device_store.DeviceTripleStore.rollback

    def spy(self):
        dropped.append([p for p, _ in self.chunks[self._mark[1]:]])
        rollback(self)

    monkeypatch.setattr(device_store.DeviceTripleStore, "rollback", spy)
    capsys.readouterr()
    tname = "tbad" + ("" if budget is None else f"b{budget}")
    _card_build(world, monkeypatch, files, flags, tname,
                store_triples=budget)
    fails = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("FAIL: ")]
    assert fails == want_fails
    _assert_shards_equal(world, jname, tname, 2)
    assert len(dropped) == 2       # each shard's store rolled back
    if budget is not None:         # bad.fq's chunks were written, then gone
        assert any(dropped) and all(not os.path.exists(p)
                                    for d in dropped for p in d)
    assert _npz(os.path.join(world, f"{tname}_0.npz"))[
        "target_taxon_node"].shape == (11,)


def test_store_sorts_u32_features_on_either_side_of_2_31():
    """A store's table (built on its device, and spilled into chunks
    merged natively) equals the host table of the same triples: features
    around 2^31 and at the top of u32 sort as u32, each feature's
    locations in insertion order, cut at the cap."""
    from metacache_tpu_torch.db.device_store import (DeviceTripleStore,
                                                     Staging)
    from metacache_tpu_torch.db.feature_table import FeatureTable
    import tempfile
    rng = np.random.default_rng(5)
    pool = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2,
                     2**32 - 1, 12345], np.uint64).astype(np.uint32)
    f = pool[rng.integers(0, len(pool), 5000)]
    t = np.repeat(np.arange(50, dtype=np.int32), 100)
    w = np.tile(np.arange(100, dtype=np.int32), 50)
    want = FeatureTable.from_triples(f.copy(), t.copy(), w.copy(), 254)
    for budget in (10**6, 250):
        with tempfile.TemporaryDirectory() as d:
            st = DeviceTripleStore(0, torch.device("cpu"), budget,
                                   lambda: d, Staging(torch.device("cpu")))
            for o in range(0, 5000, 300):
                st.add(f[o:o + 300], t[o:o + 300], w[o:o + 300])
            got = st.finalize(254)
            if got is None:
                assert len(st.chunks) >= 10
                got = st.merge_spilled(254)
            for name in ("keys", "offsets", "loc_tgt", "loc_win"):
                a, b = getattr(got, name), getattr(want, name)
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
    assert want.keys[-1] == 2**32 - 1 and want.bucket_sizes().max() == 254


def test_window_sketch_plain_equals_jax_sketch():
    """The window sketch's plain version on whole records (ambiguous
    bytes, lower case, tail windows, records shorter than a window and
    than k) equals the JAX package's sketch_windows of the same windows
    cut out on the host."""
    import jax.numpy as jnp
    from metacache_tpu.ops.sketch import sketch_windows as jax_sketch
    from metacache_tpu_torch.db.build import _num_windows
    from metacache_tpu_torch.ops import encode, sketch_cuda
    rng = np.random.default_rng(9)
    alphabet = np.frombuffer(b"ACGTacgtNRY", np.uint8)
    lens = np.array([700, 5, 128, 129, 241, 90, 1000], np.int64)
    recs = [alphabet[rng.choice(11, n, p=[.2] * 4 + [.02] * 4 + [.04] * 3)]
            for n in lens]
    seq = np.concatenate(recs)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    nwin = _num_windows(lens, W, STRIDE)
    win_off = np.concatenate([[0], np.cumsum(nwin)])
    for k, s in ((16, 16), (9, 40)):
        got = sketch_cuda.sketch_windows(
            torch.from_numpy(seq), torch.from_numpy(off),
            torch.from_numpy(lens), torch.from_numpy(win_off),
            n_windows=int(win_off[-1]), k=k, sketch_size=s, window_size=W,
            stride=STRIDE).numpy()
        codes = np.full((int(win_off[-1]), W), 255, np.uint8)
        wlen = np.zeros(len(codes), np.int32)
        row = 0
        for rec in recs:
            for st in encode.window_starts(len(rec), W, STRIDE):
                part = rec[st:st + W]
                codes[row, :len(part)] = encode.np_encode_bytes(part)
                wlen[row] = len(part)
                row += 1
        want = np.asarray(jax_sketch(jnp.asarray(codes), jnp.asarray(wlen),
                                     k, s))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.astype(np.uint32))
    assert (got == -1).all(axis=1).any()      # the record shorter than k


def test_record_stream_batches_whole_records(tmp_path):
    """Records never split across batches; a record longer than the buffer
    asks for a larger one; bad content and missing files raise as the
    native passes do."""
    from metacache_tpu_torch import native
    from metacache_tpu_torch.io import sequence_io
    (tmp_path / "g.fa").write_text(">a one\nACGT\nNNac\n>b\n\n>c\nGGG\n")
    stream = native.RecordStream(str(tmp_path / "g.fa"))
    buf = np.zeros(6, np.uint8)
    got = []
    while True:
        try:
            batch = stream.next_batch(buf)
        except native.RecordTooLarge as e:
            assert e.need == 8
            buf = np.zeros(e.need, np.uint8)
            continue
        if batch is None:
            break
        got.append((batch.headers, batch.lens.tolist(),
                    buf[:batch.nbytes].tobytes()))
    assert got == [(["a one", "b"], [8, 0], b"ACGTNNac"),
                   (["c"], [3], b"GGG")]
    (tmp_path / "x.txt").write_text("no sequence\n")
    (tmp_path / "b.fq").write_text("@r\nAC\n+\nII\n@s\nAC\n")
    with pytest.raises(sequence_io.FormatError, match="not recognized"):
        native.RecordStream(str(tmp_path / "x.txt"))
    stream = native.RecordStream(str(tmp_path / "b.fq"))
    with pytest.raises(sequence_io.FormatError, match="quality header"):
        stream.next_batch(np.zeros(100, np.uint8))
    with pytest.raises(OSError, match="can't read file"):
        native.RecordStream(str(tmp_path / "none.fa"))


def test_device_cuda_raises_without_a_card(world, monkeypatch):
    """build -device cuda (the default) takes the card path and raises
    where there is no card; nothing falls back to the host path."""
    from metacache_tpu_torch.db import build as tbuild
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(world)
    with pytest.raises(RuntimeError, match="-device cuda"):
        tbuild.build_database_shards(["a.fa"], tbuild.BuildOptions())
