"""The CUDA kernels (metacache_tpu_torch/csrc/sketch.cu: the read and the
reference-window sketch, csrc/gather.cu, csrc/merge.cu) against their
plain PyTorch versions on the card, the build's card path against its
native host path (every array of every shard equal), and the engine on
the card (with and without clade exclusion and window hit
counts, fused over two shards merged on the card) against the engine on
the CPU. Needs a CUDA card and nvcc; skips without a card.
Tolerance: bit equality.

On the card's machine (which has no JAX, hence no conftest):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from metacache_tpu_torch.ops import encode, gather_cuda, sketch_cuda
from metacache_tpu_torch.ops.gather import gather_rows_reference
from metacache_tpu_torch.ops.sketch import sketch_packed_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def reads(seed, B, L, ambig_rate=0.02):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < ambig_rate] = 255
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:4] = [0, 3, 15, 16][:min(4, B)]
    codes[np.arange(L)[None, :] >= lens[:, None]] = 255
    p, a = encode.np_pack_codes(codes)
    return p, a, lens


def random_shards(rng, P, n_keys, max_bucket=8, pairs=64):
    """P random CSR shard tables: keys from a space of 2 n_keys (many
    shared), the last shard's from its upper half only (so it has no key
    in the lower chunks), and one at the top u32 value; buckets of
    1..max_bucket (target, window) pairs from a space of `pairs` shared by
    the shards (equal triples: the tie rule), sorted within each bucket."""
    from metacache_tpu_torch.db.feature_table import FeatureTable
    out = []
    for s in range(P):
        lo = n_keys if s == P - 1 else 0
        keys = np.unique(rng.integers(lo, 2 * n_keys, n_keys)).astype(
            np.uint32)
        keys[-1] = 0xFFFFFFFF
        sizes = rng.integers(1, max_bucket + 1, len(keys))
        offsets = np.zeros(len(keys) + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        pair = rng.integers(0, pairs, int(offsets[-1]))
        pair = pair[np.lexsort((pair, np.repeat(np.arange(len(keys)),
                                                sizes)))]
        out.append(FeatureTable(keys=keys, offsets=offsets,
                                loc_tgt=(pair // 8).astype(np.int32),
                                loc_win=(pair % 8).astype(np.int32)))
    return out


def giant_bucket_shards(rng, P, n_keys, giant):
    """random_shards' tables, plus one key that every shard holds with a
    bucket of `giant` locations (wider than a merge tile of the kernel,
    2048, where giant is larger), its pairs drawn from a space of 64 (so
    triples tie across shards)."""
    from metacache_tpu_torch.db.feature_table import FeatureTable
    out = []
    for t in random_shards(rng, P, n_keys):
        key = np.uint32(2 * n_keys + 7)     # above every random key but
        at = len(t.keys) - 1                # the top one
        pair = np.sort(rng.integers(0, 64, giant))
        sizes = np.diff(t.offsets)
        out.append(FeatureTable(
            keys=np.insert(t.keys, at, key),
            offsets=np.concatenate([[0], np.cumsum(np.insert(sizes, at,
                                                             giant))]),
            loc_tgt=np.insert(t.loc_tgt, t.offsets[at],
                              (pair // 8).astype(np.int32)),
            loc_win=np.insert(t.loc_win, t.offsets[at],
                              (pair % 8).astype(np.int32))))
    return out


def tied_shards(rng, P, n_keys):
    """P copies of one random table: every (key, target, window) triple
    is in every shard, so the whole merge is ties."""
    return random_shards(rng, 1, n_keys) * P


def low_complexity_records(seed):
    """Whole ASCII records whose windows hold few distinct or few valid
    k-mers: a poly-A run, a dinucleotide repeat, a period-7 repeat, an
    N run, a period-20 repeat with an N in each period (4 valid k-mers
    of 16 per period, all equal across periods), lower case, and random
    bases with those runs spliced in. No record's window count is a
    multiple of 128 (a span block's windows), nor is the total ->
    (seq, rec_off, rec_len) host arrays."""
    rng = np.random.default_rng(seed)
    units = [b"A", b"AC", b"ACGTTGA", b"N", b"ACGTTGCAACGTTGCAAGTN",
             b"acacacgt"]
    lens = [1007, 300, 129, 17, 5000, 2500, 700, 113 * 5 + 15, 3, 16,
            128 * 113 + 55]
    recs = []
    for i, n in enumerate(lens):
        unit = units[i % len(units)]
        r = np.frombuffer((unit * (n // len(unit) + 1))[:n], np.uint8)
        if i >= len(units):
            r = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
            for u in units:
                at = int(rng.integers(0, n))
                run = np.frombuffer(u * 40, np.uint8)[:n - at]
                r[at:at + len(run)] = run
        recs.append(r.copy())
    lens = np.asarray(lens, np.int64)
    off = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    return np.concatenate(recs), off, lens


@pytest.mark.parametrize("B,L", [(1, 64), (37, 104), (1007, 256),
                                 (4096, 320)])
@pytest.mark.parametrize("k", [1, 7, 12, 16])
@pytest.mark.parametrize("s", [1, 16, 64])
def test_kernel_matches_plain(dev, B, L, k, s):
    p, a, lens = reads(B * k + s, B, L)
    starts = tuple(int(x) for x in encode.window_starts(L, 128, 113))
    args = [torch.from_numpy(x).to(dev) for x in (p, a, lens)]
    kw = dict(k=k, sketch_size=s, window_size=128, starts=starts)
    before = sketch_cuda.launches
    got = sketch_cuda.sketch_packed(*args, **kw)
    torch.cuda.synchronize()
    assert sketch_cuda.launches == before + 1
    want = sketch_packed_reference(*args, **kw)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("s", [65, 80, 256])
def test_kernel_matches_plain_large_sketch(dev, s):
    """Sketch sizes over 64 (the build's WindowBatcher path) run the
    kernel's instantiation with 8 sketch registers per lane."""
    p, a, lens = reads(s, 512, 128)
    args = [torch.from_numpy(x).to(dev) for x in (p, a, lens)]
    kw = dict(k=16, sketch_size=s, window_size=128, starts=(0,))
    got = sketch_cuda.sketch_packed(*args, **kw)
    assert torch.equal(got, sketch_packed_reference(*args, **kw))
    with pytest.raises(ValueError):
        sketch_cuda.sketch_packed(*args, k=16, sketch_size=257,
                                  window_size=128, starts=(0,))


def ascii_records(seed, lens):
    """Whole records of ASCII bases (upper and lower case, runs of N, IUPAC
    codes) packed one after another, as the record stream reads them ->
    (seq, rec_off, rec_len) host arrays."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTacgtNRYKM", np.uint8)
    p = np.array([.2] * 4 + [.03] * 4 + [.02] * 4 + [.0], np.float64)
    p[-1] = 1 - p.sum()
    recs = []
    for n in lens:
        r = alphabet[rng.choice(len(alphabet), n, p=p)]
        if n > 300:
            r[rng.integers(0, n - 40):][:40] = ord("N")
        recs.append(r)
    lens = np.asarray(lens, np.int64)
    off = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    return np.concatenate(recs), off, lens


@pytest.mark.parametrize("k,s,W,stride", [
    (16, 16, 128, 113), (16, 64, 128, 113), (9, 40, 128, 113),
    (1, 4, 128, 113), (16, 100, 300, 200), (12, 8, 40, 7),
    (16, 256, 1000, 900)])
def test_window_kernel_matches_plain(dev, k, s, W, stride):
    """The build's window sketch on the card equals its plain version bit
    for bit: records shorter than k and than a window, tail windows,
    windows longer than a staged chunk, ambiguous bases anywhere."""
    from metacache_tpu_torch.db.build import _num_windows
    from metacache_tpu_torch.ops.sketch import sketch_windows_reference
    rng = np.random.default_rng(k * 1000 + s)
    lens = np.concatenate([[5, 15, 16, 17, 90, 128, 129, W, W + 1],
                           rng.integers(1, 5000, 40)])
    seq, off, rlen = ascii_records(k + s, lens)
    nwin = _num_windows(rlen, W, stride)
    win_off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(nwin, out=win_off[1:])
    args = [torch.from_numpy(x).to(dev) for x in (seq, off, rlen, win_off)]
    kw = dict(n_windows=int(win_off[-1]), k=k, sketch_size=s, window_size=W,
              stride=stride)
    before = sketch_cuda.window_launches
    got = sketch_cuda.sketch_windows(*args, **kw)
    torch.cuda.synchronize()
    assert sketch_cuda.window_launches == before + 1
    want = sketch_windows_reference(*args, **kw)
    assert got.dtype == torch.int32 and got.shape == (int(win_off[-1]), s)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        sketch_cuda.sketch_windows(args[0], args[1].int(), *args[2:], **kw)


@pytest.mark.parametrize("k,s,W,stride", [
    (16, 16, 128, 113), (16, 64, 128, 113), (7, 20, 128, 113),
    (4, 8, 128, 113), (16, 16, 40, 7), (16, 100, 128, 113)])
def test_window_kernel_low_complexity(dev, k, s, W, stride):
    """The window kernel equals its plain version bit for bit where a
    window's sketch is short of s values: poly-A (one distinct k-mer),
    repeats of period 2, 7 and 20, N runs, few valid k-mers, in block
    counts that leave the last span block part-filled."""
    from metacache_tpu_torch.db.build import _num_windows
    from metacache_tpu_torch.ops.sketch import sketch_windows_reference
    seq, off, rlen = low_complexity_records(k * 100 + s)
    nwin = _num_windows(rlen, W, stride)
    assert (nwin % 128 != 0).all() and nwin.sum() % 128 != 0
    win_off = np.zeros(len(rlen) + 1, np.int64)
    np.cumsum(nwin, out=win_off[1:])
    args = [torch.from_numpy(x).to(dev) for x in (seq, off, rlen, win_off)]
    kw = dict(n_windows=int(win_off[-1]), k=k, sketch_size=s, window_size=W,
              stride=stride)
    got = sketch_cuda.sketch_windows(*args, **kw)
    want = sketch_windows_reference(*args, **kw)
    assert torch.equal(got, want)
    filled = (want != -1).sum(dim=1)
    assert (filled == 0).any() and (filled == 1).any()   # N run, poly-A
    assert ((filled > 1) & (filled < s)).any()


def card_world(tmp_path):
    """Twelve genomes (two groups of strains, N runs, lower case) in two
    files, and the same database's build options."""
    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    bases = [rng.integers(0, 4, 6000) for _ in range(2)]
    files = []
    for f in range(2):
        recs = []
        for i in range(6):
            g = bases[i % 2].copy()
            m = rng.random(len(g)) < 0.02
            g[m] = rng.integers(0, 4, int(m.sum()))
            txt = acgt[g[:6000 - 77 * i]].tobytes().decode()
            txt = txt[:500] + "N" * 30 + txt[530:900].lower() + txt[900:]
            recs.append(f">NC_{10 * f + i:06d}.1 g\n{txt}\n")
        path = tmp_path / f"g{f}.fa"
        path.write_text("".join(recs))
        files.append(str(path))
    return files


@pytest.mark.parametrize("shards,budget", [(1, None), (2, None), (2, 3000)],
                         ids=["1-shard", "2-shards", "2-shards-spilled"])
def test_card_build_equals_host_build(dev, tmp_path, shards, budget):
    """build on the card (record stream, window kernel, device stores
    sorted on the card; spilled into chunks with a small budget) gives
    the native host path's shards, every array equal."""
    from metacache_tpu_torch.db import build as tbuild
    files = card_world(tmp_path)
    host = tbuild.build_database_shards(
        files, tbuild.BuildOptions(device="cpu"), num_shards=shards)
    before = sketch_cuda.window_launches
    if budget is None:
        card = tbuild.build_database_shards(
            files, tbuild.BuildOptions(device="cuda"), num_shards=shards)
    else:
        card = tbuild.build_shards_on_card(
            files, tbuild.BuildOptions(device="cuda"), dev, shards,
            store_triples=budget)
    assert sketch_cuda.window_launches > before
    for h, c in zip(host, card):
        h.save(str(tmp_path / "host"))
        c.save(str(tmp_path / "card"))
    for s in range(shards):
        with np.load(tmp_path / f"host_{s}.npz", allow_pickle=True) as a, \
                np.load(tmp_path / f"card_{s}.npz", allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _ambiguous_at(a, rows, positions):
    for r in rows:
        for pos in positions:
            if pos >> 3 < a.shape[1]:
                a[r, pos >> 3] |= np.uint8(1 << (pos & 7))


@pytest.mark.parametrize("L,W,stride,k,s,B", [
    (1024, 1000, 1000, 16, 16, 64),     # a window of several chunks
    (1024, 300, 200, 16, 16, 64),       # windows past one warp pass, n_win 5
    (256, 40, 7, 9, 8, 33),             # short windows, n_win 31
    (64, 128, 113, 16, 100, 64),        # s above the k-mer count
    (320, 128, 113, 1, 4, 64),          # k 1
    (320, 128, 113, 16, 256, 64),       # k 16, the largest sketch
    (104, 128, 113, 16, 16, 1),         # one read
], ids=["several-chunks", "n_win-5", "n_win-31", "s-over-kmers", "k1",
        "k16-s256", "B1"])
def test_kernel_edges(dev, L, W, stride, k, s, B):
    """Edges of the warp-per-window design: windows longer than a warp
    pass or a staged chunk, several windows per read, fewer k-mers than
    s, k 1 and 16, one read, and ambiguous bases at the 32-character
    lane boundaries and the 128-character chunk boundaries."""
    p, a, lens = reads(L + W + k + s + B, B, L, ambig_rate=0.005)
    lens[B // 2:] = L
    _ambiguous_at(a, range(B // 2, B, 2),
                  (15, 31, 32, 63, 64, 127, 128, 129, 255, 256, 511, 512))
    starts = tuple(int(x) for x in encode.window_starts(L, W, stride))
    args = [torch.from_numpy(x).to(dev) for x in (p, a, lens)]
    kw = dict(k=k, sketch_size=s, window_size=W, starts=starts)
    got = sketch_cuda.sketch_packed(*args, **kw)
    want = sketch_packed_reference(*args, **kw)
    assert got.shape == (B, len(starts) * s)
    assert torch.equal(got, want)


def gather_case(dev, seed, B, L, N, dtype, full=False):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    table = rng.integers(info.min, info.max, N, dtype=dtype)
    idx = rng.integers(0, N, (B, L))
    n_valid = np.full(B, L) if full else rng.integers(0, L + 1, B)
    if not full and B > 2:
        n_valid[:2] = [0, L]
        idx[np.arange(L)[None, :] >= n_valid[:, None]] = -5   # never read
    return [torch.from_numpy(x).to(dev) for x in (table, idx, n_valid)]


@pytest.mark.parametrize("B,L,N,dtype,full", [
    (2048, 128, 1 << 20, np.int32, True),       # the probe k1's shapes
    (1007, 256, 1 << 16, np.int64, False),
    (1, 1, 1, np.int64, True),                  # a one-word table
    (64, 7, 1, np.int32, False),
    (5, 256, 100, np.int64, False)])
def test_gather_kernel_matches_plain(dev, B, L, N, dtype, full):
    table, idx, n_valid = gather_case(dev, B + L, B, L, N, dtype, full)
    pad = int(np.iinfo(dtype).max)
    before = gather_cuda.launches
    got = gather_cuda.gather_rows(table, idx, n_valid, pad)
    torch.cuda.synchronize()
    assert gather_cuda.launches == before + 1
    want = gather_rows_reference(table, idx, n_valid, pad)
    assert got.dtype == table.dtype and torch.equal(got, want)


@pytest.mark.parametrize("L,dtype", [(257, np.int64), (130, np.int32),
                                     (3, np.int64), (5, np.int32),
                                     (256, np.int64), (128, np.int32)])
def test_gather_kernel_row_edges(dev, L, dtype):
    """Row lengths that are and are not a multiple of the 16-byte vector,
    short rows (several rows per warp), and in each case empty rows, full
    rows and rows whose valid prefix ends inside a vector."""
    B = 97
    table, idx, n_valid = gather_case(dev, L, B, L, 5000, dtype)
    n_valid[2:12] = 0
    n_valid[12:22] = L
    n_valid[22:32] = torch.arange(1, 11, device=dev).clamp(max=L)
    n_valid[32] = L + 5          # past the row: every slot valid
    n_valid[33] = -3             # below zero: none
    past = torch.arange(L, device=dev)[None, :] >= n_valid[:, None]
    idx = torch.where(past, -5, idx.clamp(min=0))     # never read
    pad = -123
    got = gather_cuda.gather_rows(table, idx, n_valid, pad)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_rows_reference(table, idx, n_valid, pad))


def test_gather_kernel_rows_with_nothing_valid(dev):
    table, idx, n_valid = gather_case(dev, 3, 300, 64, 1000, np.int64)
    n_valid.zero_()
    got = gather_cuda.gather_rows(table, idx, n_valid, -7)
    assert (got == -7).all()


def test_gather_kernel_rejects_bad_inputs(dev):
    table, idx, n_valid = gather_case(dev, 4, 16, 8, 100, np.int64)
    with pytest.raises(ValueError):
        gather_cuda.gather_rows(table.float(), idx, n_valid, 0)
    with pytest.raises(ValueError):
        gather_cuda.gather_rows(table, idx.int(), n_valid, 0)
    with pytest.raises(ValueError):
        gather_cuda.gather_rows(table, idx[:, ::2], n_valid, 0)
    with pytest.raises(ValueError):
        gather_cuda.gather_rows(table, idx, n_valid[:-1], 0)
    with pytest.raises(ValueError):
        gather_cuda.gather_rows(table.int(), idx, n_valid, 2**40)
    with pytest.raises(ValueError):
        gather_cuda.gather_rows(table, idx.cpu(), n_valid, 0)


def test_kernel_all_ambiguous_and_empty(dev):
    B, L = 64, 128
    p, a, lens = reads(1, B, L)
    a[:32] = 255
    lens[32:] = 0
    args = [torch.from_numpy(x).to(dev) for x in (p, a, lens)]
    got = sketch_cuda.sketch_packed(*args, k=16, sketch_size=16,
                                    window_size=128, starts=(0,))
    assert (got == 0xFFFFFFFF).all()


def test_kernel_rejects_bad_inputs(dev):
    p, a, lens = (torch.from_numpy(x).to(dev) for x in reads(2, 8, 64))
    kw = dict(k=16, sketch_size=16, window_size=128, starts=(0,))
    with pytest.raises(ValueError):
        sketch_cuda.sketch_packed(p, a, lens.long(), **kw)
    with pytest.raises(ValueError):
        sketch_cuda.sketch_packed(p[:, ::2], a, lens, **kw)
    with pytest.raises(ValueError):
        sketch_cuda.sketch_packed(p, a, lens, k=17, sketch_size=16,
                                  window_size=128, starts=(0,))


def engine_world(tmp_path, num_shards):
    """Six genomes (0 and 3 are strains: shared features) built into
    num_shards shards, and 200 read pairs in [256, 128] host buffers."""
    from metacache_tpu_torch.db.build import (BuildOptions,
                                              build_database_shards)

    def encode_read_into(codes, lens, row, seq, max_len):
        c = encode.np_encode_bytes(np.frombuffer(seq.encode(), np.uint8))
        codes[row, :len(c)] = c
        codes[row, len(c):] = 255
        lens[row] = len(c)
    rng = np.random.default_rng(4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.integers(0, 4, 5000)
    genomes = []
    for i in range(6):      # genomes 0 and 3 are strains: shared features
        g = base.copy() if i % 3 == 0 else rng.integers(0, 4, 5000)
        g[rng.random(5000) < 0.02] = rng.integers(0, 4)
        genomes.append(acgt[g].tobytes().decode())
    fasta = tmp_path / "genomes.fa"
    fasta.write_text("".join(f">NC_{i:06d}.1 g\n{g}\n"
                             for i, g in enumerate(genomes)))
    dbs = build_database_shards([str(fasta)], BuildOptions(),
                                num_shards=num_shards)
    c1, l1, c2, l2 = (np.zeros((256, 128), np.uint8), np.zeros(256, np.int32),
                      np.full((256, 128), 255, np.uint8),
                      np.zeros(256, np.int32))
    for i in range(200):
        g = genomes[int(rng.integers(0, 6))]
        p = int(rng.integers(0, len(g) - 300))
        encode_read_into(c1, l1, i, g[p:p + 100], 128)
        encode_read_into(c2, l2, i, g[p + 180:p + 280], 128)
    return dbs, (c1, l1, c2, l2), rng


FIELDS = ["best", "best_rank", "match_total", "match_overflow", "cand_tax",
          "cand_hits", "cand_beg", "cand_end", "cand_tgt"]


@pytest.mark.parametrize("options", [False, True],
                         ids=["plain", "exclusion-window-hits"])
def test_engine_cuda_matches_cpu(dev, tmp_path, options):
    from metacache_tpu_torch.config import ClassifyParams, QueryPipelineParams
    from metacache_tpu_torch.db.taxonomy import Rank
    from metacache_tpu_torch.query.engine import QueryEngine

    (db,), (c1, l1, c2, l2), rng = engine_world(tmp_path, 1)
    pipeline = QueryPipelineParams(batch_size=256, max_query_len=128,
                                   max_locations_per_query=64)
    classify = ClassifyParams(max_candidates=3)
    groups = None
    if options:
        groups = np.zeros(256, np.int64)
        groups[:200] = db.target_taxon_node[rng.integers(0, 6, 200)]
    res = []
    for d in (dev, torch.device("cpu")):
        eng = QueryEngine(db, classify, pipeline, device=d,
                          target_window_k=16 if options else 0)
        if options:     # the sequence rank: each read excludes one genome
            eng.set_exclusion(Rank.SEQUENCE)
        res.append(eng.classify_batch(c1, l1, c2, l2, 200,
                                      exclude_groups=groups))
    for f in FIELDS + (["target_window_hits"] if options else []):
        np.testing.assert_array_equal(getattr(res[0], f), getattr(res[1], f),
                                      err_msg=f)
    assert os.path.exists(sketch_cuda.LIBRARY.path())
    assert os.path.exists(gather_cuda.LIBRARY.path())


def test_engine_defaults_to_the_card(dev, tmp_path):
    """QueryEngine without a device puts its tables on the card and gives
    the results of the same engine on the CPU."""
    from metacache_tpu_torch.config import ClassifyParams, QueryPipelineParams
    from metacache_tpu_torch.query.engine import QueryEngine

    (db,), (c1, l1, c2, l2), _ = engine_world(tmp_path, 1)
    pipeline = QueryPipelineParams(batch_size=256, max_query_len=128,
                                   max_locations_per_query=64)
    classify = ClassifyParams(max_candidates=3)
    eng = QueryEngine(db, classify, pipeline)
    assert eng.device.type == "cuda"
    assert all(t.is_cuda for t in eng.tables.values())
    cpu = QueryEngine(db, classify, pipeline, device=torch.device("cpu"))
    got, want = (e.classify_batch(c1, l1, c2, l2, 200) for e in (eng, cpu))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_sharded_engine_cuda_matches_cpu(dev, tmp_path):
    """Two shards on one card (the one-card -mesh placement), with window
    hit counts, against the same two shards on the CPU; both kernels
    launch once per batch on the card (one sketch per device)."""
    from metacache_tpu_torch.config import ClassifyParams, QueryPipelineParams
    from metacache_tpu_torch.parallel import ShardedQueryEngine

    dbs, inputs, _ = engine_world(tmp_path, 2)
    pipeline = QueryPipelineParams(batch_size=256, max_query_len=128,
                                   max_locations_per_query=64)
    classify = ClassifyParams(max_candidates=3)
    res = []
    for d in (dev, torch.device("cpu")):
        eng = ShardedQueryEngine(dbs, classify, pipeline, [d, d],
                                 target_window_k=16)
        sk, ga = sketch_cuda.launches, gather_cuda.launches
        res.append(eng.classify_batch(*inputs, 200))
        if d.type == "cuda":
            assert sketch_cuda.launches - sk == 2     # both mates, once
            assert gather_cuda.launches - ga == 2     # once per shard
    for f in FIELDS + ["target_window_hits"]:
        np.testing.assert_array_equal(getattr(res[0], f), getattr(res[1], f),
                                      err_msg=f)
    assert (res[0].match_total[:200] > 0).sum() > 150


@pytest.mark.parametrize("P,n_keys,cap", [(2, 3000, 1 << 24),
                                          (3, 20000, 5000),
                                          (4, 100000, 1 << 16),
                                          (2, 2_000_000, 1 << 24)])
def test_merge_kernels_match_plain(dev, monkeypatch, P, n_keys, cap):
    """The merge and count kernels bit for bit against their plain
    versions on every planned chunk of random shard tables (shared keys,
    equal triples in several shards), then the whole streamed merge on
    the card against the same on the CPU, in chunks of `cap` locations."""
    from metacache_tpu_torch.ops import merge_cuda
    from metacache_tpu_torch.ops.merge import (count_keys_reference,
                                               merge_chunk_reference)
    from metacache_tpu_torch.query import upload
    monkeypatch.setattr(upload, "CHUNK", cap)
    tables = random_shards(np.random.default_rng(P * n_keys), P, n_keys)
    plan = upload.plan_chunks(tables, cap)
    for begin, end in plan:
        with upload.Stager(dev) as stager:
            c = upload._Chunk(stager, tables, begin, end, locations=True)
            stager.ready()
        loc = torch.empty(c.nl, dtype=torch.int64, device=dev)
        before = merge_cuda.merge_launches, merge_cuda.count_launches
        key = merge_cuda.merge_chunk(c.keys, c.offs, c.tgt, c.win, c.bounds,
                                     loc)
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        merge_cuda.count_keys(c.keys, c.bounds, count)
        torch.cuda.synchronize()
        assert (merge_cuda.merge_launches, merge_cuda.count_launches) == \
            (before[0] + 1, before[1] + 1)
        want_loc, want_key = merge_chunk_reference(c.keys, c.offs, c.tgt,
                                                   c.win, c.bounds)
        assert torch.equal(loc, want_loc) and torch.equal(key, want_key)
        assert int(count) == count_keys_reference(c.keys)
    with upload.Stager(dev) as stager:
        got = upload.merged_feature_tables(stager, tables)
    want = upload.merged_feature_tables(upload.Stager(torch.device("cpu")),
                                        tables)
    for name, w in want.items():
        assert torch.equal(got[name].cpu(), w), name


@pytest.mark.parametrize("case", ["giant_bucket", "all_ties",
                                  "empty_shard", "P3", "P4"])
def test_merge_kernel_edges(dev, case):
    """The merge and count kernels bit for bit against their plain
    versions on one chunk: a bucket wider than a merge tile in every
    shard, a chunk of nothing but ties, a shard with no keys in the chunk,
    3 and 4 shards (two merge rounds); then the streamed merge of the same
    tables on the card against the CPU's."""
    from metacache_tpu_torch.db.feature_table import FeatureTable
    from metacache_tpu_torch.ops import merge_cuda
    from metacache_tpu_torch.ops.merge import (count_keys_reference,
                                               merge_chunk_reference)
    from metacache_tpu_torch.query import upload
    rng = np.random.default_rng(len(case))
    if case == "giant_bucket":
        tables = giant_bucket_shards(rng, 2, 3000, 5000)
    elif case == "all_ties":
        tables = tied_shards(rng, 2, 4000)
    elif case == "empty_shard":
        tables = random_shards(rng, 3, 3000)
        tables[1] = FeatureTable(keys=np.zeros(0, np.uint32),
                                 offsets=np.zeros(1, np.int64),
                                 loc_tgt=np.zeros(0, np.int32),
                                 loc_win=np.zeros(0, np.int32))
    else:
        tables = giant_bucket_shards(rng, int(case[1]), 2000, 2100)
    (begin, end), = upload.plan_chunks(tables, 1 << 24)
    with upload.Stager(dev) as stager:
        c = upload._Chunk(stager, tables, begin, end, locations=True)
        stager.ready()
    loc = torch.empty(c.nl, dtype=torch.int64, device=dev)
    key = merge_cuda.merge_chunk(c.keys, c.offs, c.tgt, c.win, c.bounds, loc)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    merge_cuda.count_keys(c.keys, c.bounds, count)
    want_loc, want_key = merge_chunk_reference(c.keys, c.offs, c.tgt, c.win,
                                               c.bounds)
    assert torch.equal(loc, want_loc) and torch.equal(key, want_key)
    assert int(count) == count_keys_reference(c.keys)
    with upload.Stager(dev) as stager:
        got = upload.merged_feature_tables(stager, tables)
    want = upload.merged_feature_tables(upload.Stager(torch.device("cpu")),
                                        tables)
    for name, w in want.items():
        assert torch.equal(got[name].cpu(), w), name


def count_case(rng, case):
    """Sorted unique u32 key arrays, one per shard, of a count-only case."""
    def draw(lo, hi, n):
        return np.unique(rng.integers(lo, hi, n, dtype=np.uint64)).astype(
            np.uint32)
    if case == "around_2_31":
        # every shard's keys straddle 2^31, interleaved with the others'
        space = np.arange((1 << 31) - 6000, (1 << 31) + 6000,
                          dtype=np.uint64)
        return [np.sort(rng.choice(space, 5000, replace=False)).astype(
            np.uint32) for _ in range(3)]
    if case == "inside_gap":
        # the higher shard's keys all lie between two of the lower's
        return [np.array([3, 0x7FFFFFFF, 0xFFFFFFFF], np.uint32),
                np.arange(0x80000000, 0x80000000 + 9000, 3, dtype=np.uint32)]
    if case == "dense_lower":
        # the lower shard 50x denser over the same range: a tile's range
        # there spans ~50 tiles' worth of keys (many pieces)
        lower = draw(0, 1 << 32, 400_000)
        higher = np.union1d(rng.choice(lower, 4000, replace=False),
                            draw(0, 1 << 32, 4000))
        return [lower, higher.astype(np.uint32)]
    if case == "one_key":
        return [np.zeros(0, np.uint32), np.array([0xFFFFFFFF], np.uint32)]
    # P = 5: shared keys, sizes that leave tiles straddling shards, an
    # empty shard between them
    space = draw(0, 1 << 32, 30_000)
    sets = [np.sort(rng.choice(space, n, replace=False))
            for n in (7_001, 2_500, 0, 12_345, 4_099)]
    return sets


@pytest.mark.parametrize("case", ["around_2_31", "inside_gap",
                                  "dense_lower", "one_key", "P5"])
def test_count_kernel_edges(dev, case):
    """The count kernel bit for bit against its plain version, one launch
    a call, on one chunk of keys: keys around 2^31 interleaved over 3
    shards (u32 order), a higher shard inside one gap of the lower, a
    lower shard 50x denser than the higher, a chunk of one key (shard 0
    empty), and 5 shards with an empty one."""
    from metacache_tpu_torch.ops import merge_cuda
    from metacache_tpu_torch.ops.merge import count_keys_reference
    sets = count_case(np.random.default_rng(len(case)), case)
    kbeg = np.concatenate([[0], np.cumsum([len(k) for k in sets])])
    keys = torch.from_numpy(np.concatenate(sets).view(np.int32)).to(dev)
    bounds = torch.from_numpy(np.stack([kbeg, kbeg])).to(dev)
    count = torch.full((1,), 5, dtype=torch.int64, device=dev)
    before = merge_cuda.count_launches
    merge_cuda.count_keys(keys, bounds, count)
    torch.cuda.synchronize()
    assert merge_cuda.count_launches == before + 1
    want = count_keys_reference(keys)
    assert want == len(np.unique(np.concatenate(sets)))
    assert int(count) == 5 + want


def test_fused_engine_merges_on_the_card(dev, tmp_path):
    """Two shards opened fused: the engine on the card merges them there
    (no host merge) into the tables of the host-merged database, and
    classifies as the engine on the CPU does."""
    from metacache_tpu_torch.config import ClassifyParams, QueryPipelineParams
    from metacache_tpu_torch.db.database import FusedDatabase
    from metacache_tpu_torch.ops import merge_cuda
    from metacache_tpu_torch.query.engine import (QueryEngine,
                                                  tables_from_database)

    dbs, inputs, _ = engine_world(tmp_path, 2)
    fused = FusedDatabase(dbs)
    pipeline = QueryPipelineParams(batch_size=256, max_query_len=128,
                                   max_locations_per_query=64)
    classify = ClassifyParams(max_candidates=3)
    n = merge_cuda.merge_launches
    eng = QueryEngine(fused, classify, pipeline, device=dev)
    assert merge_cuda.merge_launches > n and not fused.merged_on_host
    host = FusedDatabase(dbs)
    host.features          # merged on the host
    want = tables_from_database(host, torch.device("cpu"))
    for name in ("keys", "offsets", "locations"):
        assert torch.equal(eng.tables[name].cpu(), want[name]), name
    cpu = QueryEngine(fused, classify, pipeline, device=torch.device("cpu"))
    got, ref = (e.classify_batch(*inputs, 200) for e in (eng, cpu))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)


def _launch(args, cwd, ranks, timeout=300):
    """The port's CLI as `ranks` processes of one group (ranks 0 = a
    single process without MC_*); all are killed and the test fails past
    the time limit. -> [(stdout, stderr)] per process."""
    import socket
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(max(1, ranks)):
        env = dict(os.environ, PYTHONPATH=repo)
        if ranks:
            env.update(MC_COORDINATOR=f"127.0.0.1:{port}",
                       MC_NUM_PROCS=str(ranks), MC_PROC_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "metacache_tpu_torch.cli"] + args,
            cwd=cwd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{args[0]} on {ranks} rank(s) exceeded {timeout} s")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


def test_one_rank_per_card_over_nccl(dev, tmp_path):
    """With two or more cards: one rank per card (nccl) builds and
    serves the shards s % P == r, and one process spreads the shards over
    the cards (shard s on card s); both give the single-card fused
    query's lines, and the build gives the single-process shards."""
    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs two or more cards (one rank per card)")
    rng = np.random.default_rng(7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = [acgt[rng.integers(0, 4, 4000)].tobytes().decode()
               for _ in range(4 * n)]
    (tmp_path / "g.fa").write_text("".join(
        f">NC_{i:06d}.1 g\n{g}\n" for i, g in enumerate(genomes)))
    reads = []
    for q in range(3000):
        g = genomes[int(rng.integers(0, len(genomes)))]
        p = int(rng.integers(0, len(g) - 100))
        reads.append(f">r{q}\n{g[p:p + 100]}\n")
    (tmp_path / "r.fa").write_text("".join(reads))
    shards = str(2 * n)
    _launch(["build", "one", "g.fa", "-num-shards", shards], tmp_path, 0)
    _launch(["build", "dist", "g.fa", "-num-shards", shards], tmp_path, n)
    for s in range(2 * n):
        with np.load(tmp_path / f"one_{s}.npz", allow_pickle=True) as a, \
                np.load(tmp_path / f"dist_{s}.npz", allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    query = ["r.fa", "-tophits", "-device", "cuda"]
    _launch(["query", "one"] + query + ["-out", "fused.txt"], tmp_path, 0)
    outs = _launch(["query", "dist"] + query + ["-mesh", "-out", "dist.txt"],
                   tmp_path, n)
    for r, (_, err) in enumerate(outs):
        assert "backend nccl" in err
        assert f"shard {r} on cuda:{r}" in err
    (_, err), = _launch(["query", "one"] + query
                        + ["-mesh", "-out", "cards.txt"], tmp_path, 0)
    assert f"shard {n} on cuda:0" in err and "shard 1 on cuda:1" in err

    def lines(name):
        return [ln for ln in (tmp_path / name).read_text().splitlines()
                if not ln.startswith(("# time:", "# speed:"))]
    want = lines("fused.txt")
    assert sum(not ln.startswith("#") for ln in want) == 3000
    assert lines("dist.txt") == want
    assert lines("cards.txt") == want
