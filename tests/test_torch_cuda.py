"""The CUDA kernels (metacache_tpu_torch/csrc/sketch.cu, csrc/gather.cu)
against their plain PyTorch versions on the card, and the engine on the
card (with and without clade exclusion and window hit counts) against the
engine on the CPU. Needs a CUDA card and nvcc; skips without a card.
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
    kernel's 256-entry instantiation."""
    p, a, lens = reads(s, 512, 128)
    args = [torch.from_numpy(x).to(dev) for x in (p, a, lens)]
    kw = dict(k=16, sketch_size=s, window_size=128, starts=(0,))
    got = sketch_cuda.sketch_packed(*args, **kw)
    assert torch.equal(got, sketch_packed_reference(*args, **kw))
    with pytest.raises(ValueError):
        sketch_cuda.sketch_packed(*args, k=16, sketch_size=257,
                                  window_size=128, starts=(0,))


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
    from metacache_tpu.config import ClassifyParams, QueryPipelineParams
    from metacache_tpu.db.taxonomy import Rank
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


def test_sharded_engine_cuda_matches_cpu(dev, tmp_path):
    """Two shards on one card (the one-card -mesh placement), with window
    hit counts, against the same two shards on the CPU; both kernels
    launch once per batch on the card (one sketch per device)."""
    from metacache_tpu.config import ClassifyParams, QueryPipelineParams
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
