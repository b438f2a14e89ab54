"""The CUDA sketch kernel (metacache_tpu_torch/csrc/sketch.cu) against its
plain PyTorch version on the card, and the engine on the card against the
engine on the CPU. Needs a CUDA card and nvcc; skips without a card.
Tolerance: bit equality.

On the card's machine (which has no JAX, hence no conftest):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from metacache_tpu_torch.ops import encode, sketch_cuda
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


def test_engine_cuda_matches_cpu(dev, tmp_path):
    from metacache_tpu.config import ClassifyParams, QueryPipelineParams
    from metacache_tpu_torch.db.build import (BuildOptions,
                                              build_database_shards)
    from metacache_tpu_torch.query.engine import QueryEngine

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
    db = build_database_shards([str(fasta)], BuildOptions())[0]
    pipeline = QueryPipelineParams(batch_size=256, max_query_len=128,
                                   max_locations_per_query=64)
    c1, l1, c2, l2 = (np.zeros((256, 128), np.uint8), np.zeros(256, np.int32),
                      np.full((256, 128), 255, np.uint8),
                      np.zeros(256, np.int32))
    for i in range(200):
        g = genomes[int(rng.integers(0, 6))]
        p = int(rng.integers(0, len(g) - 300))
        encode_read_into(c1, l1, i, g[p:p + 100], 128)
        encode_read_into(c2, l2, i, g[p + 180:p + 280], 128)
    classify = ClassifyParams(max_candidates=3)
    res = [QueryEngine(db, classify, pipeline, device=d).classify_batch(
        c1, l1, c2, l2, 200) for d in (dev, torch.device("cpu"))]
    for f in ("best", "best_rank", "match_total", "match_overflow",
              "cand_tax", "cand_hits", "cand_beg", "cand_end", "cand_tgt"):
        np.testing.assert_array_equal(getattr(res[0], f), getattr(res[1], f),
                                      err_msg=f)
    assert os.path.exists(sketch_cuda.library_path())
