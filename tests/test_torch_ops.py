"""The port's ops (metacache_tpu_torch/ops) against their JAX originals
(metacache_tpu/ops) on the same numpy inputs. Tolerance: exact equality
everywhere — every op is integer arithmetic (the LCA threshold is a
float32 product computed the same way on both sides)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from metacache_tpu.config import FEATURE_SENTINEL, TARGET_SENTINEL
from metacache_tpu.ops import candidates as jcand
from metacache_tpu.ops import classify_op as jclassify
from metacache_tpu.ops import encode as jencode
from metacache_tpu.ops import hashes as jhashes
from metacache_tpu.ops import lookup as jlookup
from metacache_tpu.ops import sketch as jsketch
from metacache_tpu.ops.sketch_pallas import sketch_packed_pallas
from metacache_tpu.query import engine as jengine
from metacache_tpu.query.engine import encode_read_into, local_candidates
from metacache_tpu_torch.ops import candidates as tcand
from metacache_tpu_torch.ops import classify_op as tclassify
from metacache_tpu_torch.ops import encode as tencode
from metacache_tpu_torch.ops import gather as tgather
from metacache_tpu_torch.ops import gather_cuda
from metacache_tpu_torch.ops import hashes as thashes
from metacache_tpu_torch.ops import lookup as tlookup
from metacache_tpu_torch.ops import sketch as tsketch
from metacache_tpu_torch.ops import sketch_cuda
from metacache_tpu_torch.query import engine as teng
from tests.test_lookup import make_table
from tests.test_taxonomy_classify import make_taxonomy

torch.set_num_threads(1)


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# --------------------------------------------------------------- hashes
@pytest.mark.parametrize("seed", [0, 1])
def test_thomas_mueller_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(jhashes.thomas_mueller_hash(jnp.asarray(x)))
    got = thashes.thomas_mueller_hash(t64(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


# --------------------------------------------------------------- encode
@pytest.mark.parametrize("k", [1, 5, 12, 16])
def test_reverse_complement_and_canonical(k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 2**(2 * k), 2000, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jencode.reverse_complement_u32(jnp.asarray(x), k))
    np.testing.assert_array_equal(
        tencode.reverse_complement_u32(t64(x), k).numpy(), want)
    want = np.asarray(jencode.canonical_u32(jnp.asarray(x), k))
    np.testing.assert_array_equal(
        tencode.canonical_u32(t64(x), k).numpy(), want)


def test_numpy_helpers_match_jax():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, (16, 64), dtype=np.uint8)
    raw[:, ::3] = np.frombuffer(b"ACGTacgtN" * 1, np.uint8)[
        rng.integers(0, 9, raw[:, ::3].shape)]
    np.testing.assert_array_equal(tencode.np_encode_bytes(raw),
                                  jencode.np_encode_bytes(raw))
    codes = jencode.np_encode_bytes(raw)
    for a, b in zip(tencode.np_pack_codes(codes),
                    jencode.np_pack_codes(codes)):
        np.testing.assert_array_equal(a, b)
    _, ambig = jencode.np_pack_codes(codes)
    lens = rng.integers(0, 65, 16).astype(np.int32)
    np.testing.assert_array_equal(
        tencode.np_rows_with_ambiguity(ambig, lens, 64),
        jencode.np_rows_with_ambiguity(ambig, lens, 64))
    for n in (0, 1, 100, 128, 129, 241, 500, 1000):
        np.testing.assert_array_equal(tencode.window_starts(n, 128, 113),
                                      jencode.window_starts(n, 128, 113))


def test_unpack_and_window_kmers_match_jax():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (12, 64)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.05] = 255
    p, a = jencode.np_pack_codes(codes)
    got = tencode.unpack_codes(torch.from_numpy(p), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), codes)
    vlen = rng.integers(0, 65, 12).astype(np.int32)
    for k in (12, 16):
        jk, jv = jencode.window_kmers(jnp.asarray(codes), jnp.asarray(vlen), k)
        tk, tv = tencode.window_kmers(torch.from_numpy(codes),
                                      torch.from_numpy(vlen), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(
            np.where(tv.numpy(), tk.numpy(), 0),
            np.where(np.asarray(jv), np.asarray(jk), 0))


# --------------------------------------------------------------- sketch
@pytest.mark.parametrize("k", [12, 16])
@pytest.mark.parametrize("s", [4, 16])
def test_sketch_windows_matches_jax(k, s):
    rng = np.random.default_rng(k * 100 + s)
    B, W = 24, 128
    codes = rng.integers(0, 4, (B, W)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 255
    vlen = rng.integers(0, W + 1, B).astype(np.int32)
    vlen[:3] = [0, k - 1, k]
    want = np.asarray(jsketch.sketch_windows(jnp.asarray(codes),
                                             jnp.asarray(vlen), k, s))
    got = tsketch.sketch_windows(torch.from_numpy(codes),
                                 torch.from_numpy(vlen), k, s).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def make_batch(rng, B, L, minlen=10, alphabet="ACGTN"):
    bases = np.array(list(alphabet))
    c = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        n = int(rng.integers(minlen, L + 1))
        encode_read_into(c, lens, i, "".join(bases[rng.integers(
            0, len(bases), n)]), L)
    p, a = jencode.np_pack_codes(c)
    return p, a, lens


def pallas(p, a, lens, starts, k=16):
    return np.asarray(sketch_packed_pallas(
        jnp.asarray(p), jnp.asarray(a), jnp.asarray(lens), k=k,
        sketch_size=16, window_size=128, starts=starts, tile=8,
        interpret=True)).astype(np.int64)


def port(p, a, lens, starts, k=16):
    before = sketch_cuda.launches
    out = sketch_cuda.sketch_packed(
        torch.from_numpy(p), torch.from_numpy(a), torch.from_numpy(lens),
        k=k, sketch_size=16, window_size=128, starts=starts).numpy()
    assert sketch_cuda.launches == before   # CPU tensors: plain version
    return out


@pytest.mark.parametrize("L", [128, 256])
def test_sketch_packed_matches_pallas(L):
    rng = np.random.default_rng(L)
    p, a, lens = make_batch(rng, 16, L)
    starts = tuple(int(s) for s in jencode.window_starts(L, 128, 113))
    np.testing.assert_array_equal(port(p, a, lens, starts),
                                  pallas(p, a, lens, starts))


def test_sketch_packed_short_and_empty_reads_match_pallas():
    rng = np.random.default_rng(7)
    p, a, lens = make_batch(rng, 8, 128, minlen=0)
    lens[0] = 0
    lens[1] = 10
    p[0] = 0
    a[0] = 255
    got = port(p, a, lens, (0,))
    np.testing.assert_array_equal(got, pallas(p, a, lens, (0,)))
    assert (got[:2] == 0xFFFFFFFF).all()


def test_sketch_packed_all_ambiguous_matches_pallas():
    c = np.full((8, 128), 255, np.uint8)
    p, a = jencode.np_pack_codes(c)
    lens = np.full(8, 128, np.int32)
    got = port(p, a, lens, (0,))
    np.testing.assert_array_equal(got, pallas(p, a, lens, (0,)))
    assert (got == 0xFFFFFFFF).all()


def test_sketch_packed_k12_matches_jax_windows():
    """k != 16 (the Pallas kernel takes only 16): held to sketch_windows
    over the same windows."""
    rng = np.random.default_rng(12)
    p, a, lens = make_batch(rng, 10, 256, minlen=0)
    starts = tuple(int(s) for s in jencode.window_starts(256, 128, 113))
    got = port(p, a, lens, starts, k=12)
    codes = jencode.unpack_codes(jnp.asarray(p), jnp.asarray(a))
    want = []
    for s in starts:
        w = codes[:, s:s + 128]
        if w.shape[1] < 128:
            w = jnp.concatenate(
                [w, jnp.full((10, 128 - w.shape[1]), 255, jnp.uint8)], 1)
        want.append(np.asarray(jsketch.sketch_windows(
            w, jnp.clip(jnp.asarray(lens) - s, 0, 128), 12, 16)))
    np.testing.assert_array_equal(got, np.concatenate(want, 1))


# --------------------------------------------------------------- lookup
@pytest.mark.parametrize("lmax", [8, 24, 64])
def test_lookup_matches_jax(lmax):
    """(tgt, win, total, overflow) equal to JAX; lmax 8 forces overflow."""
    rng = np.random.default_rng(lmax)
    keys, offsets, tgt, win = make_table(rng)
    B, NF = 17, 9
    feats = np.full((B, NF), FEATURE_SENTINEL, np.uint32)
    for b in range(B):
        n = rng.integers(0, NF + 1)
        feats[b, :n] = keys[rng.integers(0, len(keys), n)]
        flip = rng.random(n) < 0.3
        feats[b, :n][flip] ^= np.uint32(1)
    want = jlookup.lookup_matches(
        jnp.asarray(feats), jnp.asarray(keys), jnp.asarray(offsets),
        jnp.asarray(tgt), jnp.asarray(win), lmax)
    locs = (tgt.astype(np.int64) << 32) | win
    got = tlookup.lookup_matches(t64(feats), t64(keys), t64(offsets),
                                 torch.from_numpy(locs), lmax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if lmax == 8:
        assert (got[3].numpy() > 0).any()


# --------------------------------------------------------------- gather
@pytest.mark.parametrize("B,L,N", [(64, 128, 1 << 12), (7, 5, 1)])
def test_gather_rows_reference_full_rows_is_table_idx(B, L, N):
    """Every row full: the function of the Pallas probe k1, table[idx]."""
    rng = np.random.default_rng(B + N)
    table = rng.integers(-2**31, 2**31, N).astype(np.int32)
    idx = rng.integers(0, N, (B, L))
    got = tgather.gather_rows_reference(torch.from_numpy(table), t64(idx),
                                        t64(np.full(B, L)), -1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), table[idx])


def test_gather_rows_reference_partial_rows():
    """Slots at or past n_valid[b] are pad, and their indices (here out of
    range) are never read; the wrapper takes the plain version on the CPU
    without counting a launch."""
    rng = np.random.default_rng(9)
    B, L, N = 33, 17, 1000
    table = rng.integers(0, 2**62, N).astype(np.int64)
    idx = rng.integers(0, N, (B, L))
    n_valid = rng.integers(0, L + 1, B)
    n_valid[:2] = [0, L]
    valid = np.arange(L)[None, :] < n_valid[:, None]
    idx[~valid] = 10**9
    pad = int(np.iinfo(np.int64).max)
    want = np.where(valid, table[np.where(valid, idx, 0)], pad)
    before = gather_cuda.launches
    for fn in (tgather.gather_rows_reference, gather_cuda.gather_rows):
        got = fn(torch.from_numpy(table), t64(idx), t64(n_valid), pad)
        np.testing.assert_array_equal(got.numpy(), want)
    assert gather_cuda.launches == before


def _exclusion_case(seed, B=24, T=12):
    """Packed reads, a feature table built from their own features (so
    most reads match, with several targets per read), a target -> clade
    map on 3 clades and one clade per read (0 = none)."""
    rng = np.random.default_rng(seed)
    p, a, lens = make_batch(rng, B, 128, minlen=40, alphabet="ACGT" * 15 + "N")
    z = np.zeros_like
    starts = tuple(int(s) for s in jencode.window_starts(128, 128, 113))
    feats = teng.compute_features(
        *(torch.from_numpy(x) for x in (p, a, lens, z(p), z(a), z(lens))),
        k=16, sketch_size=16, window_size=128, starts=starts).numpy()
    pool = np.unique(feats[feats != int(FEATURE_SENTINEL)])
    keys = np.sort(rng.choice(pool, size=len(pool) * 2 // 3, replace=False)
                   ).astype(np.uint32)
    sizes = rng.integers(1, 7, len(keys))
    offsets = np.zeros(len(keys) + 1, np.int32)
    np.cumsum(sizes, out=offsets[1:])
    n = int(offsets[-1])
    loc_tgt = rng.integers(0, T, n).astype(np.int32)
    loc_win = rng.integers(0, 60, n).astype(np.int32)
    tct = np.append(np.arange(100, 100 + T), 0).astype(np.int32)
    groups = np.append(rng.integers(1, 4, T), 0).astype(np.int32)
    excl = rng.integers(0, 4, B).astype(np.int32)
    return (p, a, lens, starts, feats, keys, offsets, loc_tgt, loc_win, tct,
            groups, excl)


@pytest.mark.parametrize("lmax", [16, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_lookup_with_exclusion_matches_jax_local_candidates(lmax, seed):
    """Clade exclusion against JAX local_candidates: the lists are cut to
    lmax first and then masked (an excluded location inside the cut frees
    no slot), total / overflow count the locations before exclusion, and
    the candidates built on the masked lists are equal."""
    (p, a, lens, starts, feats, keys, offsets, loc_tgt, loc_win, tct,
     groups, excl) = _exclusion_case(seed)
    z = np.zeros_like
    cand_w, tgt_w, win_w, total_w, over_w = (
        local_candidates(
            *(jnp.asarray(x) for x in (p, a, lens, z(p), z(a), z(lens),
                                       keys, offsets, loc_tgt, loc_win, tct,
                                       excl, groups)),
            None, None, k=16, sketch_size=16, window_size=128,
            window_stride=113, starts=starts, lmax=lmax, max_candidates=4,
            insert_size_max=0, search_steps=None, use_pallas_sketch=False,
            win_bits=0))
    locs = (loc_tgt.astype(np.int64) << 32) | loc_win
    tgt, win, total, over = tlookup.lookup_matches(
        t64(feats), t64(keys), t64(offsets), torch.from_numpy(locs), lmax,
        exclude_groups=t64(excl), target_groups=t64(groups))
    for g, w in ((tgt, tgt_w), (win, win_w), (total, total_w),
                 (over, over_w)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    num_windows = t64(2 + lens.astype(np.int64) // 113)
    cand = tcand.generate_candidates(tgt, win, num_windows, t64(tct), 4)
    for key in ("tax", "hits", "beg", "end", "tgt"):
        np.testing.assert_array_equal(cand[key].numpy(),
                                      np.asarray(cand_w[key]), err_msg=key)
    kept = (tgt.numpy() != TARGET_SENTINEL).sum(axis=1)
    # exclusion emptied slots inside the cut, and lists were cut
    assert (kept < total.numpy()).any()
    if lmax == 16:
        assert ((kept < lmax) & (over.numpy() > 0)).any()


def test_excluded_location_frees_no_slot():
    """Feature 1 has 3 locations in the read's own clade, feature 2 one
    elsewhere; at lmax 3 the cut keeps feature 1's three, which exclusion
    then removes: the list is empty, total 3, overflow 1 (JAX agrees)."""
    keys = np.array([5, 9], np.uint32)
    offsets = np.array([0, 3, 4], np.int32)
    loc_tgt = np.array([0, 0, 1, 2], np.int32)
    loc_win = np.array([4, 7, 1, 3], np.int32)
    groups = np.array([1, 1, 2, 0], np.int32)
    feats = np.array([[5, 9]], np.uint32)
    locs = (loc_tgt.astype(np.int64) << 32) | loc_win
    tgt, win, total, over = tlookup.lookup_matches(
        t64(feats), t64(keys), t64(offsets), torch.from_numpy(locs), 3,
        exclude_groups=t64([1]), target_groups=t64(groups))
    assert (tgt.numpy() == TARGET_SENTINEL).all()
    assert (int(total[0]), int(over[0])) == (3, 1)
    jt, jw, jtot, jover = jlookup.lookup_matches(
        jnp.asarray(feats), jnp.asarray(keys), jnp.asarray(offsets),
        jnp.asarray(loc_tgt), jnp.asarray(loc_win), 3)
    assert (int(jtot[0]), int(jover[0])) == (3, 1)
    assert int(groups[np.asarray(jt)[0]].min()) == 1  # all in the clade


# ------------------------------------------------------------ candidates
@pytest.mark.parametrize("seed", range(4))
def test_generate_candidates_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, L, nt = 32, 64, 9
    tgt = np.full((B, L), TARGET_SENTINEL, np.int32)
    win = np.full((B, L), 2**31 - 1, np.int32)
    for b in range(B):
        n = int(rng.integers(0, L + 1))
        ml = sorted(zip(rng.integers(0, nt, n).tolist(),
                        rng.integers(0, 40, n).tolist()))
        for j, (t, w) in enumerate(ml):
            tgt[b, j], win[b, j] = t, w
    nw = rng.integers(1, 6, B).astype(np.int32)
    # a non-injective map (targets merged into taxa) and an injective one
    tmap = np.append(rng.integers(1, 5, nt) if seed % 2
                     else np.arange(100, 100 + nt), 0).astype(np.int32)
    for mc in (1, 2, 4):
        want = jcand.generate_candidates(tgt, win, nw, tmap, mc, win_bits=0)
        got = tcand.generate_candidates(t64(tgt), t64(win), t64(nw),
                                        t64(tmap), mc)
        for key in ("tax", "hits", "beg", "end", "tgt"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]),
                                          err_msg=key)


@pytest.mark.parametrize("K", [4, 16])
@pytest.mark.parametrize("seed", range(3))
def test_target_window_hits_matches_jax(seed, K):
    """-hits-per-seq window hit counts per candidate, on match lists with
    repeated (target, window) pairs."""
    rng = np.random.default_rng(50 + seed)
    B, L, nt = 24, 64, 5
    tgt = np.full((B, L), TARGET_SENTINEL, np.int32)
    win = np.full((B, L), 2**31 - 1, np.int32)
    for b in range(B):
        n = int(rng.integers(0, L + 1))
        ml = sorted(zip(rng.integers(0, nt, n).tolist(),
                        rng.integers(0, 12, n).tolist()))
        for j, (t, w) in enumerate(ml):
            tgt[b, j], win[b, j] = t, w
    nw = rng.integers(1, 8, B).astype(np.int32)
    tmap = np.append(np.arange(100, 100 + nt), 0).astype(np.int32)
    cj = jcand.generate_candidates(tgt, win, nw, tmap, 3, win_bits=0)
    want = np.asarray(jengine.target_window_hits(
        cj, jnp.asarray(tgt), jnp.asarray(win), K))
    ct = tcand.generate_candidates(t64(tgt), t64(win), t64(nw), t64(tmap), 3)
    got = teng.target_window_hits(ct, t64(tgt), t64(win), K)
    assert got.shape == (B, 3, K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 1


def test_target_window_hits_on_full_rows():
    """Match lists that fill every slot (no pad at the row's end): the port
    counts each (target, window) exactly, as a numpy count does. The JAX
    function over-counts the row's last run by one there: its unrolled
    binary search (ops/candidates.py::_lower_bound_pairs) runs past the
    converged bound L to L + 1. Elsewhere the two agree."""
    rng = np.random.default_rng(77)
    B, L, nt, K = 16, 32, 3, 8
    tgt = np.zeros((B, L), np.int32)
    win = np.zeros((B, L), np.int32)
    for b in range(B):
        ml = sorted(zip(rng.integers(0, nt, L).tolist(),
                        rng.integers(0, 6, L).tolist()))
        tgt[b], win[b] = zip(*ml)
    nw = np.full(B, 8, np.int32)
    tmap = np.append(np.arange(100, 100 + nt), 0).astype(np.int32)
    ct = tcand.generate_candidates(t64(tgt), t64(win), t64(nw), t64(tmap), 3)
    got = teng.target_window_hits(ct, t64(tgt), t64(win), K).numpy()
    ctg, cbeg, cend = (ct[k].numpy() for k in ("tgt", "beg", "end"))
    want = np.zeros_like(got)
    for b in range(B):
        for c in range(3):
            for k in range(K):
                w = cbeg[b, c] + k
                if w <= cend[b, c]:
                    want[b, c, k] = ((tgt[b] == ctg[b, c])
                                     & (win[b] == w)).sum()
    np.testing.assert_array_equal(got, want)
    cj = jcand.generate_candidates(tgt, win, nw, tmap, 3, win_bits=0)
    jax_counts = np.asarray(jengine.target_window_hits(
        cj, jnp.asarray(tgt), jnp.asarray(win), K))
    diff = jax_counts - want
    last = np.zeros_like(diff, bool)   # the query of each row's last pair
    for b in range(B):
        last[b] = ((ctg[b, :, None] == tgt[b, -1])
                   & (cbeg[b, :, None] + np.arange(K) == win[b, -1]))
    assert (diff[last] == 1).all() and (diff[~last] == 0).all()
    assert last.any()


# -------------------------------------------------------------- classify
# the cases of tests/test_taxonomy_classify.py::TestClassifyLCA:
# (seq ids with hits, hits_min, hits_diff_fraction)
CLASSIFY_CASES = {
    "single-candidate": ([(-1, 10)], 5, 1.0),
    "below-hitsmin": ([(-1, 4)], 5, 1.0),
    "same-genus": ([(-1, 10), (-2, 9)], 5, 1.0),
    "second-below-threshold": ([(-1, 10), (-2, 5)], 5, 1.0),
    "lca-above-highest": ([(-1, 10), (-5, 9)], 5, 1.0),
}


@pytest.mark.parametrize("case", sorted(CLASSIFY_CASES))
def test_classify_lca_named_cases_match_jax(case):
    from metacache_tpu.db.taxonomy import Rank
    t, _ = make_taxonomy()
    cands, hits_min, frac = CLASSIFY_CASES[case]
    tax = np.zeros((1, 4), np.int32)
    hits = np.zeros((1, 4), np.int32)
    for i, (sid, h) in enumerate(cands):
        tax[0, i], hits[0, i] = t.node_of_id(sid), h
    lin = t.ranked_lineage
    wb, wr = jclassify.classify_lca(tax, hits, lin, np.int32(hits_min),
                                    np.float32(frac), Rank.DOMAIN)
    gb, gr = tclassify.classify_lca(t64(tax), t64(hits), t64(lin), hits_min,
                                    frac, Rank.DOMAIN)
    assert (int(gb[0]), int(gr[0])) == (int(wb[0]), int(wr[0]))


@pytest.mark.parametrize("frac", [0.0, 0.5, 0.8, 1.0])
def test_classify_lca_matches_jax(frac):
    t, seqs = make_taxonomy()
    nodes = [t.node_of_id(s) for s in seqs]
    rng = np.random.default_rng(int(frac * 10))
    B, C = 64, 4
    tax = np.zeros((B, C), np.int32)
    hits = np.zeros((B, C), np.int32)
    for b in range(B):
        k = int(rng.integers(0, C + 1))
        cands = sorted([(nodes[rng.integers(0, len(nodes))],
                         int(rng.integers(0, 20))) for _ in range(k)],
                       key=lambda x: -x[1])
        for i, (tx, h) in enumerate(cands):
            tax[b, i], hits[b, i] = tx, h
    lin = t.ranked_lineage
    for hits_min in (0, 3, 5):
        for highest in (t.rank[nodes[0]] + 1, 20):
            wb, wr = jclassify.classify_lca(tax, hits, lin,
                                            np.int32(hits_min),
                                            np.float32(frac), int(highest))
            gb, gr = tclassify.classify_lca(t64(tax), t64(hits), t64(lin),
                                            hits_min, frac, int(highest))
            np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
            np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
