#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (metacache_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA
     versions. The three kernel libraries are built at once (one nvcc per
     source, in parallel).
  2. kernels vs plain: the CUDA sketch kernel (csrc/sketch.cu), its
     entry for the build's reference windows (whole ASCII records with
     ambiguous bases, tail windows, records shorter than k and than a
     window) and the CUDA gather kernel (csrc/gather.cu) held bit for bit
     against their plain PyTorch versions on the card, at the main paths'
     shapes and on edge cases; the shard merge streamed to the card (the
     two kernels of csrc/merge.cu) against the same merge on the CPU
     (their plain versions), table for table, on random tables of 2, 3
     and 4 shards with ties, in many chunks. Per kernel and shape: its
     device time (a CUDA graph of 20 calls, replayed: no host launch
     cost), its call time (CUDA events
     over back-to-back calls from Python, host launch cost included), the
     plain version's call time, the one library call that computes the
     same function where there is one (table[idx] for the gather), the
     bound (bytes over the HBM rate or operations over the issue rate,
     counted from the inputs) and the share of it.
  3. config-2 (BASELINE config-2, the RefSeq-viral analogue of bench.py:
     15,000 genomes, 1,048,576 single-end 100 bp reads): the port's CLI
     builds the database on the card (its card path: the window kernel
     ran) from the genomes and two bad files beside them (a header-only
     NCBI assembly_summary.txt and a truncated FASTQ): both are reported
     on `FAIL:` lines and left out, the database is the JAX package's
     (77,048,814 features, 86,957,916 locations, max bucket 7) and every
     array equals the `-device cpu` (native host) build's. Then every
     read is queried on -device cuda. Checks that both kernels ran on
     that path and that the classified fraction is within 0.001 of the
     0.9719 the JAX package recorded on the same seeded world; the first
     16,384 reads again on -device cpu give the same mapping lines.
  4. the realistic paired-end world of bench.py (96 Mbp, 262,144 pairs,
     a repeat at the 254-location cap): GPU query, and the first 8,192
     pairs on the CPU give the same mapping lines.
  5. config-2 evaluation: the first 262,144 reads with -exclude species
     -precision; no read is classified as its own species, and the first
     16,384 lines equal -device cpu's.
  6. -hits-per-seq -tophits (16,384 reads), -align (2,048 reads) and the
     evaluation summaries (16,384 reads with -abundances -abundance-per
     species -precision -taxon-coverage -hits-per-seq): -device cuda
     writes the bytes -device cpu writes, summary blocks included.
  7. modify: the first 14,500 genomes built on the card, the last 500
     added by `modify` on cuda beside a malformed FASTQ (reported on a
     `FAIL:` line on stderr, left out): every array equal to the one-shot
     build's (the source-file names aside); all reads queried against it.
  8. merge: 131,072 reads queried against the two partial databases,
     merged on cuda and on cpu: equal outputs.
  9. interactive: two lines on stdin, the second changing only -hitmin:
     the engine is reused and the first line's output equals the
     non-interactive run's.
 10. info: statistics and `rank species`.
 11. mesh: config-2 built in 4 shards, every read queried with -mesh on
     cuda (the shards on the card, or spread over the cards if there
     are several): both kernels ran, every mapping line equals the fused
     query's, classified fraction as in 3.
 12. distributed: two ranks of one process group (MC_* variables; gloo
     where both share the one card, nccl with a card each where there
     are two or more), each through this script's rank worker
     (`--rank-worker`): `build -num-shards 4` gives the single-process
     shards array for array; `query -mesh` on 262,144 reads gives the
     fused query's first lines on rank 0; both kernels ran in each rank.
 13. realistic_mesh: the realistic world in 2 shards with -mesh; the
     first 8,192 pairs on the CPU give the same lines; how many lines
     differ from the fused query's (per-shard truncation) is printed.
 14. config3: bench.py's config-3 world (200 targets x 25 Mbp in
     4-strain groups, a 5 kbp transposon five times per genome,
     1,048,400 pairs: 5,242 per genome of the nominal 1,048,576; ~5 GB of
     FASTA), built on the card in 2 shards (`build -num-shards 2`, 5 Gbp,
     through scripts/build_split.py's worker: the window kernel ran, no
     shard spilled, no host sort ran) and queried fused on cuda: the shards are
     merged on the card as they stream up (never on the host), into the
     JAX package's 209,588,260 features, 707,655,761 locations and a
     fused max bucket of 508 (read from the engine's device tables); the
     classified fraction, over 1,048,576 as bench.py counts it, is within
     0.001 of its 0.9987; 128 sketch and 64 gather launches, one merge
     and one count launch per planned chunk; the first 8,192 pairs give
     the same lines on the CPU. Prints the build's seconds, Gbp/s, peak
     host RSS (sampled) and split (start, parse, sketch, each shard's
     finalize, save, exit), the query's database load, table upload (the
     merge included) and loop seconds (as the query prints them), its
     peak device memory and overflow count; times the window kernel on
     the build's first batch, the gather kernel on one real batch of the
     query and both merge kernels on its first chunk (staged again from
     the shard files), each held bit for bit against its plain version
     there. Needs ~25 GB
     of disk and ~15 GB of host RAM at its peak; the world is removed
     after phase 15.
 15. config3_mesh: the same 2 shards with -mesh: every pair has its line,
     both kernels ran, the first 8,192 pairs give the same lines on the
     CPU; the lines that differ from the fused query's (per-shard
     truncation) and the classified fraction are printed.
 16. self_contained: no module of the JAX package (metacache_tpu) was
     imported by this run, and the native library it loaded is the
     port's own, built from metacache_tpu_torch/native/mcio.cpp into
     build/metacache_tpu_torch/.
Each path is driven with every kernel's launch count set to 0 just
before it and read just after. Each phase prints its wall seconds
(`phase_seconds`), and `[done]` the total. Then the kernels' JSON line
and, last, the device JSON line. The CLI runs of their own process go
through `python -m metacache_tpu_torch`.

Worlds, databases and outputs go to build/smoke/ (and the kernel
libraries and libmcio to build/metacache_tpu_torch/) inside the checkout.
Imports neither JAX nor the JAX package.

    python3 chip_smoke.py --kernel-times [ROOT]

runs phase 2 alone on the port found under ROOT (default: this
checkout), to time another tree's kernels beside this one's in one call.
It also times three yardsticks of the gather at each shape: the same
output written by one fill kernel, by the kernel with no slot valid, and
the valid slots' table reads alone as one library gather.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "smoke")
DEVICE = "cuda"

C2_EXPECTED_CLASSIFIED = 0.9719     # BENCH_r05.json, JAX package
C2_TOLERANCE = 0.001
#: config-2 as bench.py generates it, and the JAX package's database of
#: it (BENCH_r05.json, config2_*), held only while the world is uncut
C2_WORLD = dict(C2_GENOMES=15_000, C2_READS=1_048_576)
C2_EXPECTED = dict(features=77_048_814, locations=86_957_916, max_bucket=7)
#: beside config-2's genomes: a header-only NCBI assembly_summary.txt (no
#: known sequence format) and a FASTQ cut inside its third record (no
#: quality header); `build` reports both and leaves them out
ASSEMBLY_SUMMARY = ("# assembly_accession\tbioproject\tbiosample\t"
                    "wgs_master\trefseq_category\ttaxid\tspecies_taxid\t"
                    "organism_name\n")
TRUNCATED_FASTQ = ("@NC_900000.1 cut\nACGTACGTAC\n+\nIIIIIIIIII\n"
                   "@NC_900001.1 cut\nCCGGTTAACC\n+\nIIIIIIIIII\n"
                   "@NC_900002.1 cut\nGGTTAACCGG\n")
#: a file `modify` reports and leaves out: its first record is malformed
MALFORMED_FASTQ = "@NC_900003.1 malformed\nACGTACGTAC\nACGTACGTAC\n"
BATCH_SIZE = 16384
PIPELINE_FLAGS = ["-batch-size", str(BATCH_SIZE), "-max-query-len", "104",
                  "-max-locations-per-query", "256"]
#: config-3 as bench.py generates it (make_config3_world), and the JAX
#: package's numbers for that seeded world (BENCH_r05.json, config3_*:
#: the database's size and the classified fraction), held only while the
#: world is generated uncut
C3_WORLD = dict(C3_BASES=50, C3_VARIANTS=4, C3_GLEN=25_000_000,
                C3_TP_LEN=5_000, C3_TP_COPIES=5, C3_PAIRS=1_048_576)
C3_EXPECTED = dict(features=209_588_260, locations=707_655_761,
                   max_bucket=508)
C3_EXPECTED_CLASSIFIED = 0.9987
C3_SHARDS = 2              # bench.measure_config3's -num-shards
C3_CPU_PAIRS = 8192        # pairs compared with -device cpu
PALLAS_SKETCH = "metacache_tpu/ops/sketch_pallas.py:165"
PALLAS_GATHERS = {"k1": "tools/exp_pallas_gather.py:50",
                  "k2": "tools/exp_pallas_gather.py:78"}
#: no TPU kernel merges shards: the JAX package merges them on the host
HOST_MERGE = "metacache_tpu/native/mcio.cpp:1351"
#: config-2's lookup: its location table and the query's [B, lmax] slots
C2_LOCATIONS = C2_EXPECTED["locations"]
C2_SLOTS = (16384, 256)
C2_MAX_VALID = 26           # rows hold 0..26 matches: 5.1% of the slots
#: the card's peak rates (NVIDIA H100 SXM data sheet, at 700 W): HBM
#: bytes/s, and lane operations/s: an SM issues at most 4 warp
#: instructions (128 lane operations) per clock, 132 SMs at the 1.98 GHz
#: boost clock, which is the data sheet's 67 TFLOP/s of float32 with an
#: FMA counted as two. An integer mix meets the same ceiling: the
#: compiler spreads it over the INT32 pipe (64 lanes per SM) and the FMA
#: pipe (IMAD, and the IMAD forms of shifts, adds and moves)
HBM_BYTES_PER_S = 3.35e12
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
#: integer operations the sketch needs at least, in the cheapest scheme
#: known, each k-mer assembled from the packed row as the kernel does (a
#: rolling pair of strands costs ~7 per character instead): per k-mer
#: start in a window, its ambiguity test (a funnel shift of the
#: ambiguity bits and a test); per valid k-mer, both strands (a funnel
#: shift, a bit reverse, a 3-operation swap of the bit pairs, the
#: complement; k < 16 adds a mask and a shift), the canonical min, the
#: Thomas-Mueller hash (3 shifts, 3 xors, 2 multiplies) and one compare
#: against the sketch's largest value
SKETCH_OPS_PER_START = 2
SKETCH_OPS_PER_KMER = 6 + 1 + 8 + 1
SKETCH_OPS_SHORT_K = 2

CPU_LINES = 16384          # reads compared with -device cpu
#: every evaluation summary at once (classified down to the sequence, so
#: the hits-per-target list is filled), and the heading of each block
SUMMARY_FLAGS = ["-abundances", "-abundance-per", "species", "-precision",
                 "-taxon-coverage", "-hits-per-seq"]
SUMMARY_BLOCKS = ("# --- list of hits for each reference sequence ---",
                  "# query summary: number of queries mapped per taxon",
                  "# estimated abundance (number of queries) per species",
                  "# precision (correctly classified / classified)",
                  "# sensitivity (correctly classified / all)",
                  "# false positives (hit on taxa not covered in DB):")
ALIGN_READS = 2048
EVAL_READS = 262144        # reads of the evaluation query
MODIFY_ADDED = 500         # genomes that `modify` adds
#: arrays naming each taxon's source file and its index there, which a
#: database built from two files cannot share with a one-shot build
MODIFY_SOURCE_ARRAYS = ("tax_source_filename", "tax_source_index")
MERGE_READS = 131072
INTERACTIVE_READS = 65536
MESH_SHARDS = 4            # config-2's -mesh and 2-rank shard count
DIST_READS = 262144        # reads of the 2-rank -mesh query
RANK_TIMEOUT = 600         # seconds for each 2-rank launch

#: the timed numbers of a kernel at one shape that its JSON row carries
TIMES = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
         "bound_ms", "bound_by", "share_of_bound")

#: launches of each kernel, summed over the paths this run drove
LAUNCHES = {"sketch_packed": 0, "sketch_windows": 0, "gather_rows": 0,
            "merge_shards": 0, "merge_count": 0}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def say(phase: str, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def port_cli(args, log):
    """Run the port's CLI as a user would, in its own process."""
    t0 = time.time()
    with open(log, "w") as f:
        r = subprocess.run([sys.executable, "-m", "metacache_tpu_torch"]
                           + args, cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
                           timeout=900)
    check(r.returncode == 0, f"{' '.join(args[:2])} failed, see {log}")
    return time.time() - t0


def build_cli(args, log):
    """`build` through the port's CLI in its own process, on DEVICE (the
    card path on cuda)."""
    return port_cli(args + ["-device", DEVICE], log)


def kernel_counters():
    """Each kernel's wrapper module and the name of its launch count."""
    from metacache_tpu_torch.ops import gather_cuda, merge_cuda, sketch_cuda
    return {"sketch_packed": (sketch_cuda, "launches"),
            "sketch_windows": (sketch_cuda, "window_launches"),
            "gather_rows": (gather_cuda, "launches"),
            "merge_shards": (merge_cuda, "merge_launches"),
            "merge_count": (merge_cuda, "count_launches")}


def reset_launches():
    for mod, count in kernel_counters().values():
        setattr(mod, count, 0)


def read_launches():
    return {name: getattr(mod, count)
            for name, (mod, count) in kernel_counters().items()}


def driven(path, kernels, args, stdin=None):
    """One path through the port's CLI entry point, in this process, with
    every kernel's launch count set to 0 just before it and read just
    after; each kernel in `kernels` must have launched. Returns (stdout,
    stderr, wall seconds, counts)."""
    import torch
    from metacache_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    old_stdin = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(args + ["-device", DEVICE])
        torch.cuda.synchronize()
    finally:
        sys.stdin = old_stdin
    wall = time.time() - t0
    counts = read_launches()
    check(rc == 0, f"{path}: {' '.join(args[:2])} failed (rc {rc}): "
                   f"{err.getvalue()[-2000:]}")
    for name in kernels:
        LAUNCHES[name] += counts[name]
        check_launched(path, name, counts[name])
    return out.getvalue(), err.getvalue(), wall, counts


def check_launched(path, name, n, expected=None):
    """n launches of kernel `name` on `path`: at least one, and exactly
    `expected` where the path's batch count fixes it."""
    check(n > 0, f"{path}: the {name} kernel was never launched")
    check(expected is None or n == expected,
          f"{path}: the {name} kernel was launched {n} times, expected "
          f"{expected}")


def mapping_lines(path):
    """The per-read lines of a result file (the summary's lines start
    with '#', or hold no column separator)."""
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("#") and "\t|\t" in ln]


def result_lines(path):
    """Every line but the run-dependent '# time:' / '# speed:' ones."""
    with open(path) as f:
        return [ln for ln in f
                if not ln.startswith(("# time:", "# speed:"))]


def call_ms(fn, reps=20):
    """Time per call of back-to-back calls from Python, by CUDA events: the
    device time plus any host launch cost the device waits on."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=20):
    """Device time per call: a CUDA graph of `reps` calls, replayed, so no
    host launch cost is in it (the graph's gaps between kernels are)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return call_ms(graph.replay, 5) / reps


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the card's HBM
    rate and the operations over its issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ISSUE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(name, fn, plain, library, bound_ms, bound_by,
          library_in_graph=True):
    """Times of one kernel at one shape, printed with its bound. A library
    call that waits for the card (its output's size) cannot be captured
    in a CUDA graph: library_in_graph=False leaves its device time out."""
    res = dict(ms=call_ms(fn), device_ms=device_ms(fn),
               plain_ms=call_ms(plain, 3),
               library_ms=None if library is None else call_ms(library),
               library_device_ms=device_ms(library)
               if library is not None and library_in_graph else None,
               bound_ms=bound_ms, bound_by=bound_by)
    res["share_of_bound"] = bound_ms / res["device_ms"]
    say(name, **{k: ("none" if v is None else
                     f"{v:.6f}" if isinstance(v, float) else v)
                 for k, v in res.items()})
    return res


def build_kernels():
    """The kernel libraries from the checkout's sources, one nvcc per
    source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    libs = list({m.LIBRARY.source: m.LIBRARY
                 for m, _ in kernel_counters().values()}.values())
    t0 = time.time()
    with ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.load(), libs))
    say("build", kernels=len(libs), seconds=f"{time.time() - t0:.1f}")
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                say("build", source=os.path.basename(lib.source),
                    ptxas=line.strip().replace(" ", "_"))


def random_reads(rng, B, L, max_len, ambig_rate=0.01, full=False):
    """[B, L] 2-bit packed reads of random length <= max_len (all of
    length max_len if `full`), some bases ambiguous, as the native reader
    packs them."""
    import numpy as np
    from metacache_tpu_torch.ops.encode import np_pack_codes
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < ambig_rate] = 255
    lens = np.full(B, max_len, np.int32) if full else \
        rng.integers(0, max_len + 1, B).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 255
    p, a = np_pack_codes(codes)
    return p, a, lens


def sketch_bound(packed, ambig, lens, out, k, window_size, starts):
    """The sketch's bound on these inputs: each input and the output moved
    once; SKETCH_OPS_PER_START operations for every k-mer start in a
    window and SKETCH_OPS_PER_KMER (+ SKETCH_OPS_SHORT_K for k < 16) for
    every valid k-mer, counted from the data (the k-mer validity rule of
    the plain version)."""
    from metacache_tpu_torch.ops.encode import unpack_codes, window_kmers
    codes = unpack_codes(packed, ambig)
    kmer_starts = kmers = 0
    for s in starts:
        wlen = (lens.long() - s).clamp(0, window_size)
        kmer_starts += int((wlen - k + 1).clamp(min=0).sum())
        w = codes[:, s:s + window_size]
        if w.shape[1] >= k:
            kmers += int(window_kmers(w, wlen, k)[1].sum())
    nbytes = sum(t.numel() * t.element_size()
                 for t in (packed, ambig, lens, out)) + 4 * len(starts)
    per_kmer = SKETCH_OPS_PER_KMER + (SKETCH_OPS_SHORT_K if k < 16 else 0)
    return bound(nbytes, SKETCH_OPS_PER_START * kmer_starts
                 + per_kmer * kmers)


def phase_kernel(dev):
    """Sketch kernel vs its plain version on the card: bit-equal at the
    main paths' shapes and on edge cases; timed."""
    import numpy as np
    import torch
    from metacache_tpu_torch.ops import encode, sketch_cuda
    from metacache_tpu_torch.ops.sketch import sketch_packed_reference

    rng = np.random.default_rng(2024)

    def run(p, a, lens, L, k=16, s=16, W=128, stride=113):
        starts = tuple(int(x) for x in encode.window_starts(L, W, stride))
        args = [torch.from_numpy(x).to(dev) for x in (p, a, lens)]
        kw = dict(k=k, sketch_size=s, window_size=W, starts=starts)
        got = sketch_cuda.sketch_packed(*args, **kw)
        want = sketch_packed_reference(*args, **kw)
        torch.cuda.synchronize()
        check(got.shape == want.shape, "kernel output shape")
        err = int((got - want).abs().max()) if got.numel() else 0
        return err, args, kw, got

    results = {}
    # the main path's shapes: the QueryPipelineParams default (B 4096,
    # reads up to 320) and the config-2 / realistic cells (B 16384, 104,
    # every read 100 bp as in config-2)
    for name, B, L, max_len, full in (("default", 4096, 320, 320, False),
                                      ("cells", 16384, 104, 100, True)):
        p, a, lens = random_reads(rng, B, L, max_len, full=full)
        err, args, kw, got = run(p, a, lens, L)
        check(err == 0, f"kernel differs from plain at {name} shapes")
        res = timed(f"kernel_B{B}xL{L}",
                    lambda: sketch_cuda.sketch_packed(*args, **kw),
                    lambda: sketch_packed_reference(*args, **kw), None,
                    *sketch_bound(*args, got, kw["k"], kw["window_size"],
                                  kw["starts"]))
        results[name] = dict(res, shape=f"B{B}xL{L}", err=err)

    # edge cases: empty, shorter than k, all ambiguous, reads with N,
    # k 1 to 16, B not a multiple of any tile, the build's sketch sizes
    # over 64 (sizes above the k-mer count too), ambiguous bases at the
    # 32-character boundaries, windows longer than 32 characters with
    # several windows per read, and a single read
    B, L = 1000 + 7, 256
    p, a, lens = random_reads(rng, B, L, L, ambig_rate=0.03)
    lens[:4] = [0, 5, 15, 16]
    a[4:8] = 255          # all ambiguous
    for r, pos in enumerate((31, 32, 63, 64, 95, 96, 127, 128)):
        a[8 + r, pos >> 3] |= np.uint8(1 << (pos & 7))
    for k in (1, 5, 12, 16):
        for s in (1, 16, 64, 80, 256):
            err, _, _, _ = run(p, a, lens, L, k=k, s=s)
            check(err == 0, f"kernel differs from plain on edge cases "
                            f"(k={k}, s={s})")
    for W, stride in ((300, 200), (1024, 1000), (40, 7)):
        for k, s in ((16, 16), (7, 100)):
            err, _, _, _ = run(p, a, lens, L, k=k, s=s, W=W, stride=stride)
            check(err == 0, f"kernel differs from plain with window {W} / "
                            f"stride {stride} (k={k}, s={s})")
    for k, s in ((16, 16), (1, 4), (16, 256)):
        err, _, _, _ = run(p[:1], a[:1], lens[:1] + 200, L, k=k, s=s)
        check(err == 0, f"kernel differs from plain on one read (k={k})")
    say("kernel", edge_cases="ok", B=B, k="1,5,7,12,16",
        s="1,4,16,64,80,100,256", windows="128/113,300/200,1024/1000,40/7")
    results["windows_edges"] = dict(err=window_edges(dev, rng))
    return results


def window_edges(dev, rng):
    """The build's window kernel vs its plain version on whole ASCII
    records (upper and lower case, N runs, IUPAC codes) shorter than k,
    than a window and longer, with tail windows, for several k, s,
    window lengths and strides; returns the largest difference (0)."""
    import numpy as np
    import torch
    from metacache_tpu_torch.ops import sketch_cuda
    if not hasattr(sketch_cuda, "sketch_windows"):   # an older tree
        say("kernel", window_edge_cases="none: no window kernel in "
            "this tree")
        return 0
    from metacache_tpu_torch.db.build import _num_windows
    from metacache_tpu_torch.ops.sketch import sketch_windows_reference
    alphabet = np.frombuffer(b"ACGTacgtNRYKM", np.uint8)
    lens = np.concatenate([[1, 5, 15, 16, 17, 90, 128, 129, 241, 1000],
                           rng.integers(1, 20000, 60)]).astype(np.int64)
    seq = alphabet[rng.choice(len(alphabet), int(lens.sum()),
                              p=[.2] * 4 + [.03] * 4 + [.016] * 5)]
    off = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    err = 0
    for k, s, W, stride in ((16, 16, 128, 113), (16, 64, 128, 113),
                            (9, 40, 128, 113), (1, 4, 128, 113),
                            (16, 100, 300, 200), (12, 8, 40, 7),
                            (16, 256, 1000, 900)):
        nwin = _num_windows(lens, W, stride)
        win_off = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(nwin, out=win_off[1:])
        args = [torch.from_numpy(x).to(dev) for x in (seq, off, lens,
                                                       win_off)]
        kw = dict(n_windows=int(win_off[-1]), k=k, sketch_size=s,
                  window_size=W, stride=stride)
        got = sketch_cuda.sketch_windows(*args, **kw)
        want = sketch_windows_reference(*args, **kw)
        e = int((got != want).sum())
        check(e == 0, f"window kernel differs from plain in {e} values "
                      f"(k={k}, s={s}, window {W} / stride {stride})")
        err = max(err, e)
    say("kernel", window_edge_cases="ok", records=len(lens),
        k="1,9,12,16", s="4,8,16,40,64,100,256",
        windows="128/113,300/200,40/7,1000/900")
    return err


def gather_bound(table, used, n_valid, out):
    """The gather's bound on these inputs (`used`: the indices of the
    valid slots): out written once, n_valid read once, the idx of every
    valid slot read once, and one 32-byte sector of the table for each
    distinct sector a valid slot reads."""
    import torch
    sectors = int(torch.unique(used // (32 // table.element_size())).numel())
    nbytes = out.numel() * out.element_size() + n_valid.numel() * 8 \
        + used.numel() * 8 + sectors * 32
    return bound(nbytes, 0)


def phase_gather(dev, yardsticks=False):
    """Gather kernel vs its plain version on the card: bit-equal at the
    probe k1's shapes, at config-2's lookup shape and on edge cases;
    timed beside the one library call table[idx] (and, with
    `yardsticks`, beside each half of its work alone)."""
    import torch
    from metacache_tpu_torch.ops import gather_cuda
    from metacache_tpu_torch.ops.gather import gather_rows_reference

    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)

    def case(N, B, L, dtype, full, max_valid=None):
        hi = torch.iinfo(dtype).max
        table = torch.randint(0, hi, (N,), dtype=dtype, device=dev,
                              generator=gen)
        idx = torch.randint(0, N, (B, L), dtype=torch.int64, device=dev,
                            generator=gen)
        if full:
            n_valid = torch.full((B,), L, dtype=torch.int64, device=dev)
        else:
            n_valid = torch.randint(0, (max_valid or L) + 1, (B,),
                                    dtype=torch.int64, device=dev,
                                    generator=gen)
            n_valid[:2] = torch.tensor([0, L], device=dev)
        return table, idx, n_valid, hi

    def compare(name, table, idx, n_valid, pad, timed_=False):
        got = gather_cuda.gather_rows(table, idx, n_valid, pad)
        want = gather_rows_reference(table, idx, n_valid, pad)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"gather kernel output dtype/shape ({name})")
        err = int((got != want).sum())
        check(err == 0, f"gather kernel differs from plain in {err} "
                        f"elements ({name})")
        res = dict(err=err, shape=name)
        if timed_:
            used = idx[torch.arange(idx.shape[1], device=dev)[None, :]
                       < n_valid[:, None]]
            res.update(timed(
                f"gather_{name}",
                lambda: gather_cuda.gather_rows(table, idx, n_valid, pad),
                lambda: gather_rows_reference(table, idx, n_valid, pad),
                lambda: table[idx], *gather_bound(table, used, n_valid, got)))
        if timed_ and yardsticks:
            # device times of each half of the work alone: the same output
            # written by one fill kernel, and by this kernel with no slot
            # valid; the valid slots' random table reads alone, as one
            # library gather
            none = torch.zeros_like(n_valid)
            halves = dict(
                write_only_device_ms=lambda: torch.full(
                    got.shape, pad, dtype=got.dtype, device=dev),
                pad_only_device_ms=lambda: gather_cuda.gather_rows(
                    table, idx, none, pad),
                reads_only_device_ms=lambda: table[used])
            say(f"gather_{name}", **{k: f"{device_ms(f):.6f}"
                                     for k, f in halves.items()})
        return res

    results = {}
    # the probe k1: int32 table of 2^20 words, idx [2048, 128], rows full
    t, i, n, pad = case(1 << 20, 2048, 128, torch.int32, True)
    results["k1"] = compare("k1_N1048576_B2048xL128", t, i, n, pad, True)
    del t, i, n
    # config-2's lookup: its 86,957,916 packed locations (int64, 696 MB,
    # far past the 50 MB L2) and [16384, 256] slots; rows hold 0..26
    # valid slots, 5.1% of them, as config-2's lookup fills 5.2% (PERF.md)
    t, i, n, pad = case(C2_LOCATIONS, *C2_SLOTS, torch.int64, False,
                        max_valid=C2_MAX_VALID)
    results["config2"] = compare(
        f"config2_N{C2_LOCATIONS}_B{C2_SLOTS[0]}xL{C2_SLOTS[1]}", t, i, n,
        pad, True)
    del t, i, n
    torch.cuda.empty_cache()
    # edge cases: B 1007, rows 0..L valid, a one-word table, rows with
    # nothing valid, lengths that are no multiple of a 16-byte vector,
    # one row
    for name, N, B, L, dtype, full in (
            ("B1007", 1 << 16, 1007, 256, torch.int64, False),
            ("L257_i32", 1 << 16, 300, 257, torch.int32, False),
            ("L257_i64", 1 << 16, 300, 257, torch.int64, False),
            ("L3_i32_full", 1 << 10, 77, 3, torch.int32, True),
            ("one_row", 1 << 10, 1, 1000, torch.int64, True),
            ("one_word_table", 1, 64, 7, torch.int32, True),
            ("one_word_table_partial", 1, 33, 5, torch.int64, False)):
        compare(name, *case(N, B, L, dtype, full))
    t, i, n, pad = case(1000, 300, 64, torch.int64, False)
    compare("nothing_valid", t, i, torch.zeros_like(n), -7)
    say("gather", edge_cases="ok")
    return results


def random_shards(rng, P, n_keys, max_bucket=8, pairs=64):
    """P random CSR shard tables: keys from a space of 2 n_keys (many
    shared) and one at the top u32 value, buckets of 1..max_bucket
    (target, window) pairs from a space of `pairs` shared by the shards
    (equal triples: the tie rule), sorted within each bucket."""
    import numpy as np
    from metacache_tpu_torch.db.feature_table import FeatureTable
    out = []
    for _ in range(P):
        keys = np.unique(rng.integers(0, 2 * n_keys, n_keys)).astype(
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


def phase_merge_kernels(dev):
    """The shard merge streamed to the card (both merge kernels) against
    the same merge on the CPU (their plain versions), table for table, on
    random tables of 2, 3 and 4 shards with ties, in many chunks.
    -> the number of differing elements (0)."""
    import numpy as np
    import torch
    from metacache_tpu_torch.query import upload
    rng = np.random.default_rng(2026)
    for P, n_keys, cap in ((2, 50_000, 1 << 24), (3, 50_000, 20_000),
                           (4, 20_000, 1_000)):
        tables = random_shards(rng, P, n_keys)
        chunk, upload.CHUNK = upload.CHUNK, cap
        try:
            with upload.Stager(dev) as stager:
                got = upload.merged_feature_tables(stager, tables)
            want = upload.merged_feature_tables(
                upload.Stager(torch.device("cpu")), tables)
        finally:
            upload.CHUNK = chunk
        err = sum(int((got[k].cpu() != want[k]).sum()) for k in want)
        check(err == 0 and all(got[k].shape == want[k].shape for k in want),
              f"merged tables differ from the plain merge (P={P})")
    say("merge_kernels", edge_cases="ok", shards="2,3,4")
    return 0


def classify_seconds(path):
    """The query's own '# time:' line: classification without DB load."""
    with open(path) as f:
        for ln in f:
            if ln.startswith("# time:"):
                return float(ln.split()[2]) / 1000.0
    raise SmokeFailure(f"no '# time:' line in {path}")


def compare_cpu(db, reads, flags, limit, gpu_out, tag):
    """The first `limit` reads queried with -device cpu in a process of
    its own: their lines equal the card's. Prints that query's set-up
    seconds (on the CPU a fused database's shards merge through the merge
    kernel's plain version, inside `table upload`)."""
    cpu_out = os.path.join(WORK, f"{tag}_cpu.txt")
    log = os.path.join(WORK, f"{tag}_cpu.log")
    wall = port_cli(["query", db] + reads + flags + ["-device", "cpu",
                     "-query-limit", str(limit), "-out", cpu_out], log)
    with open(log) as f:
        err = f.read()
    say(tag, cpu_query_wall_seconds=f"{wall:.2f}",
        cpu_database_load_seconds=setup_seconds(err, "database load"),
        cpu_table_upload_seconds=setup_seconds(err, "table upload"))
    cpu = mapping_lines(cpu_out)
    gpu = mapping_lines(gpu_out)[:limit]
    check(len(cpu) == limit, f"{tag}: CPU run wrote {len(cpu)} lines")
    diff = sum(a != b for a, b in zip(cpu, gpu))
    check(diff == 0, f"{tag}: {diff} of {limit} mapping lines differ "
                     "between -device cuda and -device cpu")
    say(tag, cpu_vs_gpu_lines_equal=limit)


def classified_fraction(lines):
    return sum(not ln.rstrip("\n").endswith("--") for ln in lines) \
        / len(lines)


def check_fraction(path, frac, expected=C2_EXPECTED_CLASSIFIED):
    check(abs(frac - expected) <= C2_TOLERANCE,
          f"{path}: classified fraction {frac:.4f} is not within "
          f"{C2_TOLERANCE} of {expected}")


def c2_query(path, db, reads, flags, out):
    """A config-2 query driven through the CLI; returns the mapping lines,
    wall seconds, counts and the device's peak memory."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    _, _, wall, counts = driven(
        path, ("sketch_packed", "gather_rows"),
        ["query", db] + reads + flags + ["-out", out])
    return mapping_lines(out), wall, counts, torch.cuda.max_memory_allocated()


def fail_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("FAIL: ")]


def bad_inputs(c2):
    """The two bad files beside config-2's genomes, and the FAIL lines
    `build` must print for them."""
    summary = os.path.join(c2, "assembly_summary.txt")
    cut = os.path.join(c2, "truncated.fq")
    for path, text in ((summary, ASSEMBLY_SUMMARY), (cut, TRUNCATED_FASTQ)):
        with open(path, "w") as f:
            f.write(text)
    return [summary, cut], [
        f"FAIL: {summary}: file format not recognized: {summary}",
        f"FAIL: {cut}: malformed fastq file - quality header: "]


def phase_config2():
    """Config-2 built on the card (driven here: the window kernel ran)
    from its genomes and two bad files beside them (listed as files, so
    reads.fa and tax/ stay out): both reported, the database the JAX
    package's and, array for array, the -device cpu (native host) build's;
    then every read queried."""
    import bench
    from metacache_tpu_torch.db.database import shard_path
    from metacache_tpu_torch.modes.query import load_shard
    bench.C2 = os.path.join(WORK, "c2")
    t0 = time.time()
    bench.make_config2_world()
    say("config2", world_seconds=f"{time.time() - t0:.1f}")
    c2 = bench.C2
    db = os.path.join(c2, "db")
    bad, want_fails = bad_inputs(c2)
    inputs = [os.path.join(c2, "genomes.fa")] + bad \
        + ["-taxonomy", os.path.join(c2, "tax")]
    stdout, _, build_s, built = driven("config2_build", ("sketch_windows",),
                                       ["build", db] + inputs)
    fails = fail_lines(stdout)
    check(fails == want_fails, f"config-2 build: FAIL lines {fails}")
    db_cpu = os.path.join(c2, "db_cpu")
    cpu_log = os.path.join(WORK, "c2_build_cpu.log")
    cpu_s = port_cli(["build", db_cpu] + inputs + ["-device", "cpu"], cpu_log)
    with open(cpu_log) as f:
        check(fail_lines(f.read()) == want_fails,
              "config-2 -device cpu build: FAIL lines")
    differ = differing_arrays(shard_path(db, 0), shard_path(db_cpu, 0))
    os.remove(shard_path(db_cpu, 0))
    say("config2", build_seconds=f"{build_s:.2f}",
        build_cpu_seconds=f"{cpu_s:.2f}",
        arrays_equal_cpu_build="yes" if not differ else ",".join(differ),
        sketch_windows_launches=built["sketch_windows"])
    check(not differ, f"config-2: arrays {differ} of the card build differ "
                      "from the -device cpu build's")
    shard = load_shard(db, 0)
    size = database_size(shard)
    targets = len(shard.target_taxon_node)
    del shard
    say("config2", fail_lines=len(fails), targets=targets, **size)
    check(targets == bench.C2_GENOMES, f"config-2: {targets} targets")
    if all(getattr(bench, k) == v for k, v in C2_WORLD.items()):
        check(size == C2_EXPECTED, f"config-2: database {size}, the JAX "
                                   f"package's is {C2_EXPECTED}")
    reads = [os.path.join(c2, "reads.fa")]
    flags = ["-lowest", "species"] + PIPELINE_FLAGS
    out = os.path.join(WORK, "c2_gpu.txt")
    lines, wall, counts, peak = c2_query("config2", db, reads, flags, out)
    n = len(lines)
    check(n == bench.C2_READS, f"config-2: {n} mapping lines")
    frac = classified_fraction(lines)
    qs = classify_seconds(out)
    say("config2", reads=n,
        query_wall_seconds=f"{wall:.2f}", reads_per_s_wall=f"{n / wall:.1f}",
        classify_seconds=f"{qs:.3f}", reads_per_s_classify=f"{n / qs:.1f}",
        classified_frac=f"{frac:.4f}", peak_device_bytes=peak,
        sketch_launches=counts["sketch_packed"],
        gather_launches=counts["gather_rows"])
    check_fraction("config-2", frac)
    compare_cpu(db, reads, flags, CPU_LINES, out, "config2")
    return dict(db=db, reads=reads, flags=flags, out=out, dir=c2)


def phase_realistic():
    import bench
    bench.BIG = os.path.join(WORK, "realistic")
    t0 = time.time()
    bench.make_realistic_world()
    say("realistic", world_seconds=f"{time.time() - t0:.1f}")
    big = bench.BIG
    db = os.path.join(big, "db")
    build_s = build_cli(["build", db, os.path.join(big, "genomes.fa"),
                         "-taxonomy", os.path.join(big, "tax")],
                        os.path.join(WORK, "realistic_build.log"))
    reads = [os.path.join(big, "reads_1.fa"), os.path.join(big, "reads_2.fa")]
    flags = ["-pairfiles", "-lowest", "species"] + PIPELINE_FLAGS
    out = os.path.join(WORK, "realistic_gpu.txt")
    lines, wall, counts, peak = c2_query("realistic", db, reads, flags, out)
    n = len(lines)
    check(n == bench.BIG_PAIRS, f"realistic: {n} mapping lines")
    qs = classify_seconds(out)
    say("realistic", pairs=n, build_seconds=f"{build_s:.2f}",
        query_wall_seconds=f"{wall:.2f}", pairs_per_s_wall=f"{n / wall:.1f}",
        classify_seconds=f"{qs:.3f}", pairs_per_s_classify=f"{n / qs:.1f}",
        peak_device_bytes=peak, sketch_launches=counts["sketch_packed"],
        gather_launches=counts["gather_rows"])
    compare_cpu(db, reads, flags, 8192, out, "realistic")
    return dict(dir=big, reads=reads, flags=flags, out=out)


def phase_evaluation(c2):
    """-exclude species -precision over the first EVAL_READS reads: a
    read's own genome is genome gi of its header r<i>_NC_<gi>.1, whose
    species is Species{gi} (bench.py); no read may be classified as it."""
    flags = ["-exclude", "species", "-precision", "-lowest", "species"] \
        + PIPELINE_FLAGS
    out = os.path.join(WORK, "c2_exclude_gpu.txt")
    lines, wall, counts, _ = c2_query(
        "evaluation", c2["db"], c2["reads"],
        flags + ["-query-limit", str(EVAL_READS)], out)
    check(len(lines) == EVAL_READS, f"evaluation: {len(lines)} mapping lines")
    own = 0
    for ln in lines:
        cols = ln.rstrip("\n").split("\t|\t")
        gi = int(cols[0].split("_NC_")[1].split(".")[0])
        own += cols[-1].split(":")[-1] == f"Species{gi}"
    check(own == 0, f"evaluation: {own} reads classified as their own "
                    "(excluded) species")
    say("evaluation", reads=len(lines), query_wall_seconds=f"{wall:.2f}",
        classify_seconds=f"{classify_seconds(out):.3f}",
        classified_frac=f"{classified_fraction(lines):.4f}",
        own_species_lines=own, sketch_launches=counts["sketch_packed"],
        gather_launches=counts["gather_rows"])
    compare_cpu(c2["db"], c2["reads"], flags, CPU_LINES, out, "evaluation")


def gpu_equals_cpu(path, c2, flags, limit):
    """One option set on the first `limit` reads: -device cuda (driven
    here) and -device cpu (its own process) write the same bytes, apart
    from '# time:' / '# speed:'."""
    tail = ["-query-limit", str(limit)]
    gpu_out = os.path.join(WORK, f"{path}_gpu.txt")
    cpu_out = os.path.join(WORK, f"{path}_cpu.txt")
    _, _, wall, counts = driven(
        path, ("sketch_packed", "gather_rows"),
        ["query", c2["db"]] + c2["reads"] + flags + tail + ["-out", gpu_out])
    cpu_s = port_cli(["query", c2["db"]] + c2["reads"] + flags + tail
                     + ["-device", "cpu", "-out", cpu_out],
                     os.path.join(WORK, f"{path}_cpu.log"))
    gpu, cpu = result_lines(gpu_out), result_lines(cpu_out)
    check(len(mapping_lines(gpu_out)) >= limit,
          f"{path}: {len(mapping_lines(gpu_out))} lines")
    diff = sum(a != b for a, b in zip(gpu, cpu)) + abs(len(gpu) - len(cpu))
    check(diff == 0, f"{path}: {diff} lines differ between -device cuda "
                     "and -device cpu")
    say(path, reads=limit, lines_equal=len(gpu),
        gpu_wall_seconds=f"{wall:.2f}", cpu_wall_seconds=f"{cpu_s:.2f}",
        sketch_launches=counts["sketch_packed"],
        gather_launches=counts["gather_rows"])
    return gpu


def phase_options(c2):
    hps = gpu_equals_cpu("hits_per_seq", c2, ["-hits-per-seq", "-tophits",
                                              "-lowest", "species"]
                         + PIPELINE_FLAGS, CPU_LINES)
    check(any("list of hits for each reference" in ln for ln in hps),
          "hits_per_seq: no hits-per-target list")
    aln = gpu_equals_cpu("align", c2, ["-align"] + PIPELINE_FLAGS,
                         ALIGN_READS)
    check(any("aligned to" in ln for ln in aln), "align: no alignment")
    # the evaluation summaries: hits per target, per-rank precision and
    # taxon coverage, both abundance tables
    summ = gpu_equals_cpu("summaries", c2, SUMMARY_FLAGS + PIPELINE_FLAGS,
                          CPU_LINES)
    for block in SUMMARY_BLOCKS:
        check(any(ln.startswith(block) for ln in summ),
              f"summaries: no '{block}'")
    hits = summ.index(SUMMARY_BLOCKS[0] + "\n") + 3
    check(not summ[hits].startswith("#"), "summaries: no hits per target")


def npz_arrays(path):
    import numpy as np
    with np.load(path, allow_pickle=True) as z:   # names are objects
        return {k: z[k] for k in z.files}


def differing_arrays(path, other, skip=()):
    """The names of the arrays of two shard files that differ (in type or
    values; a name only one file has counts), those in `skip` aside."""
    import numpy as np
    a, b = npz_arrays(path), npz_arrays(other)
    return sorted(k for k in set(a) | set(b) if k not in skip and not (
        k in a and k in b and a[k].dtype == b[k].dtype
        and np.array_equal(a[k], b[k])))


def split_genomes(c2):
    """genomes.fa (one header and one sequence line per genome) -> the
    first genomes (A) and the last MODIFY_ADDED (B)."""
    src = os.path.join(c2["dir"], "genomes.fa")
    with open(src, "rb") as f:
        lines = f.readlines()
    cut = len(lines) - 2 * MODIFY_ADDED
    paths = [os.path.join(WORK, "genomes_a.fa"),
             os.path.join(WORK, "genomes_b.fa")]
    for path, part in zip(paths, (lines[:cut], lines[cut:])):
        with open(path, "wb") as f:
            f.writelines(part)
    return paths


def phase_modify(c2):
    """Build A natively, add B with `modify` on cuda: every array of the
    result equals the one-shot build's (the two source-file arrays
    excepted, which name genomes_a.fa / genomes_b.fa there), so what
    `modify` sketched equals what the build's window kernel sketched;
    every read is queried against it."""
    from metacache_tpu_torch.db.database import shard_path
    tax = os.path.join(c2["dir"], "tax")
    fa, fb = split_genomes(c2)
    db_a = os.path.join(WORK, "db_a")
    build_s = build_cli(["build", db_a, fa, "-taxonomy", tax],
                        os.path.join(WORK, "db_a_build.log"))
    db_ab = os.path.join(WORK, "db_ab")
    shutil.copyfile(shard_path(db_a, 0), shard_path(db_ab, 0))
    bad = os.path.join(WORK, "modify_malformed.fq")
    with open(bad, "w") as f:
        f.write(MALFORMED_FASTQ)
    stdout, stderr, wall, counts = driven("modify", ("sketch_packed",),
                                          ["modify", db_ab, fb, bad])
    check(f"Added {MODIFY_ADDED} reference sequences." in stdout,
          f"modify: {stdout[-500:]}")
    want_fail = f"FAIL: {bad}: malformed fastq file - quality header: " \
        "ACGTACGTAC"
    check(fail_lines(stderr) == [want_fail],
          f"modify: FAIL lines {fail_lines(stderr)}")
    differ = differing_arrays(shard_path(db_ab, 0), shard_path(c2["db"], 0),
                              MODIFY_SOURCE_ARRAYS)
    say("modify", build_a_seconds=f"{build_s:.2f}",
        modify_gpu_seconds=f"{wall:.2f}",
        fail_lines=len(fail_lines(stderr)),
        arrays_equal_oneshot="yes" if not differ else ",".join(differ),
        sketch_launches=counts["sketch_packed"])
    out = os.path.join(WORK, "c2_modified_gpu.txt")
    lines, wall, counts, _ = c2_query("modified_query", db_ab,
                                      c2["reads"], c2["flags"], out)
    frac = classified_fraction(lines)
    oneshot_lines = mapping_lines(c2["out"])
    same = sum(a == b for a, b in zip(lines, oneshot_lines))
    say("modified_query", reads=len(lines), classified_frac=f"{frac:.4f}",
        lines_equal_oneshot=f"{same}/{len(oneshot_lines)}",
        query_wall_seconds=f"{wall:.2f}",
        sketch_launches=counts["sketch_packed"],
        gather_launches=counts["gather_rows"])
    check(len(lines) == len(oneshot_lines),
          f"modified_query: {len(lines)} mapping lines")
    check_fraction("modified_query", frac)
    check(not differ, f"modify: arrays {differ} differ from the one-shot "
                      "build's")
    check(same == len(oneshot_lines), "modified_query: mapping lines "
                                      "differ from the one-shot build's")
    return db_a, fb


def phase_merge(c2, db_a, fb):
    """Query the first MERGE_READS reads against A and against a native
    build of B, merge the two result files on cuda and on cpu."""
    tax = os.path.join(c2["dir"], "tax")
    db_b = os.path.join(WORK, "db_b")
    build_cli(["build", db_b, fb, "-taxonomy", tax],
              os.path.join(WORK, "db_b_build.log"))
    flags = ["-tophits", "-queryids", "-lowest", "species",
             "-query-limit", str(MERGE_READS)] + PIPELINE_FLAGS
    parts = []
    for name, db in (("a", db_a), ("b", db_b)):
        parts.append(os.path.join(WORK, f"merge_part_{name}.txt"))
        driven(f"merge_query_{name}", ("sketch_packed", "gather_rows"),
               ["query", db] + c2["reads"] + flags + ["-out", parts[-1]])
    merged = {dev: os.path.join(WORK, f"merged_{dev}.txt")
              for dev in ("cuda", "cpu")}
    _, _, wall, _ = driven("merge", (), ["merge"] + parts
                           + ["-taxonomy", tax, "-out", merged["cuda"]])
    cpu_s = port_cli(["merge"] + parts + ["-taxonomy", tax, "-device", "cpu",
                                          "-out", merged["cpu"]],
                     os.path.join(WORK, "merge_cpu.log"))
    gpu, cpu = result_lines(merged["cuda"]), result_lines(merged["cpu"])
    check(gpu == cpu, "merge: -device cuda and -device cpu differ")
    lines = mapping_lines(merged["cuda"])
    check(len(lines) == MERGE_READS, f"merge: {len(lines)} merged lines")
    oneshot = mapping_lines(c2["out"])[:MERGE_READS]
    agree = sum(a == b for a, b in zip(lines, oneshot))
    say("merge", reads=len(lines), cuda_equals_cpu="yes",
        merge_gpu_seconds=f"{wall:.2f}", merge_cpu_seconds=f"{cpu_s:.2f}",
        lines_agree_with_oneshot=f"{agree}/{len(oneshot)}")


def phase_interactive(c2):
    """Two stdin lines; the second changes only -hitmin."""
    line = " ".join(c2["reads"] + c2["flags"]
                    + ["-query-limit", str(INTERACTIVE_READS)])
    outs = [os.path.join(WORK, f"interactive_{i}.txt") for i in (1, 2)]
    stdin = (f"{line} -out {outs[0]}\n"
             f"{line} -hitmin 6 -out {outs[1]}\n")
    _, err, wall, counts = driven(
        "interactive", ("sketch_packed", "gather_rows"),
        ["query", c2["db"]], stdin=stdin)
    check(err.count("(reusing loaded engine)") == 1,
          f"interactive: the engine was not reused: {err[-500:]}")
    first = mapping_lines(outs[0])
    want = mapping_lines(c2["out"])[:INTERACTIVE_READS]
    check(first == want, "interactive: the first line's output differs "
                         "from the non-interactive run's")
    say("interactive", lines=2, reads_per_line=INTERACTIVE_READS,
        first_equals_noninteractive="yes", engine_reused="yes",
        wall_seconds=f"{wall:.2f}", sketch_launches=counts["sketch_packed"],
        gather_launches=counts["gather_rows"])


def phase_info(c2):
    for what in ([], ["rank", "species"]):
        out, _, wall, _ = driven("info", (), ["info", c2["db"]] + what)
        check(len(out.splitlines()) > 2, f"info {what}: {out[-500:]}")
        say("info", what="_".join(what) or "statistics",
            lines=len(out.splitlines()), wall_seconds=f"{wall:.2f}")


def placement(stderr):
    """The -mesh placement line the query prints on stderr."""
    lines = [ln for ln in stderr.splitlines() if ln.startswith("-mesh: ")]
    check(len(lines) == 1 and "falling back" not in lines[0],
          f"-mesh did not place its shards: {stderr[-1000:]}")
    return lines[0][len("-mesh: "):].replace(", ", ";").replace(" ", "_")


def mesh_query(path, db, data, out):
    """A -mesh query driven through the CLI -> (mapping lines, wall
    seconds, counts, peak device bytes, placement)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    _, err, wall, counts = driven(
        path, ("sketch_packed", "gather_rows"),
        ["query", db] + data["reads"] + data["flags"] + ["-mesh", "-out",
                                                         out])
    return (mapping_lines(out), wall, counts,
            torch.cuda.max_memory_allocated(), placement(err))


def phase_mesh(c2):
    """Config-2 in MESH_SHARDS shards, every read queried with -mesh:
    the shards on the card(s), sketched once per card, merged; the lines
    equal the fused query's (config-2 never truncates a match list)."""
    db = os.path.join(c2["dir"], f"db{MESH_SHARDS}")
    build_s = build_cli(["build", db, os.path.join(c2["dir"], "genomes.fa"),
                         "-taxonomy", os.path.join(c2["dir"], "tax"),
                         "-num-shards", str(MESH_SHARDS)],
                       os.path.join(WORK, "mesh_build.log"))
    out = os.path.join(WORK, "c2_mesh_gpu.txt")
    lines, wall, counts, peak, where = mesh_query("mesh", db, c2, out)
    fused = mapping_lines(c2["out"])
    same = sum(a == b for a, b in zip(lines, fused))
    frac = classified_fraction(lines)
    qs = classify_seconds(out)
    say("mesh", shards=MESH_SHARDS, reads=len(lines),
        build_seconds=f"{build_s:.2f}", query_wall_seconds=f"{wall:.2f}",
        classify_seconds=f"{qs:.3f}",
        reads_per_s_classify=f"{len(lines) / qs:.1f}",
        classified_frac=f"{frac:.4f}",
        lines_equal_fused=f"{same}/{len(fused)}", peak_device_bytes=peak,
        placement=where, sketch_launches=counts["sketch_packed"],
        gather_launches=counts["gather_rows"])
    check(len(lines) == len(fused) and same == len(fused),
          "mesh: mapping lines differ from the fused query's")
    check_fraction("mesh", frac)
    return db


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(tag, args):
    """The port's CLI as ranks 0 and 1 of one process group (the MC_*
    launch), each through this script's rank worker. Both are killed and
    the phase fails past RANK_TIMEOUT seconds or on a non-zero exit.
    Returns (each rank's kernel launch counts, wall seconds, backend)."""
    import torch
    port = free_port()
    procs, logs = [], []
    t0 = time.time()
    try:
        for r in range(2):
            env = dict(os.environ, MC_COORDINATOR=f"127.0.0.1:{port}",
                       MC_NUM_PROCS="2", MC_PROC_ID=str(r))
            logs.append(open(os.path.join(WORK, f"{tag}_rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker",
                 os.path.join(WORK, f"{tag}_rank{r}.json")] + args
                + ["-device", DEVICE], cwd=REPO, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, t0 + RANK_TIMEOUT - time.time()))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{tag}: rank {r} exceeded {RANK_TIMEOUT} "
                                   "s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.time() - t0
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"{tag}: rank {r} exited {p.returncode}, "
                                 f"see {tag}_rank{r}.log")
    counts = []
    for r in range(2):
        with open(os.path.join(WORK, f"{tag}_rank{r}.json")) as f:
            counts.append(json.load(f))
    with open(os.path.join(WORK, f"{tag}_rank0.log")) as f:
        backend = [ln.split("backend ")[1].split()[0] for ln in f
                   if ln.startswith("[distributed]")]
    # nccl with a card per rank, gloo where the two ranks share one card
    want = "nccl" if DEVICE == "cuda" and torch.cuda.device_count() >= 2 \
        else "gloo"
    check(backend == [want], f"{tag}: backend {backend}, expected {want}")
    return counts, wall, backend[0]


def rank_worker(counts_path, args):
    """The CLI in this process (one rank of launch_ranks), then its kernel
    launch counts and its peak host RSS in MB (utils/memory.py) to
    counts_path."""
    sys.path.insert(0, REPO)
    from metacache_tpu_torch import cli
    from metacache_tpu_torch.utils.memory import vm_peak_mb
    reset_launches()
    rc = cli.main(args)
    with open(counts_path, "w") as f:
        json.dump(dict(read_launches(), peak_rss_mb=vm_peak_mb()), f)
    return rc


def split_build(tag, args):
    """`build` in a process of its own through scripts/build_split.py's
    worker: the CLI with its steps timed, its threads and host RSS
    sampled and each kernel's launch count set to 0 before it -> (wall
    seconds, the worker's record)."""
    path = os.path.join(WORK, f"{tag}.json")
    t0 = time.time()
    with open(os.path.join(WORK, f"{tag}.log"), "w") as log:
        r = subprocess.run([sys.executable,
                            os.path.join(REPO, "scripts", "build_split.py"),
                            "--worker", path, REPO, repr(t0)] + args
                           + ["-device", DEVICE], cwd=REPO, stdout=log,
                           stderr=subprocess.STDOUT, timeout=900)
    wall = time.time() - t0
    check(r.returncode == 0, f"{' '.join(args[:2])} failed, see {tag}.log")
    with open(path) as f:
        return wall, json.load(f)


def phase_distributed(c2, mesh_db):
    """Two ranks, over gloo on one card (nccl with a card each where there
    are two or more): (a) build the MESH_SHARDS shards, rank r writing
    s % 2 == r, equal to the single-process build's; (b) query -mesh,
    rank 0's lines equal the fused query's."""
    from metacache_tpu_torch.db.database import shard_path
    db = os.path.join(c2["dir"], "dist_db")
    built, build_s, backend = launch_ranks("dist_build", [
        "build", db, os.path.join(c2["dir"], "genomes.fa"), "-taxonomy",
        os.path.join(c2["dir"], "tax"), "-num-shards", str(MESH_SHARDS)])
    for r, cnt in enumerate(built):
        LAUNCHES["sketch_windows"] += cnt["sketch_windows"]
        check_launched(f"distributed build rank {r}", "sketch_windows",
                       cnt["sketch_windows"])
    for s in range(MESH_SHARDS):
        differ = differing_arrays(shard_path(db, s), shard_path(mesh_db, s))
        check(not differ, f"distributed: shard {s} arrays {differ} differ "
                          "from the single-process build's")
    out = os.path.join(WORK, "c2_dist_gpu.txt")
    counts, query_s, _ = launch_ranks("dist_query", [
        "query", db] + c2["reads"] + c2["flags"] + [
        "-mesh", "-query-limit", str(DIST_READS), "-out", out])
    for r, cnt in enumerate(counts):
        for name in ("sketch_packed", "gather_rows"):
            LAUNCHES[name] += cnt[name]
            check_launched(f"distributed rank {r}", name, cnt[name])
    lines = mapping_lines(out)
    same = sum(a == b for a, b in zip(lines, mapping_lines(c2["out"])))
    say("distributed", ranks=2, backend=backend, shards=MESH_SHARDS,
        build_wall_seconds=f"{build_s:.2f}", shards_equal_single="yes",
        query_wall_seconds=f"{query_s:.2f}", reads=len(lines),
        classify_seconds=f"{classify_seconds(out):.3f}",
        lines_equal_fused=f"{same}/{DIST_READS}",
        sketch_launches="/".join(str(c["sketch_packed"]) for c in counts),
        gather_launches="/".join(str(c["gather_rows"]) for c in counts))
    check(len(lines) == DIST_READS and same == DIST_READS,
          "distributed: rank 0's lines differ from the fused query's")


def phase_realistic_mesh(big):
    """The realistic world in 2 shards, queried with -mesh; cuda equals
    cpu on the first 8,192 pairs. Each shard truncates its own match
    list, so lines may differ from the fused query's on the reads that
    overflow: that count is printed, not checked."""
    db = os.path.join(big["dir"], "db2")
    build_s = build_cli(["build", db,
                         os.path.join(big["dir"], "genomes.fa"),
                         "-taxonomy", os.path.join(big["dir"], "tax"),
                         "-num-shards", "2"],
                        os.path.join(WORK, "realistic_mesh_build.log"))
    out = os.path.join(WORK, "realistic_mesh_gpu.txt")
    lines, wall, counts, peak, where = mesh_query("realistic_mesh", db, big,
                                                  out)
    fused = mapping_lines(big["out"])
    check(len(lines) == len(fused),
          f"realistic_mesh: {len(lines)} mapping lines")
    differ = sum(a != b for a, b in zip(lines, fused))
    qs = classify_seconds(out)
    say("realistic_mesh", pairs=len(lines), build_seconds=f"{build_s:.2f}",
        query_wall_seconds=f"{wall:.2f}", classify_seconds=f"{qs:.3f}",
        pairs_per_s_classify=f"{len(lines) / qs:.1f}",
        lines_differing_from_fused=differ, peak_device_bytes=peak,
        placement=where, sketch_launches=counts["sketch_packed"],
        gather_launches=counts["gather_rows"])
    compare_cpu(db, big["reads"], big["flags"] + ["-mesh"], 8192, out,
                "realistic_mesh")


@contextlib.contextmanager
def spying(module, name, spy):
    """module.name replaced by spy(module.name) for the duration: the
    port's own function still runs, the spy only watches it."""
    orig = getattr(module, name)
    setattr(module, name, spy(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def c3_pairs():
    """The pairs bench.make_config3_world writes: C3_PAIRS // genomes
    for each genome (1,048,400 of the nominal 1,048,576 uncut)."""
    import bench
    genomes = bench.C3_BASES * bench.C3_VARIANTS
    return bench.C3_PAIRS // genomes * genomes


def c3_world_is_full():
    """True when bench.py's config-3 world is generated as bench.py
    defines it, the world the JAX package's numbers belong to."""
    import bench
    return all(getattr(bench, k) == v for k, v in C3_WORLD.items())


def setup_seconds(stderr, what):
    """The seconds of a set-up step as the query prints them on stderr
    (`# <what> seconds: <s>`, modes/query.py's setup_span)."""
    tag = f"# {what} seconds: "
    spans = [float(ln[len(tag):]) for ln in stderr.splitlines()
             if ln.startswith(tag)]
    check(len(spans) == 1, f"the query printed {len(spans)} '{tag}' lines")
    return spans[0]


def database_size(db):
    """features, locations and the largest bucket of a loaded database."""
    features = db.features
    return dict(features=features.num_keys,
                locations=features.num_locations,
                max_bucket=int(features.bucket_sizes().max()))


def device_tables_size(tables):
    """The same numbers, from an engine's device tables."""
    offsets = tables["offsets"]
    return dict(features=tables["keys"].numel(),
                locations=tables["locations"].numel(),
                max_bucket=int((offsets[1:] - offsets[:-1]).max()))


def overflow_count(stderr):
    """Reads whose match list was cut at -max-locations-per-query, from
    the query's stderr warning (0 without one)."""
    for ln in stderr.splitlines():
        if ln.startswith("WARNING: match-list overflow on "):
            return int(ln.split()[4])
    return 0


def phase_config3():
    """bench.py's config-3 world (200 targets x 25 Mbp in 4-strain
    groups, a 5 kbp transposon 5 times per genome, 1,048,400 pairs),
    built in C3_SHARDS shards by the port's CLI and queried fused on the
    card, the shards merged there as they stream up. Checks that no host
    merge was made, the fused tables' size and the classified fraction
    against the JAX package's numbers for the same seeded world (the
    fraction as bench.measure_config3 computes it: classified pairs over
    the nominal C3_PAIRS), that every pair has its line, that the sketch
    and gather kernels ran once per batch (the sketch per mate) and both
    merge kernels once per planned chunk, and the first C3_CPU_PAIRS
    pairs against -device cpu. Times the gather kernel on one real batch
    of this query and the merge kernels on its first chunk."""
    import bench
    import torch
    from metacache_tpu_torch.modes import query as query_mode
    from metacache_tpu_torch.ops import lookup
    from metacache_tpu_torch.query import upload
    bench.C3 = os.path.join(WORK, "c3")
    t0 = time.time()
    bench.make_config3_world()
    say("config3", world_seconds=f"{time.time() - t0:.1f}")
    c3 = bench.C3
    db = os.path.join(c3, "db")
    gbp = bench.C3_BASES * bench.C3_VARIANTS * bench.C3_GLEN / 1e9
    genomes = os.path.join(c3, "genomes.fa")
    build_s, built = split_build("c3_build", [
        "build", db, genomes, "-taxonomy", os.path.join(c3, "tax"),
        "-num-shards", str(C3_SHARDS)])
    series = built["series"]
    say("config3", gbp=gbp, build_seconds=f"{build_s:.2f}",
        build_gbp_per_s=f"{gbp / build_s:.5f}",
        build_peak_rss_mb=f"{built['peak_host_rss_mb']:.1f}",
        build_peak_rss_at_s=f"{built['peak_host_rss_at_s']:.3f}",
        build_start_s=f"{built['start_s']:.3f}",
        build_cli_s=f"{built['cli_s']:.3f}",
        build_exit_s=f"{build_s - built['start_s'] - built['cli_s']:.3f}",
        **{f"build_{k}_s": f"{v['total_s']:.3f}/{v['n']}"
           for k, v in series.items()},
        disk_free_gb=f"{shutil.disk_usage(WORK).free / 1e9:.1f}")
    windows = built["launches"]["sketch_cuda.window_launches"]
    LAUNCHES["sketch_windows"] += windows
    check_launched("config3 build", "sketch_windows", windows)
    host = [k for k in ("sketch_pass", "host_sort", "merge_chunks", "spill")
            if k in series]
    check(DEVICE != "cuda" or not host,
          f"config-3 build: {host} ran on the host (no shard should leave "
          "the card)")

    reads = [os.path.join(c3, "reads_1.fa"), os.path.join(c3, "reads_2.fa")]
    flags = ["-pairfiles", "-lowest", "species"] + PIPELINE_FLAGS
    out = os.path.join(WORK, "c3_gpu.txt")
    batch, opened, plans, fused = {}, [], [], []

    def watch(seen):     # what the query opened, planned and merged
        def spy(fn):
            def run(*args):
                seen.append(fn(*args))
                return seen[-1]
            return run
        return spy

    def capture(fn):     # the first batch's gather inputs
        def gather(table, idx, n_valid, pad):
            if not batch:
                batch.update(table=table, idx=idx.clone(),
                             n_valid=n_valid.clone(), pad=pad)
            return fn(table, idx, n_valid, pad)
        return gather

    torch.cuda.reset_peak_memory_stats()
    with spying(query_mode, "open_all_shards", watch(opened)), \
            spying(upload, "plan_chunks", watch(plans)), \
            spying(upload, "merged_feature_tables", watch(fused)), \
            spying(lookup, "gather_rows", capture):
        _, err, wall, counts = driven(
            "config3", (), ["query", db] + reads + flags + ["-out", out])
    peak = torch.cuda.max_memory_allocated()
    check(len(opened) == 1 and len(fused) == 1 and len(plans) == 1,
          f"config-3: {len(opened)} databases opened, {len(fused)} merged "
          "on the card")
    shards = opened.pop()
    check(not shards.merged_on_host,
          "config-3: the fused query merged the shards on the host")
    size = device_tables_size(fused.pop())
    lines = mapping_lines(out)
    n = len(lines)
    frac = classified_fraction(lines)
    frac_bench = frac * n / bench.C3_PAIRS
    qs = classify_seconds(out)
    batches = -(-c3_pairs() // BATCH_SIZE)
    chunks = len(plans[0])
    say("config3", pairs=n, **size, query_wall_seconds=f"{wall:.2f}",
        database_load_seconds=setup_seconds(err, "database load"),
        table_upload_seconds=setup_seconds(err, "table upload"),
        classify_seconds=f"{qs:.3f}", pairs_per_s_classify=f"{n / qs:.1f}",
        pairs_per_s_wall=f"{n / wall:.1f}", classified_frac=f"{frac:.4f}",
        classified_frac_of_c3_pairs=f"{frac_bench:.4f}",
        overflow_reads=overflow_count(err), peak_device_bytes=peak,
        merge_chunks=chunks, **{f"{k}_launches": v
                                for k, v in counts.items()})
    check(n == c3_pairs(), f"config-3: {n} mapping lines, expected "
                           f"{c3_pairs()}")
    for name, want in (("sketch_packed", 2 * batches),
                       ("gather_rows", batches), ("merge_shards", chunks),
                       ("merge_count", chunks)):
        LAUNCHES[name] += counts[name]
        check_launched("config3", name, counts[name], want)
    if c3_world_is_full():
        check(size == C3_EXPECTED, f"config-3: database {size}, expected "
                                   f"{C3_EXPECTED}")
        check_fraction("config-3", frac_bench, C3_EXPECTED_CLASSIFIED)
    else:
        say("config3", world="cut", unchecked="size,classified_frac")
    compare_cpu(db, reads, flags, min(C3_CPU_PAIRS, n), out, "config3")
    check(bool(batch), "config-3: the lookup gathered nothing")
    gather = gather_at(batch)
    batch.clear()
    merge = merge_at(shards.shard_features(), plans[0][0])
    return dict(db=db, dir=c3, reads=reads, flags=flags, out=out,
                gather=gather, merge=merge, windows=windows_at(genomes))


def window_batch(genomes, shard=0):
    """The card build's first batch of `genomes` (native.RecordStream into
    a buffer of db/build.py's BATCH_BYTES), cut to the records of `shard`
    as CardBuild.add_batch cuts it: (seq, rec_off, rec_len, win_off)."""
    import numpy as np
    from metacache_tpu_torch import native
    from metacache_tpu_torch.config import SketchParams
    from metacache_tpu_torch.db import build as build_mod
    p = SketchParams()
    stream = native.RecordStream(genomes)
    buf = np.empty(build_mod.BATCH_BYTES, np.uint8)
    while True:
        try:
            batch = stream.next_batch(buf)
            break
        except native.RecordTooLarge as e:
            buf = np.empty(e.need, np.uint8)
    stream.close()
    mine = np.arange(len(batch.lens)) % C3_SHARDS == shard
    nwin = build_mod._num_windows(batch.lens[mine], p.window_size,
                                  p.window_stride)
    win_off = np.zeros(len(nwin) + 1, np.int64)
    np.cumsum(nwin, out=win_off[1:])
    return (buf[:batch.nbytes], batch.offsets[mine], batch.lens[mine],
            win_off)


def window_bound(seq, rec_off, rec_len, win_off, out, k, W, stride):
    """The window sketch's bound on these inputs: the records' bytes and
    the small arrays read once, the sketches written once; its operations
    counted as sketch_bound counts them (every k-mer start of a window,
    every valid k-mer, from the data: a start is valid when none of the
    k characters from it is ambiguous)."""
    import numpy as np
    from metacache_tpu_torch.ops.encode import AMBIG_CODE, CHAR_LUT
    amb = np.zeros(len(seq) + 1, np.int64)
    np.cumsum(CHAR_LUT[seq] == AMBIG_CODE, out=amb[1:])
    ok = np.zeros(len(seq) + 1, np.int64)   # valid k-mer starts before i
    np.cumsum(amb[k:] == amb[:-k], out=ok[1:len(seq) - k + 2])
    ok[len(seq) - k + 2:] = ok[len(seq) - k + 1]
    rec = np.repeat(np.arange(len(rec_len)), np.diff(win_off))
    start = (np.arange(win_off[-1]) - win_off[:-1][rec]) * stride
    wlen = np.minimum(rec_len[rec] - start, W)
    first = rec_off[rec] + start
    n = np.maximum(wlen - k + 1, 0)
    kmers = int((ok[first + n] - ok[first]).sum())
    nbytes = int(rec_len.sum()) + 8 * (2 * len(rec_len) + len(win_off)) \
        + out.numel() * out.element_size()
    per_kmer = SKETCH_OPS_PER_KMER + (SKETCH_OPS_SHORT_K if k < 16 else 0)
    return bound(nbytes, SKETCH_OPS_PER_START * int(n.sum())
                 + per_kmer * kmers)


def windows_at(genomes):
    """The window kernel on the config-3 build's first batch (its first
    shard's records, a 25 Mbp genome): bit-equal to its plain version on
    the card, and timed."""
    import torch
    from metacache_tpu_torch.config import SketchParams
    from metacache_tpu_torch.ops import sketch_cuda
    from metacache_tpu_torch.ops.sketch import sketch_windows_reference
    p = SketchParams()
    host = window_batch(genomes)
    args = [torch.from_numpy(x).to(DEVICE) for x in host]
    kw = dict(n_windows=int(host[3][-1]), k=p.kmer_size,
              sketch_size=p.sketch_size, window_size=p.window_size,
              stride=p.window_stride)
    got = sketch_cuda.sketch_windows(*args, **kw)
    want = sketch_windows_reference(*args, **kw)
    err = int((got.long() & 0xFFFFFFFF).sub_(want.long() & 0xFFFFFFFF)
              .abs_().max())
    check(err == 0, "window kernel differs from plain (config-3 batch)")
    name = f"config3_R{len(host[1])}_bases{int(host[2].sum())}" \
        f"_windows{kw['n_windows']}"
    res = timed(f"sketch_windows_{name}",
                lambda: sketch_cuda.sketch_windows(*args, **kw),
                lambda: sketch_windows_reference(*args, **kw), None,
                *window_bound(*host, got, p.kmer_size, p.window_size,
                              p.window_stride))
    return dict(res, err=err, shape=name)


def merge_bound(chunk):
    """The merge's bound on one chunk: its inputs read once (keys, offsets,
    targets, windows, bounds) and its outputs written once (a packed
    location and a key per location)."""
    P = chunk.bounds.shape[1] - 1
    nk = chunk.keys.numel()
    return bound(4 * nk + 8 * (nk + P) + 8 * chunk.nl + 16 * (P + 1)
                 + 12 * chunk.nl, 0)


def merge_at(tables, first):
    """The merge kernels on the first real chunk of the config-3 query,
    staged again from the shard files (so the query ran without a copy
    of it on the card): bit-equal to their plain versions, and timed."""
    import torch
    from metacache_tpu_torch.ops import merge_cuda
    from metacache_tpu_torch.ops.merge import (count_keys_reference,
                                               merge_chunk_reference)
    from metacache_tpu_torch.query import upload
    dev = torch.device(DEVICE)
    with upload.Stager(dev) as stager:
        c = upload._Chunk(stager, tables, *first, locations=True)
        stager.ready()
    args = (c.keys, c.offs, c.tgt, c.win, c.bounds)
    loc = torch.empty(c.nl, dtype=torch.int64, device=dev)
    key = merge_cuda.merge_chunk(*args, loc)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    merge_cuda.count_keys(c.keys, c.bounds, count)
    want_loc, want_key = merge_chunk_reference(*args)
    err = int((loc != want_loc).sum()) + int((key != want_key).sum())
    count_err = abs(int(count) - count_keys_reference(c.keys))
    check(err == 0, f"merge kernel differs from plain in {err} elements "
                    "(config-3 chunk)")
    check(count_err == 0, f"merge count kernel differs from plain by "
                          f"{count_err} (config-3 chunk)")
    P = c.bounds.shape[1] - 1
    name = f"config3_P{P}_NK{c.keys.numel()}_NL{c.nl}"
    res = timed(f"merge_shards_{name}",
                lambda: merge_cuda.merge_chunk(*args, loc),
                lambda: merge_chunk_reference(*args), None,
                *merge_bound(c))
    counted = timed(f"merge_count_{name}",
                    lambda: merge_cuda.count_keys(c.keys, c.bounds, count),
                    lambda: count_keys_reference(c.keys),
                    lambda: torch.unique(c.keys),
                    *bound(4 * c.keys.numel() + 16 * (P + 1) + 8, 0),
                    library_in_graph=False)
    return {"merge_shards": dict(res, err=err, shape=name),
            "merge_count": dict(counted, err=count_err, shape=name)}


def gather_at(batch):
    """The gather kernel timed on one real batch of the config-3 query:
    its location table, slot indices and valid counts, bit-equal to the
    plain version. table[idx] reads every slot, so its idx sends the
    slots past n_valid (which the lookup leaves unclamped) to word 0."""
    import torch
    from metacache_tpu_torch.ops import gather_cuda
    from metacache_tpu_torch.ops.gather import gather_rows_reference
    table, idx, n_valid, pad = (batch[k] for k in ("table", "idx",
                                                   "n_valid", "pad"))
    valid = torch.arange(idx.shape[1], device=idx.device)[None, :] \
        < n_valid[:, None]
    got = gather_cuda.gather_rows(table, idx, n_valid, pad)
    err = int((got != gather_rows_reference(table, idx, n_valid,
                                            pad)).sum())
    check(err == 0, f"gather kernel differs from plain in {err} elements "
                    "(config-3 batch)")
    safe = torch.where(valid, idx, 0)
    name = f"config3_N{table.numel()}_B{idx.shape[0]}xL{idx.shape[1]}"
    say(f"gather_{name}", valid_share=f"{float(valid.float().mean()):.4f}")
    res = timed(f"gather_{name}",
                lambda: gather_cuda.gather_rows(table, idx, n_valid, pad),
                lambda: gather_rows_reference(table, idx, n_valid, pad),
                lambda: table[safe],
                *gather_bound(table, idx[valid], n_valid, got))
    return dict(res, err=err, shape=name)


def phase_config3_mesh(c3):
    """The config-3 shards queried with -mesh on the card(s): every pair
    has its line, both kernels ran, and the first C3_CPU_PAIRS pairs
    equal -device cpu's -mesh run. Each shard cuts its own match list,
    so lines may differ from the fused query's on the transposon reads:
    that count and the classified fraction are printed, not checked.
    The config-3 world and databases are removed afterwards."""
    out = os.path.join(WORK, "c3_mesh_gpu.txt")
    lines, wall, counts, peak, where = mesh_query("config3_mesh", c3["db"],
                                                  c3, out)
    fused = mapping_lines(c3["out"])
    qs = classify_seconds(out)
    say("config3_mesh", shards=C3_SHARDS, pairs=len(lines),
        query_wall_seconds=f"{wall:.2f}", classify_seconds=f"{qs:.3f}",
        pairs_per_s_classify=f"{len(lines) / qs:.1f}",
        classified_frac=f"{classified_fraction(lines):.4f}",
        lines_differing_from_fused=sum(a != b for a, b in zip(lines, fused)),
        peak_device_bytes=peak, placement=where,
        sketch_launches=counts["sketch_packed"],
        gather_launches=counts["gather_rows"])
    check(len(lines) == c3_pairs(),
          f"config3_mesh: {len(lines)} mapping lines")
    compare_cpu(c3["db"], c3["reads"], c3["flags"] + ["-mesh"],
                min(C3_CPU_PAIRS, len(lines)), out, "config3_mesh")
    shutil.rmtree(c3["dir"], ignore_errors=True)


def phase_self_contained():
    """No module of the JAX package in this process, and the native
    library it loaded is the port's own build."""
    from metacache_tpu_torch import native
    from metacache_tpu_torch.ops.cuda_build import BUILD_DIR
    loaded = [m for m, mod in sys.modules.items() if mod is not None]
    jax_pkg = sorted(m for m in loaded if m == "metacache_tpu"
                     or m.startswith("metacache_tpu."))
    check(not jax_pkg, f"self_contained: modules of the JAX package were "
                       f"imported: {jax_pkg[:5]}")
    check("jax" not in loaded, "self_contained: jax was imported")
    path = native.load_mcio()._name
    check(os.path.dirname(path) == BUILD_DIR
          and path == native.library_path(),
          f"self_contained: libmcio was loaded from {path}")
    say("self_contained", jax_package_modules=0,
        libmcio=os.path.relpath(path, REPO))


def timed_phase(name, phase, *args):
    """One phase, its wall seconds printed on a line of its own."""
    t0 = time.time()
    res = phase(*args)
    say(name, phase_seconds=f"{time.time() - t0:.1f}")
    return res


def use_repo_tests_package():
    """bench.py's world generators import `tests.util_mockdata`. Bind the
    name `tests` to this checkout's test directory, even where an
    installed package of that name would shadow it."""
    import types
    pkg = types.ModuleType("tests")
    pkg.__path__ = [os.path.join(REPO, "tests")]
    sys.modules["tests"] = pkg


def kernels_json(sketch, gather, merge, windows):
    cell = sketch["cells"]
    c2 = gather["config2"]
    c3 = gather["config3"]
    rows = [dict(
        name="sketch_packed", route="cuda",
        source="metacache_tpu_torch/csrc/sketch.cu", replaces=PALLAS_SKETCH,
        launches=LAUNCHES["sketch_packed"],
        max_abs_err=max(r["err"] for n, r in sketch.items()
                        if n != "windows_edges"),
        shape=cell["shape"], **{k: cell[k] for k in TIMES})]
    # the build's reference-window sketch: the same per-window function
    # as the TPU kernel, on whole records; timed on the config-3 build's
    # first batch
    rows.append(dict(
        name="sketch_windows", route="cuda",
        source="metacache_tpu_torch/csrc/sketch.cu", replaces=PALLAS_SKETCH,
        launches=LAUNCHES["sketch_windows"],
        max_abs_err=max(windows["err"], sketch["windows_edges"]["err"]),
        shape=windows["shape"], **{k: windows[k] for k in TIMES}))
    # one kernel replaces both probes (k2's row-and-lane layout has no
    # counterpart on Hopper); its times at config-2's lookup shape, at
    # k1's own shape under k1_*, and on a real config-3 batch under
    # config3_*
    for probe, where in PALLAS_GATHERS.items():
        rows.append(dict(
            name="gather_rows", route="cuda",
            source="metacache_tpu_torch/csrc/gather.cu", replaces=where,
            launches=LAUNCHES["gather_rows"],
            max_abs_err=max(r["err"] for r in gather.values()),
            shape=c2["shape"], probe=probe, **{k: c2[k] for k in TIMES},
            **{f"k1_{k}": gather["k1"][k] for k in TIMES},
            config3_shape=c3["shape"],
            **{f"config3_{k}": c3[k] for k in TIMES}))
    # the shard merge (no TPU kernel: the JAX package merges on the host),
    # timed on the first real chunk of the fused config-3 query; its edge
    # cases (3 and 4 shards, ties) count in max_abs_err
    for name in ("merge_shards", "merge_count"):
        res = merge[name]
        rows.append(dict(
            name=name, route="cuda",
            source="metacache_tpu_torch/csrc/merge.cu", replaces=HOST_MERGE,
            launches=LAUNCHES[name], max_abs_err=max(res["err"],
                                                     merge["edges_err"]),
            shape=res["shape"], **{k: res[k] for k in TIMES}))
    return {"kernels": rows}


def kernel_times(root) -> int:
    """Only the kernel phases (build, bit-equality, times), on the port
    found under `root`: the way to time another tree's kernels beside this
    one's in the same call."""
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(root))
    import metacache_tpu_torch
    say("kernel_times", root=os.path.dirname(metacache_tpu_torch.__file__))
    try:
        build_kernels()
        dev = torch.device("cuda")
        phase_kernel(dev)
        phase_gather(dev, yardsticks=True)
        phase_merge_kernels(dev)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    use_repo_tests_package()
    try:
        import bench  # noqa: F401  (the seeded world generators)
        from metacache_tpu_torch.ops import sketch_cuda  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the repository is not beside this script: {e}",
              file=sys.stderr)
        return 1
    os.makedirs(WORK, exist_ok=True)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        check(bool(smi), "nvidia-smi printed nothing")
        print(smi[0], flush=True)
        kind = torch.cuda.get_device_name(0)
        say("device", kind=kind.replace(" ", "_"),
            count=torch.cuda.device_count(), torch=torch.__version__,
            cuda=torch.version.cuda)
        t0 = time.time()
        build_kernels()
        dev = torch.device("cuda")
        sketch = timed_phase("kernel", phase_kernel, dev)
        gather = timed_phase("gather", phase_gather, dev)
        edges_err = timed_phase("merge_kernels", phase_merge_kernels, dev)
        c2 = timed_phase("config2", phase_config2)
        big = timed_phase("realistic", phase_realistic)
        timed_phase("evaluation", phase_evaluation, c2)
        timed_phase("options", phase_options, c2)
        db_a, fb = timed_phase("modify", phase_modify, c2)
        timed_phase("merge", phase_merge, c2, db_a, fb)
        timed_phase("interactive", phase_interactive, c2)
        timed_phase("info", phase_info, c2)
        mesh_db = timed_phase("mesh", phase_mesh, c2)
        timed_phase("distributed", phase_distributed, c2, mesh_db)
        timed_phase("realistic_mesh", phase_realistic_mesh, big)
        c3 = timed_phase("config3", phase_config3)
        gather["config3"] = c3["gather"]
        merge = dict(c3["merge"], edges_err=edges_err)
        timed_phase("config3_mesh", phase_config3_mesh, c3)
        timed_phase("self_contained", phase_self_contained)
        say("done", seconds=f"{time.time() - t0:.1f}")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(kernels_json(sketch, gather, merge, c3["windows"])),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--kernel-times"]:
        sys.exit(kernel_times(sys.argv[2] if len(sys.argv) > 2 else REPO))
    sys.exit(main())
