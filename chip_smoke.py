#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (metacache_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA
     versions. Both kernel libraries are built at once (one nvcc per
     source, in parallel).
  2. kernels vs plain: the CUDA sketch kernel (csrc/sketch.cu) and the
     CUDA gather kernel (csrc/gather.cu) held bit for bit against their
     plain PyTorch versions on the card, at the main paths' shapes and on
     edge cases; both versions timed with CUDA events.
  3. config-2 (BASELINE config-2, the RefSeq-viral analogue of bench.py:
     15,000 genomes, 1,048,576 single-end 100 bp reads): the port's CLI
     builds the database, then queries every read on -device cuda. Checks
     that both kernels ran on that path and that the classified fraction
     is within 0.001 of the 0.9719 the JAX package recorded on the same
     seeded world; the first 16,384 reads again on -device cpu give the
     same mapping lines.
  4. the realistic paired-end world of bench.py (96 Mbp, 262,144 pairs,
     a repeat at the 254-location cap): GPU query, and the first 8,192
     pairs on the CPU give the same mapping lines.
  5. config-2 evaluation: every read with -exclude species -precision; no
     read is classified as its own species, and the first 16,384 lines
     equal -device cpu's.
  6. -hits-per-seq -tophits (16,384 reads) and -align (4,096 reads):
     -device cuda writes the bytes -device cpu writes.
  7. modify: the first 14,500 genomes built natively, the last 500 added
     by `modify` on cuda and on cpu: equal databases, equal to the
     one-shot build's feature table; all reads queried against it.
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
 12. distributed: two ranks of one process group (MC_* variables, both
     on the one card, so gloo), each through this script's rank worker
     (`--rank-worker`): `build -num-shards 4` gives the single-process
     shards array for array; `query -mesh` on 262,144 reads gives the
     fused query's first lines on rank 0; both kernels ran in each rank.
 13. realistic_mesh: the realistic world in 2 shards with -mesh; the
     first 8,192 pairs on the CPU give the same lines; how many lines
     differ from the fused query's (per-shard truncation) is printed.
Each path is driven with every kernel's launch count set to 0 just
before it and read just after. Then the kernels' JSON line and, last,
the device JSON line.

Worlds, databases and outputs go to build/smoke/ (and the kernel
libraries to build/metacache_tpu_torch/) inside the checkout. Imports no
JAX.
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
PIPELINE_FLAGS = ["-batch-size", "16384", "-max-query-len", "104",
                  "-max-locations-per-query", "256"]
PALLAS_SKETCH = "metacache_tpu/ops/sketch_pallas.py:165"
PALLAS_GATHERS = {"k1": "tools/exp_pallas_gather.py:50",
                  "k2": "tools/exp_pallas_gather.py:78"}
#: config-2's lookup: its location table and the query's [B, lmax] slots
C2_LOCATIONS = 86_957_916
C2_SLOTS = (16384, 256)

CPU_LINES = 16384          # reads compared with -device cpu
ALIGN_READS = 4096
MODIFY_ADDED = 500         # genomes that `modify` adds
MERGE_READS = 131072
INTERACTIVE_READS = 65536
MESH_SHARDS = 4            # config-2's -mesh and 2-rank shard count
DIST_READS = 262144        # reads of the 2-rank -mesh query
RANK_TIMEOUT = 600         # seconds for each 2-rank launch

#: launches of each kernel, summed over the paths this run drove
LAUNCHES = {"sketch_packed": 0, "gather_rows": 0}


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
        r = subprocess.run([sys.executable, "-m", "metacache_tpu_torch.cli"]
                           + args, cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
                           timeout=900)
    check(r.returncode == 0, f"{' '.join(args[:2])} failed, see {log}")
    return time.time() - t0


def kernel_modules():
    from metacache_tpu_torch.ops import gather_cuda, sketch_cuda
    return {"sketch_packed": sketch_cuda, "gather_rows": gather_cuda}


def driven(path, kernels, args, stdin=None):
    """One path through the port's CLI entry point, in this process, with
    every kernel's launch count set to 0 just before it and read just
    after; each kernel in `kernels` must have launched. Returns (stdout,
    stderr, wall seconds, counts)."""
    import torch
    from metacache_tpu_torch import cli
    mods = kernel_modules()
    out, err = io.StringIO(), io.StringIO()
    old_stdin = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(args + ["-device", DEVICE])
        torch.cuda.synchronize()
    finally:
        sys.stdin = old_stdin
    wall = time.time() - t0
    counts = {name: m.launches for name, m in mods.items()}
    check(rc == 0, f"{path}: {' '.join(args[:2])} failed (rc {rc}): "
                   f"{err.getvalue()[-2000:]}")
    for name in kernels:
        LAUNCHES[name] += counts[name]
        check_launched(path, name, counts[name])
    return out.getvalue(), err.getvalue(), wall, counts


def check_launched(path, name, n):
    check(n > 0, f"{path}: the {name} kernel was never launched")


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


def cuda_ms(fn, reps=10):
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


def build_kernels():
    """Both kernel libraries from the checkout's sources, one nvcc per
    source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    libs = [m.LIBRARY for m in kernel_modules().values()]
    t0 = time.time()
    with ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.load(), libs))
    say("build", kernels=len(libs), seconds=f"{time.time() - t0:.1f}")
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                say("build", source=os.path.basename(lib.source),
                    ptxas=line.strip().replace(" ", "_"))


def random_reads(rng, B, L, max_len, ambig_rate=0.01):
    """[B, L] 2-bit packed reads of random length <= max_len, some bases
    ambiguous, as the native reader packs them."""
    import numpy as np
    from metacache_tpu_torch.ops.encode import np_pack_codes
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < ambig_rate] = 255
    lens = rng.integers(0, max_len + 1, B).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 255
    p, a = np_pack_codes(codes)
    return p, a, lens


def phase_kernel(dev):
    """Sketch kernel vs its plain version on the card: bit-equal, timed."""
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
        return err, args, kw

    results = {}
    # the main path's shapes: the QueryPipelineParams default (B 4096,
    # reads up to 320) and the config-2 / realistic cells (B 16384, 104)
    for name, B, L, max_len in (("default", 4096, 320, 320),
                                ("cells", 16384, 104, 100)):
        p, a, lens = random_reads(rng, B, L, max_len)
        err, args, kw = run(p, a, lens, L)
        check(err == 0, f"kernel differs from plain at {name} shapes")
        ms = cuda_ms(lambda: sketch_cuda.sketch_packed(*args, **kw))
        plain_ms = cuda_ms(lambda: sketch_packed_reference(*args, **kw), 3)
        results[name] = dict(shape=f"B{B}xL{L}", err=err, ms=ms,
                             plain_ms=plain_ms)
        say("kernel", shape=f"B{B}xL{L}", max_abs_err=err,
            kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")

    # edge cases: empty, shorter than k, all ambiguous, reads with N,
    # k 12 and 16, B not a multiple of any tile, and the build's sketch
    # sizes over 64 (the kernel's larger instantiation)
    B, L = 1000 + 7, 256
    p, a, lens = random_reads(rng, B, L, L, ambig_rate=0.03)
    lens[:4] = [0, 5, 15, 16]
    a[4:8] = 255          # all ambiguous
    for k in (12, 16):
        for s in (1, 16, 64, 80, 256):
            err, _, _ = run(p, a, lens, L, k=k, s=s)
            check(err == 0, f"kernel differs from plain on edge cases "
                            f"(k={k}, s={s})")
    say("kernel", edge_cases="ok", B=B, k="12,16", s="1,16,64,80,256")
    return results


def phase_gather(dev):
    """Gather kernel vs its plain version on the card: bit-equal at the
    probe k1's shapes, at config-2's lookup shape and on edge cases;
    timed."""
    import torch
    from metacache_tpu_torch.ops import gather_cuda
    from metacache_tpu_torch.ops.gather import gather_rows_reference

    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)

    def case(N, B, L, dtype, full):
        hi = torch.iinfo(dtype).max
        table = torch.randint(0, hi, (N,), dtype=dtype, device=dev,
                              generator=gen)
        idx = torch.randint(0, N, (B, L), dtype=torch.int64, device=dev,
                            generator=gen)
        if full:
            n_valid = torch.full((B,), L, dtype=torch.int64, device=dev)
        else:
            n_valid = torch.randint(0, L + 1, (B,), dtype=torch.int64,
                                    device=dev, generator=gen)
            n_valid[:2] = torch.tensor([0, L], device=dev)
        return table, idx, n_valid, hi

    def compare(name, table, idx, n_valid, pad, timed=False):
        got = gather_cuda.gather_rows(table, idx, n_valid, pad)
        want = gather_rows_reference(table, idx, n_valid, pad)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"gather kernel output dtype/shape ({name})")
        err = int((got != want).sum())
        check(err == 0, f"gather kernel differs from plain in {err} "
                        f"elements ({name})")
        res = dict(err=err)
        if timed:
            res["ms"] = cuda_ms(
                lambda: gather_cuda.gather_rows(table, idx, n_valid, pad))
            res["plain_ms"] = cuda_ms(
                lambda: gather_rows_reference(table, idx, n_valid, pad))
            say("gather", shape=name, max_abs_err=err,
                kernel_ms=f"{res['ms']:.4f}",
                plain_ms=f"{res['plain_ms']:.4f}")
        return res

    results = {}
    # the probe k1: int32 table of 2^20 words, idx [2048, 128], rows full
    t, i, n, pad = case(1 << 20, 2048, 128, torch.int32, True)
    results["k1"] = compare("k1_N1048576_B2048xL128", t, i, n, pad, True)
    del t, i, n
    # config-2's lookup: its 86,957,916 packed locations (int64, 696 MB,
    # far past the 50 MB L2) and [16384, 256] slots, rows 0..256 valid
    t, i, n, pad = case(C2_LOCATIONS, *C2_SLOTS, torch.int64, False)
    results["config2"] = compare(
        f"config2_N{C2_LOCATIONS}_B{C2_SLOTS[0]}xL{C2_SLOTS[1]}", t, i, n,
        pad, True)
    del t, i, n
    torch.cuda.empty_cache()
    # edge cases: B 1007, a one-word table, rows with nothing valid
    for name, N, B, L, dtype, full in (
            ("B1007", 1 << 16, 1007, 256, torch.int64, False),
            ("one_word_table", 1, 64, 7, torch.int32, True),
            ("one_word_table_partial", 1, 33, 5, torch.int64, False)):
        compare(name, *case(N, B, L, dtype, full))
    t, i, n, pad = case(1000, 300, 64, torch.int64, False)
    compare("nothing_valid", t, i, torch.zeros_like(n), -7)
    say("gather", edge_cases="ok")
    return results


def classify_seconds(path):
    """The query's own '# time:' line: classification without DB load."""
    with open(path) as f:
        for ln in f:
            if ln.startswith("# time:"):
                return float(ln.split()[2]) / 1000.0
    raise SmokeFailure(f"no '# time:' line in {path}")


def compare_cpu(db, reads, flags, limit, gpu_out, tag):
    cpu_out = os.path.join(WORK, f"{tag}_cpu.txt")
    port_cli(["query", db] + reads + flags
             + ["-device", "cpu", "-query-limit", str(limit), "-out", cpu_out],
             os.path.join(WORK, f"{tag}_cpu.log"))
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


def check_fraction(path, frac):
    check(abs(frac - C2_EXPECTED_CLASSIFIED) <= C2_TOLERANCE,
          f"{path}: classified fraction {frac:.4f} is not within "
          f"{C2_TOLERANCE} of {C2_EXPECTED_CLASSIFIED}")


def c2_query(path, db, reads, flags, out):
    """A config-2 query driven through the CLI; returns the mapping lines,
    wall seconds, counts and the device's peak memory."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    _, _, wall, counts = driven(
        path, ("sketch_packed", "gather_rows"),
        ["query", db] + reads + flags + ["-out", out])
    return mapping_lines(out), wall, counts, torch.cuda.max_memory_allocated()


def phase_config2():
    import bench
    bench.C2 = os.path.join(WORK, "c2")
    t0 = time.time()
    bench.make_config2_world()
    say("config2", world_seconds=f"{time.time() - t0:.1f}")
    c2 = bench.C2
    db = os.path.join(c2, "db")
    build_s = port_cli(["build", db, os.path.join(c2, "genomes.fa"),
                        "-taxonomy", os.path.join(c2, "tax")],
                       os.path.join(WORK, "c2_build.log"))
    reads = [os.path.join(c2, "reads.fa")]
    flags = ["-lowest", "species"] + PIPELINE_FLAGS
    out = os.path.join(WORK, "c2_gpu.txt")
    lines, wall, counts, peak = c2_query("config2", db, reads, flags, out)
    n = len(lines)
    check(n == bench.C2_READS, f"config-2: {n} mapping lines")
    frac = classified_fraction(lines)
    qs = classify_seconds(out)
    say("config2", reads=n, build_seconds=f"{build_s:.2f}",
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
    build_s = port_cli(["build", db, os.path.join(big, "genomes.fa"),
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
    """-exclude species -precision over every read: a read's own genome is
    genome gi of its header r<i>_NC_<gi>.1, whose species is
    Species{gi} (bench.py); no read may be classified as it."""
    flags = ["-exclude", "species", "-precision", "-lowest", "species"] \
        + PIPELINE_FLAGS
    out = os.path.join(WORK, "c2_exclude_gpu.txt")
    lines, wall, counts, _ = c2_query("evaluation", c2["db"], c2["reads"],
                                      flags, out)
    check(len(lines) == len(mapping_lines(c2["out"])),
          f"evaluation: {len(lines)} mapping lines")
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


def npz_arrays(path):
    import numpy as np
    with np.load(path, allow_pickle=True) as z:   # names are objects
        return {k: z[k] for k in z.files}


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
    """Build A natively, add B with `modify` on cuda and on cpu: the two
    databases are equal array for array; the feature table equals the
    one-shot build's; every read is queried against the result."""
    import numpy as np
    from metacache_tpu.db.database import shard_path
    tax = os.path.join(c2["dir"], "tax")
    fa, fb = split_genomes(c2)
    db_a = os.path.join(WORK, "db_a")
    build_s = port_cli(["build", db_a, fa, "-taxonomy", tax],
                       os.path.join(WORK, "db_a_build.log"))
    dbs = {}
    for dev in ("cuda", "cpu"):
        dbs[dev] = os.path.join(WORK, f"db_ab_{dev}")
        shutil.copyfile(shard_path(db_a, 0), shard_path(dbs[dev], 0))
    stdout, _, wall, counts = driven("modify", ("sketch_packed",),
                                     ["modify", dbs["cuda"], fb])
    check(f"Added {MODIFY_ADDED} reference sequences." in stdout,
          f"modify: {stdout[-500:]}")
    cpu_s = port_cli(["modify", dbs["cpu"], fb, "-device", "cpu"],
                     os.path.join(WORK, "modify_cpu.log"))
    got = npz_arrays(shard_path(dbs["cuda"], 0))
    want = npz_arrays(shard_path(dbs["cpu"], 0))
    check(sorted(got) == sorted(want), "modify: array names differ")
    for k in want:
        check(got[k].dtype == want[k].dtype
              and np.array_equal(got[k], want[k]),
              f"modify: array {k} differs between cuda and cpu")
    oneshot = npz_arrays(shard_path(c2["db"], 0))
    table_equal = all(np.array_equal(got[k], oneshot[k])
                      for k in ("keys", "offsets", "loc_tgt", "loc_win",
                                "target_taxon_node"))
    del got, want, oneshot
    say("modify", build_a_seconds=f"{build_s:.2f}",
        modify_gpu_seconds=f"{wall:.2f}", modify_cpu_seconds=f"{cpu_s:.2f}",
        arrays_equal_cuda_cpu="yes",
        table_equals_oneshot="yes" if table_equal else "no",
        sketch_launches=counts["sketch_packed"])
    out = os.path.join(WORK, "c2_modified_gpu.txt")
    lines, wall, counts, _ = c2_query("modified_query", dbs["cuda"],
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
    check(table_equal, "modify: the feature table differs from the "
                       "one-shot build's")
    check(same == len(oneshot_lines), "modified_query: mapping lines "
                                      "differ from the one-shot build's")
    return db_a, fb


def phase_merge(c2, db_a, fb):
    """Query the first MERGE_READS reads against A and against a native
    build of B, merge the two result files on cuda and on cpu."""
    tax = os.path.join(c2["dir"], "tax")
    db_b = os.path.join(WORK, "db_b")
    port_cli(["build", db_b, fb, "-taxonomy", tax],
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
    build_s = port_cli(["build", db, os.path.join(c2["dir"], "genomes.fa"),
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
    check(backend == ["gloo"], f"{tag}: backend {backend}, expected gloo "
                               "(two ranks share one card)")
    return counts, wall, backend[0]


def rank_worker(counts_path, args):
    """One rank of launch_ranks: the CLI in this process, then its
    kernel launch counts to counts_path."""
    sys.path.insert(0, REPO)
    from metacache_tpu_torch import cli
    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    rc = cli.main(args)
    with open(counts_path, "w") as f:
        json.dump({name: m.launches for name, m in mods.items()}, f)
    return rc


def phase_distributed(c2, mesh_db):
    """Two ranks on the one card over gloo: (a) build the MESH_SHARDS
    shards, rank r writing s % 2 == r, equal to the single-process
    build's; (b) query -mesh, rank 0's lines equal the fused query's."""
    import numpy as np
    from metacache_tpu.db.database import shard_path
    db = os.path.join(c2["dir"], "dist_db")
    _, build_s, backend = launch_ranks("dist_build", [
        "build", db, os.path.join(c2["dir"], "genomes.fa"), "-taxonomy",
        os.path.join(c2["dir"], "tax"), "-num-shards", str(MESH_SHARDS)])
    for s in range(MESH_SHARDS):
        got = npz_arrays(shard_path(db, s))
        want = npz_arrays(shard_path(mesh_db, s))
        check(sorted(got) == sorted(want), f"distributed: shard {s} arrays")
        for k in want:
            check(got[k].dtype == want[k].dtype
                  and np.array_equal(got[k], want[k]),
                  f"distributed: shard {s} array {k} differs from the "
                  "single-process build's")
        del got, want
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
    build_s = port_cli(["build", db, os.path.join(big["dir"], "genomes.fa"),
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


def use_repo_tests_package():
    """bench.py's world generators import `tests.util_mockdata`. Bind the
    name `tests` to this checkout's test directory, even where an
    installed package of that name would shadow it."""
    import types
    pkg = types.ModuleType("tests")
    pkg.__path__ = [os.path.join(REPO, "tests")]
    sys.modules["tests"] = pkg


def kernels_json(sketch, gather):
    cell = sketch["cells"]
    c2 = gather["config2"]
    rows = [{
        "name": "sketch_packed",
        "route": "cuda",
        "source": "metacache_tpu_torch/csrc/sketch.cu",
        "replaces": PALLAS_SKETCH,
        "launches": LAUNCHES["sketch_packed"],
        "max_abs_err": max(r["err"] for r in sketch.values()),
        "ms": cell["ms"],
        "plain_ms": cell["plain_ms"],
        "shape": cell["shape"],
    }]
    # one kernel replaces both probes (k2's row-and-lane layout has no
    # counterpart on Hopper); its time at config-2's lookup shape
    for probe, where in PALLAS_GATHERS.items():
        rows.append({
            "name": "gather_rows",
            "route": "cuda",
            "source": "metacache_tpu_torch/csrc/gather.cu",
            "replaces": where,
            "launches": LAUNCHES["gather_rows"],
            "max_abs_err": max(r["err"] for r in gather.values()),
            "ms": c2["ms"],
            "plain_ms": c2["plain_ms"],
            "shape": f"N{C2_LOCATIONS}_B{C2_SLOTS[0]}xL{C2_SLOTS[1]}",
            "probe": probe,
            "k1_ms": gather["k1"]["ms"],
            "k1_plain_ms": gather["k1"]["plain_ms"],
        })
    return {"kernels": rows}


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
        sketch = phase_kernel(dev)
        gather = phase_gather(dev)
        c2 = phase_config2()
        big = phase_realistic()
        phase_evaluation(c2)
        phase_options(c2)
        db_a, fb = phase_modify(c2)
        phase_merge(c2, db_a, fb)
        phase_interactive(c2)
        phase_info(c2)
        mesh_db = phase_mesh(c2)
        phase_distributed(c2, mesh_db)
        phase_realistic_mesh(big)
        say("done", seconds=f"{time.time() - t0:.1f}")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(kernels_json(sketch, gather)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
