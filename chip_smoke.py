#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (metacache_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA
     versions.
  2. kernel vs plain: builds the CUDA sketch kernel from
     metacache_tpu_torch/csrc/sketch.cu and holds it bit for bit against
     its plain PyTorch version on the card, at the main path's shapes and
     on edge cases; times both with CUDA events.
  3. config-2 (BASELINE config-2, the RefSeq-viral analogue of bench.py:
     15,000 genomes, 1,048,576 single-end 100 bp reads): the port's CLI
     builds the database, then queries every read on -device cuda. Checks
     that the sketch kernel ran on that path and that the classified
     fraction is within 0.001 of the 0.9719 the JAX package recorded on
     the same seeded world.
  4. the first 16,384 reads again on -device cpu: mapping lines equal.
  5. the realistic paired-end world of bench.py (96 Mbp, 262,144 pairs,
     a repeat at the 254-location cap): GPU query, and the first 8,192
     pairs on the CPU give the same mapping lines.
Then one JSON line per kernel summary and, last, the device JSON line.

Worlds, databases and outputs go to build/smoke/ (and the kernel library
to build/metacache_tpu_torch/) inside the checkout. Imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "smoke")

C2_EXPECTED_CLASSIFIED = 0.9719     # BENCH_r05.json, JAX package
C2_TOLERANCE = 0.001
PIPELINE_FLAGS = ["-batch-size", "16384", "-max-query-len", "104",
                  "-max-locations-per-query", "256"]
PALLAS_SKETCH = "metacache_tpu/ops/sketch_pallas.py:165"


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


def mapping_lines(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("#")]


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
    """Kernel vs plain version on the card: bit-equal, timed."""
    import numpy as np
    import torch
    from metacache_tpu_torch.ops import encode, sketch_cuda
    from metacache_tpu_torch.ops.sketch import sketch_packed_reference

    sketch_cuda.load_library()
    for line in sketch_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            say("build", ptxas=line.strip().replace(" ", "_"))
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
    # k 12 and 16, B not a multiple of any tile
    B, L = 1000 + 7, 256
    p, a, lens = random_reads(rng, B, L, L, ambig_rate=0.03)
    lens[:4] = [0, 5, 15, 16]
    a[4:8] = 255          # all ambiguous
    for k in (12, 16):
        for s in (1, 16, 64):
            err, _, _ = run(p, a, lens, L, k=k, s=s)
            check(err == 0, f"kernel differs from plain on edge cases "
                            f"(k={k}, s={s})")
    say("kernel", edge_cases="ok", B=B, k="12,16", s="1,16,64")
    return results


def query_gpu(args, out_path):
    """One query through the port's CLI entry point, in this process, so
    the kernel's launch count and the device's peak memory are visible.
    Returns (wall seconds, launches, peak bytes)."""
    import torch
    from metacache_tpu_torch import cli
    from metacache_tpu_torch.ops import sketch_cuda
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sketch_cuda.launches = 0
    t0 = time.time()
    rc = cli.main(args + ["-device", "cuda", "-out", out_path])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = sketch_cuda.launches
    check(rc == 0, f"GPU query failed (rc {rc})")
    return wall, launches, torch.cuda.max_memory_allocated()


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
    wall, launches, peak = query_gpu(["query", db] + reads + flags, out)
    lines = mapping_lines(out)
    n = len(lines)
    check(n == bench.C2_READS, f"config-2: {n} mapping lines")
    frac = sum(not ln.rstrip("\n").endswith("--") for ln in lines) / n
    qs = classify_seconds(out)
    say("config2", reads=n, build_seconds=f"{build_s:.2f}",
        query_wall_seconds=f"{wall:.2f}", reads_per_s_wall=f"{n / wall:.1f}",
        classify_seconds=f"{qs:.3f}", reads_per_s_classify=f"{n / qs:.1f}",
        classified_frac=f"{frac:.4f}", peak_device_bytes=peak,
        sketch_launches=launches)
    check(launches > 0, "config-2: the sketch kernel was never launched")
    check(abs(frac - C2_EXPECTED_CLASSIFIED) <= C2_TOLERANCE,
          f"config-2 classified fraction {frac:.4f} is not within "
          f"{C2_TOLERANCE} of {C2_EXPECTED_CLASSIFIED}")
    compare_cpu(db, reads, flags, 16384, out, "config2")
    return launches


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
    wall, launches, peak = query_gpu(["query", db] + reads + flags, out)
    n = len(mapping_lines(out))
    check(n == bench.BIG_PAIRS, f"realistic: {n} mapping lines")
    qs = classify_seconds(out)
    say("realistic", pairs=n, build_seconds=f"{build_s:.2f}",
        query_wall_seconds=f"{wall:.2f}", pairs_per_s_wall=f"{n / wall:.1f}",
        classify_seconds=f"{qs:.3f}", pairs_per_s_classify=f"{n / qs:.1f}",
        peak_device_bytes=peak, sketch_launches=launches)
    check(launches > 0, "realistic: the sketch kernel was never launched")
    compare_cpu(db, reads, flags, 8192, out, "realistic")
    return launches


def use_repo_tests_package():
    """bench.py's world generators import `tests.util_mockdata`. Bind the
    name `tests` to this checkout's test directory, even where an
    installed package of that name would shadow it."""
    import types
    pkg = types.ModuleType("tests")
    pkg.__path__ = [os.path.join(REPO, "tests")]
    sys.modules["tests"] = pkg


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
        times = phase_kernel(torch.device("cuda"))
        c2_launches = phase_config2()
        re_launches = phase_realistic()
        say("done", seconds=f"{time.time() - t0:.1f}")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    cell = times["cells"]
    print(json.dumps({"kernels": [{
        "name": "sketch_packed",
        "route": "cuda",
        "source": "metacache_tpu_torch/csrc/sketch.cu",
        "replaces": PALLAS_SKETCH,
        "launches": c2_launches + re_launches,
        "max_abs_err": max(r["err"] for r in times.values()),
        "ms": cell["ms"],
        "plain_ms": cell["plain_ms"],
        "shape": cell["shape"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
