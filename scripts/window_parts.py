#!/usr/bin/env python3
"""Where the build's window kernel spends its device time, on the card:

    python3 scripts/window_parts.py [--runs N]

Builds three variants of metacache_tpu_torch/csrc/sketch.cu into
build/window_parts/ with the port's nvcc flags: the source as it is;
"stage" (each window's sketch is not computed: staging, set-up and the
output only); "hash" (each batch of 16 hashes is folded into one value
instead of sorted and merged: staging plus the strands and hashes).
Times each one's mc_sketch_windows on chip_smoke's seeded record (one
25 Mbp record of config-3's composition, 221,239 windows, the build's
sketch parameters) as chip_smoke times kernels (a CUDA graph of 20
calls, replayed), N times (default 3); the source as it is must equal
the plain version bit for bit. Differences of the medians give the
parts: staging and output, the strands and hashes, the selection.
Prints the card's name and power limit, a line per variant, and last
one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "window_parts")

#: variant -> (text replaced in the source, its replacement)
VARIANTS = {
    "whole": None,
    "stage": ("    sketch_window<kCap, false>(sp, sa, u0, n_kmers, k, sk);",
              "    sk[0] = sp[u0 >> 4];"),
    "hash": ("      sort16(h);\n",
             "      { for (int q = 0; q < 16; ++q) sk[0] ^= h[q]; "
             "continue; }\n"),
}


def build(name, source):
    from metacache_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc
    text = open(source).read()
    if VARIANTS[name] is not None:
        old, new = VARIANTS[name]
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{r.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    fn = lib.mc_sketch_windows
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from metacache_tpu_torch.config import SketchParams
    from metacache_tpu_torch.ops.cuda_build import CSRC_DIR
    from metacache_tpu_torch.ops.sketch import sketch_windows_reference
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi printed nothing", flush=True)
    p = SketchParams()
    host = chip_smoke.seeded_record(np.random.default_rng(13))
    seq, off, lens, win_off = [torch.from_numpy(x).cuda() for x in host]
    n = int(host[3][-1])
    want = sketch_windows_reference(
        seq, off, lens, win_off, n_windows=n, k=p.kmer_size,
        sketch_size=p.sketch_size, window_size=p.window_size,
        stride=p.window_stride)
    out = torch.empty_like(want)
    results = {}
    for name in VARIANTS:
        fn = build(name, os.path.join(CSRC_DIR, "sketch.cu"))

        def run():
            rc = fn(seq.data_ptr(), off.data_ptr(), lens.data_ptr(),
                    win_off.data_ptr(), len(host[1]), n, p.kmer_size,
                    p.sketch_size, p.window_size, p.window_stride,
                    out.data_ptr(), torch._C._cuda_getCurrentRawStream(0))
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        run()
        torch.cuda.synchronize()
        if name == "whole" and not torch.equal(out, want):
            print("FAIL: the kernel differs from its plain version",
                  file=sys.stderr)
            return 1
        ms = [chip_smoke.device_ms(run) for _ in range(args.runs)]
        results[name] = dict(device_ms=ms, median=statistics.median(ms))
        print(f"[{name}] windows={n} device_ms="
              + ",".join(f"{x:.6f}" for x in ms), flush=True)
    med = {k: v["median"] for k, v in results.items()}
    parts = dict(stage_and_output=med["stage"],
                 strands_and_hashes=med["hash"] - med["stage"],
                 selection=med["whole"] - med["hash"])
    print("[parts] " + " ".join(f"{k}={v:.6f}" for k, v in parts.items()))
    print(json.dumps(dict(card=smi[0] if smi else None, variants=results,
                          parts_ms=parts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
