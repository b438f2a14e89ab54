#!/usr/bin/env python3
"""What the query process's imports cost, by top-level package:

    python3 scripts/import_time.py [--runs N]

Imports what `python3 -m bench_torch.probe` imports before it calls the
CLI (torch, the port's cli and kernel wrappers, bench_torch.trace) in a
fresh interpreter under `python -X importtime`, N times (default 3), and
prints per run the cumulative seconds of each top-level package imported
directly (torch, metacache_tpu_torch, bench_torch, ...) and the total;
last, one JSON line with every run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_IMPORTS = ("import torch; from metacache_tpu_torch import cli; "
                 "from metacache_tpu_torch.ops import gather_cuda, "
                 "sketch_cuda; from bench_torch import trace")


def one_run() -> dict:
    """-> {top-level package: cumulative seconds}, with 'total'."""
    r = subprocess.run([sys.executable, "-X", "importtime", "-c",
                        PROBE_IMPORTS], cwd=REPO, capture_output=True,
                       text=True, check=True)
    top = {}
    for line in r.stderr.splitlines():
        if not line.startswith("import time:") or "|" not in line:
            continue
        _, cumulative, name = line[len("import time:"):].split("|")
        if not cumulative.strip().isdigit() or name != name.rstrip() \
                or name[1:2] == " ":
            continue   # the header line, or a nested import
        top[name.strip()] = int(cumulative) / 1e6
    top["total"] = sum(top.values())
    return top


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/import_time.py")
    ap.add_argument("--runs", type=int, default=3)
    opt = ap.parse_args(argv)
    runs = []
    for i in range(opt.runs):
        top = one_run()
        runs.append(top)
        big = sorted(top.items(), key=lambda kv: -kv[1])[:6]
        print(f"run {i}: " + " ".join(f"{k}={v:.3f}s" for k, v in big),
              flush=True)
    print(json.dumps(dict(imports=PROBE_IMPORTS, runs=runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
