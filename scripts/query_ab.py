#!/usr/bin/env python3
"""Query cells of BENCHMARK.json run by two trees of the port in turns, to
compare them within one call on one machine:

    python3 scripts/query_ab.py --cell NAME [--cell NAME ...] [--rounds N]
        [--device cuda|cpu] [--query-limit N] [--rehearse]
        PARENT_ROOT CHANGE_ROOT

The worlds and databases are the benchmark's own (bench_torch.runner's
make_world and ensure_db, under build/bench_torch/): generated from
BENCHMARK.json's seed, the database built by this checkout's CLI and
built again when the world or this checkout's port sources change (both
trees read the same database format). Each round runs every cell's query
once per tree in the order parent, change, change, parent (the first
round after one untimed run of each tree, which builds its kernels and
fills the page cache), each in a process of its own through that tree's `python3 -m bench_torch.probe`
with the cell's flags. A line per run: the process wall, reads (pairs)
per second over it, the query's '# database load' and '# table upload'
seconds, its '# time:' span, peak device memory and sampled peak host
RSS (MiB). Fails unless every run of a cell wrote the same mapping lines.
Last, one JSON line with each tree's medians per cell.

--device cpu --query-limit N runs the same queries on the CPU over their
first N reads (a fused database's set-up on the CPU, say); --rehearse
runs the cells' rehearsal worlds on the CPU, to check the script. On the
card it needs one; without it exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bench_torch import runner  # noqa: E402

TREES = ("parent", "change")
NUMBERS = ("wall_s", "reads_per_s", "load_s", "upload_s", "time_s",
           "peak_device_mb", "peak_host_rss_mb")


def query(root: str, tag: str, args, device: str, logdir: str):
    """One query through the probe of the tree at `root` (runner.port runs
    the probe from runner.REPO) -> (wall, the probe's record, stderr)."""
    here, runner.REPO = runner.REPO, root
    try:
        wall, rec, _, err = runner.port(args, device, tag, logdir)
    finally:
        runner.REPO = here
    return wall, rec, err


def run_cell(cell, roots, opt, spec, device, rnd):
    """One round of a cell -> each timed run's (tree, numbers)."""
    wdir, scale = runner.make_world(opt.work, cell["world"], spec["seed"],
                                    opt.rehearse)
    db = runner.ensure_db(wdir, cell["shards"], device)
    flags = list(spec["flags"])
    if opt.rehearse:
        flags[flags.index("-batch-size") + 1] = runner.REHEARSAL_BATCH
    n_reads = runner.read_count(cell["world"], scale)
    if opt.query_limit:
        flags += ["-query-limit", str(opt.query_limit)]
        n_reads = min(n_reads, opt.query_limit)
    paired = "-pairfiles" in cell["flags"]
    logdir = os.path.join(opt.work, "ab", f"{cell['name']}_{device}")
    os.makedirs(logdir, exist_ok=True)
    runs, digest = [], None
    # in the first round each tree runs once untimed first: it builds its
    # kernels and libmcio and reads the files into the page cache
    order = ((0, 1) if rnd == 0 else ()) + (0, 1, 1, 0)
    for i, t in enumerate(order):
        tree = TREES[t]
        warm = rnd == 0 and i < 2
        tag = f"{tree}_{rnd}_{i}"
        out = os.path.join(logdir, f"{tag}.txt")
        wall, rec, err = query(
            roots[tree], tag, ["query", db]
            + [os.path.join(wdir, r) for r in cell["reads"]] + flags
            + cell["flags"] + ["-out", out], device, logdir)
        res = runner.result_file(out, paired)
        runner.check(res["lines"] == n_reads,
                     f"{cell['name']} {tag}: {res['lines']} mapping lines "
                     f"for {n_reads} reads")
        digest = digest or res["digest"]
        runner.check(res["digest"] == digest,
                     f"{cell['name']} {tag}: other mapping lines than the "
                     "first run of the cell")
        os.remove(out)
        got = dict(wall_s=wall, reads_per_s=n_reads / wall,
                   load_s=runner.stderr_seconds(err, "database load"),
                   upload_s=runner.stderr_seconds(err, "table upload"),
                   time_s=res["classify_s"],
                   peak_device_mb=rec["peak_device_mb"],
                   peak_host_rss_mb=rec["peak_host_rss_mb"])
        runner.say(cell["name"], tree=tree, round=rnd,
                   run="warm-up" if warm else "timed", **got)
        if not warm:
            runs.append((tree, got))
    runner.say(cell["name"], round=rnd, results_equal="true",
               lines=n_reads)
    return runs


def median(runs, tree, key):
    vals = [r[key] for t, r in runs if t == tree and r[key] is not None]
    return statistics.median(vals) if vals else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/query_ab.py")
    ap.add_argument("--cell", action="append", required=True)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--query-limit", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--work", default=os.path.join(REPO, "build",
                                                   "bench_torch"))
    ap.add_argument("roots", nargs=2)
    opt = ap.parse_args(argv)
    device = "cpu" if opt.rehearse else opt.device
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    spec = runner.load_spec()
    cells = {c["name"]: c for c in spec["workloads"] if c["mode"] == "query"}
    unknown = [n for n in opt.cell if n not in cells]
    if unknown:
        print(f"FAIL: no query cell {unknown}; cells: {list(cells)}",
              file=sys.stderr)
        return 1
    opt.work = os.path.abspath(opt.work)
    roots = dict(zip(TREES, (os.path.abspath(r) for r in opt.roots)))
    info = runner.device_info(device)
    print(info.get("nvidia_smi", info["kind"]), flush=True)
    got = {}
    try:
        for rnd in range(opt.rounds):
            for name in opt.cell:
                got.setdefault(name, []).extend(
                    run_cell(cells[name], roots, opt, spec, device, rnd))
    except runner.BenchFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(dict(
        device=info, on=device, query_limit=opt.query_limit or None,
        medians={name: {tree: {k: median(runs, tree, k) for k in NUMBERS}
                        for tree in TREES}
                 for name, runs in got.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
