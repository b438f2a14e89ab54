#!/usr/bin/env python3
"""The evaluation summaries of the port held to the JAX CLI at scale, on
the CPU.

    python3 scripts/summary_parity.py [--work DIR] [--flags "EXTRA FLAGS"]

Generates bench.py's seeded realistic world (96 Mbp, 262,144 read
pairs; `bench.make_realistic_world`) under DIR (default
build/summary_parity), builds it with both CLIs, then queries every pair
with

    -pairfiles -abundances -abundance-per species -precision
    -taxon-coverage -hits-per-seq [EXTRA FLAGS]

through the JAX CLI (`python -m metacache_tpu.cli`, METACACHE_PLATFORM=cpu)
and the port (`python -m metacache_tpu_torch ... -device cpu`), with the
CPU's default pipeline on both sides (batch 512, 1024 match slots).
Without `-lowest`, reads are classified down to the sequence, which fills
the hits-per-target list. The result files are compared line for line,
the run-dependent '# time:' and '# speed:' lines aside: mapping lines,
the per-target hit lists, the per-rank precision and taxon-coverage
blocks and both abundance tables. The differing lines go to
DIR/diff.txt. Prints the commands, the pair count, each step's seconds,
the count of differing lines and how many fall under each heading of the
output, and exits 1 if any line differs. Where hits-per-target lines
differ, it also counts their differing window hits by (JAX count - port
count, whether the window is the last of its entry): the JAX
`target_window_hits` over-count on a full match list shows as (1, True)
only. Runs both packages as programs of their own and
imports neither. Takes ~2 GB of host memory.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QUERY_FLAGS = ["-pairfiles", "-abundances", "-abundance-per", "species",
               "-precision", "-taxon-coverage", "-hits-per-seq"]
#: lines of DIR/diff.txt at most
DIFF_LINES = 200


def run(cmd, log):
    """Run one CLI command from the work directory; its output to `log`.
    Returns its wall seconds."""
    env = dict(os.environ, METACACHE_PLATFORM="cpu", PYTHONPATH=REPO)
    t0 = time.time()
    with open(log, "w") as f:
        r = subprocess.run([sys.executable, "-m"] + cmd, stdout=f,
                           stderr=subprocess.STDOUT, env=env)
    wall = time.time() - t0
    print(f"{' '.join(cmd)}  ->  rc {r.returncode}, {wall:.1f} s",
          flush=True)
    if r.returncode:
        sys.exit(f"failed, see {log}")
    return wall


def result_lines(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith(("# time:", "# speed:"))]


def window_hit_differences(pairs):
    """Differing window hits of differing hits-per-target lines ('sequence:
    <name> | <windows> | qid/win:hits/win:hits,...'), the entries paired by
    query id, counted by 'JAX count - port count, last window of its entry
    or not' (a window listed on one side only counts with 0 hits on the
    other); 'order' counts lines whose entries come in another order."""
    def entries(line):
        out = {}
        for e in line.rstrip("\n").split("\t|\t")[2].split(","):
            qid, *wins = e.split("/")
            out.setdefault(qid, []).append(
                dict((int(w), int(h)) for w, h in
                     (x.split(":") for x in wins)))
        return out

    counts = {}
    for want, got in pairs:
        w_ent, g_ent = entries(want), entries(got)
        order = [e.split("/")[0] for e in want.split("\t|\t")[2].split(",")]
        if order != [e.split("/")[0] for e in
                     got.split("\t|\t")[2].split(",")]:
            counts["order"] = counts.get("order", 0) + 1
        for qid in w_ent.keys() | g_ent.keys():
            for w, g in zip(w_ent.get(qid, []), g_ent.get(qid, [])):
                last = max(w.keys() | g.keys())
                for win in w.keys() | g.keys():
                    d = w.get(win, 0) - g.get(win, 0)
                    if d:
                        key = f"{d}, last={win == last}"
                        counts[key] = counts.get(key, 0) + 1
    return counts


def make_world(work):
    """bench.py's realistic world, seeded, under `work`/realistic."""
    sys.path.insert(0, REPO)
    # bench.py's generators import tests.util_mockdata: bind `tests` to this
    # checkout's test directory
    pkg = types.ModuleType("tests")
    pkg.__path__ = [os.path.join(REPO, "tests")]
    sys.modules["tests"] = pkg
    import bench
    bench.BIG = os.path.join(work, "realistic")
    bench.make_realistic_world()
    return bench.BIG, bench.BIG_PAIRS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=os.path.join(REPO, "build",
                                                   "summary_parity"))
    ap.add_argument("--flags", default="",
                    help="more query flags for both CLIs, e.g. "
                         "'-lowest species'")
    a = ap.parse_args()
    flags = QUERY_FLAGS + a.flags.split()
    work = os.path.abspath(a.work)
    os.makedirs(work, exist_ok=True)
    t0 = time.time()
    big, pairs = make_world(work)
    secs = {"world": time.time() - t0}
    reads = [os.path.join(big, "reads_1.fa"), os.path.join(big, "reads_2.fa")]
    sides = {"jax": (["metacache_tpu.cli"], []),
             "port": (["metacache_tpu_torch"], ["-device", "cpu"])}
    outs = {}
    for side, (mod, dev) in sides.items():
        db = os.path.join(work, f"{side}db")
        secs[f"{side}_build"] = run(
            mod + ["build", db, os.path.join(big, "genomes.fa"), "-taxonomy",
                   os.path.join(big, "tax")] + dev,
            os.path.join(work, f"{side}_build.log"))
        outs[side] = os.path.join(work, f"{side}_out.txt")
        secs[f"{side}_query"] = run(
            mod + ["query", db] + reads + flags + dev
            + ["-out", outs[side]], os.path.join(work, f"{side}_query.log"))
    want, got = result_lines(outs["jax"]), result_lines(outs["port"])
    differ = [i for i, (w, g) in enumerate(zip(want, got)) if w != g]
    n_diff = len(differ) + abs(len(want) - len(got))
    with open(os.path.join(work, "diff.txt"), "w") as f:
        for i in differ[:DIFF_LINES]:
            f.write(f"line {i + 1}\n- {want[i]}+ {got[i]}")
        if len(want) != len(got):
            f.write(f"lengths: jax {len(want)}, port {len(got)}\n")
    # differing lines under each heading ('# ...' line) of the JAX output
    under, heading = {}, "(top)"
    differ_set = set(differ)
    for i, ln in enumerate(want):
        if ln.startswith("# "):
            heading = ln.strip()
        if i in differ_set:
            under[heading] = under.get(heading, 0) + 1
    mapped = sum(ln.split("\t", 1)[0].isdigit() for ln in want)
    hits = window_hit_differences(
        [(want[i], got[i]) for i in differ
         if want[i].startswith("sequence:")])
    print(json.dumps(dict(
        pairs=pairs, flags=" ".join(flags), result_lines=len(want),
        mapping_lines=mapped, differing_lines=n_diff,
        differing_under=under, window_hit_differences=hits,
        seconds={k: round(v, 1) for k, v in secs.items()})), flush=True)
    return 1 if n_diff else 0


if __name__ == "__main__":
    sys.exit(main())
