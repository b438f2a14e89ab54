#!/usr/bin/env python3
"""The build CLI's wall split by step and by thread, for one or more trees
of the port, over the world of the benchmark's config3-build cell:

    python3 scripts/build_split.py [--shards P] [--runs N]
        [--device cuda|cpu] [--rehearse] ROOT [ROOT ...]

The world is the benchmark's (bench_torch.runner.make_world, under
build/bench_torch/). Each tree's libraries are built first (untimed);
then each tree builds it `--runs` times (default 1) into
`-num-shards P` (default 2, the cell's) in a process of its own (this
script's --worker), which wraps the tree's build functions where the tree
has them and records, in seconds on the host's clock:

  start           the process's spawn to the port and torch imported
  cli             cli.main (the build, as the CLI runs it)
  exit            cli.main's return to the process's end
  sketch_pass     native.sketch_file_spill / native.sketch_file (the host
                  path's parse + sketch + spill pass over a file), with
                  the calling thread's CPU seconds: the parser's
  parse           native.RecordStream.next_batch (the card path's parse
                  of a batch of whole records)
  sketch_batch    the card path's upload + window sketch + append of a
                  batch (host time: the device runs behind it)
  spill           a device triple store sorted and written as a chunk
  finalize        each shard's finalize (ChunkedTripleSorter.finalize on
                  the host path; on the card path the device's
                  sort + CSR + copy down, or the native merge of a
                  spilled shard)
  merge_chunks    native.merge_chunks_csr (the K-way merge)
  host_sort       native.radix_sort_triples / build_csr_table (a host
                  sort called from Python; the native passes' own chunk
                  sorts run inside sketch_pass)
  save            Database.save per shard
  properties      Database.properties (the summary the CLI prints last)

It also records each kernel wrapper's launch count over cli.main (set to
0 just before it).
and, sampled every 0.1 s from /proc/self/task, the CPU seconds (user and
system) of every thread of the process that used more than 0.05 s, with
the window in which it lived (the sampling thread itself is marked).
On the host path the native pass starts its sketch workers, then its
spiller (the thread created last): the spiller's user time is its radix
sort of each chunk, its system time mostly the chunk writes. The peak
host RSS is sampled from /proc/self/statm every 20 ms, with the time it
was reached, and read at the start and end of every wrapped call (each
call: [start s, end s, CPU s, RSS MiB at its start, at its end]). Last,
one JSON line with every run's numbers.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERIOD_S = 0.02         # the RSS sample's period
THREADS_EVERY = 5       # threads read every 5th sample (0.1 s)
CPU_MIN_S = 0.05

#: (module, attribute path, series): each wrapped where the tree has it
HOOKS = (
    ("metacache_tpu_torch.native", "sketch_file_spill", "sketch_pass"),
    ("metacache_tpu_torch.native", "sketch_file", "sketch_pass"),
    ("metacache_tpu_torch.native", "RecordStream.next_batch", "parse"),
    ("metacache_tpu_torch.native", "merge_chunks_csr", "merge_chunks"),
    ("metacache_tpu_torch.native", "radix_sort_triples", "host_sort"),
    ("metacache_tpu_torch.native", "build_csr_table", "host_sort"),
    ("metacache_tpu_torch.db.build", "CardBuild.add_batch", "sketch_batch"),
    ("metacache_tpu_torch.db.feature_table", "ChunkedTripleSorter.finalize",
     "finalize"),
    ("metacache_tpu_torch.db.device_store", "DeviceTripleStore.spill",
     "spill"),
    ("metacache_tpu_torch.db.device_store", "DeviceTripleStore.finalize",
     "finalize"),
    ("metacache_tpu_torch.db.database", "Database.save", "save"),
    ("metacache_tpu_torch.db.database", "Database.properties",
     "properties"),
)


def say(tag, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _thread_times():
    """{tid: (name, user s, system s)} of this process's threads."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                s = f.read()
        except OSError:
            continue
        name = s[s.index("(") + 1:s.rindex(")")]
        fields = s[s.rindex(")") + 2:].split()
        out[int(tid)] = (name, int(fields[11]) / tick, int(fields[12]) / tick)
    return out


def _rss_mb():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def _kernel_modules():
    """The tree's kernel wrapper modules (ops/*_cuda.py)."""
    import importlib
    import pkgutil

    from metacache_tpu_torch import ops
    return [importlib.import_module(f"metacache_tpu_torch.ops.{m.name}")
            for m in pkgutil.iter_modules(ops.__path__)
            if m.name.endswith("_cuda")]


def worker(out_json: str, root: str, t_spawn: float, args) -> int:
    """The CLI of the tree at `root` in this process, its steps timed."""
    sys.path.insert(0, root)
    import importlib

    import torch  # noqa: F401  (its import is part of the start)
    import metacache_tpu_torch
    from metacache_tpu_torch import cli
    assert metacache_tpu_torch.__file__.startswith(os.path.abspath(root))
    t_imported = time.time()
    calls = collections.defaultdict(list)   # series -> [(start, end, cpu)]
    lock = threading.Lock()
    threads = {}                             # tid -> record
    peak = [_rss_mb(), 0.0]     # MiB, and when (s after the imports)
    done = threading.Event()

    def sample():
        sampler_tid[0] = threading.get_native_id()
        for i in range(1 << 62):
            if i % THREADS_EVERY == 0 or done.is_set():
                now = time.time() - t_imported
                for tid, (name, user, system) in _thread_times().items():
                    rec = threads.setdefault(tid, dict(name=name, born=now,
                                                       at_start=i == 0))
                    rec.update(user=user, system=system, last=now)
            rss = _rss_mb()
            if rss > peak[0]:
                peak[:] = [rss, time.time() - t_imported]
            if done.is_set():
                return
            done.wait(PERIOD_S)

    sampler_tid = [None]

    def timed(series, fn):
        def run(*a, **k):
            t0, c0, r0 = time.time(), time.thread_time(), _rss_mb()
            try:
                return fn(*a, **k)
            finally:
                with lock:
                    calls[series].append((t0 - t_imported,
                                          time.time() - t_imported,
                                          time.thread_time() - c0, r0,
                                          _rss_mb()))
        return run

    wrapped = []
    for mod_name, attr, series in HOOKS:
        try:
            obj = importlib.import_module(mod_name)
        except ImportError:
            continue
        *owner_path, name = attr.split(".")
        for part in owner_path:
            obj = getattr(obj, part, None)
        if obj is None or not hasattr(obj, name):
            continue
        setattr(obj, name, timed(series, getattr(obj, name)))
        wrapped.append(attr)
    counters = [(mod, name) for mod in _kernel_modules()
                for name in dir(mod) if name.endswith("launches")]
    for mod, name in counters:
        setattr(mod, name, 0)
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.time()
    try:
        rc = cli.main(args)
    finally:
        done.set()
        sampler.join()
    t_cli_done = time.time()
    launches = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}":
                getattr(mod, name) for mod, name in counters}
    me = os.getpid()
    rec = dict(rc=rc, wrapped=wrapped, launches=launches,
               start_s=t_imported - t_spawn,
               cli_s=t_cli_done - t0, t_cli_done=t_cli_done,
               peak_host_rss_mb=peak[0], peak_host_rss_at_s=peak[1],
               series={k: dict(n=len(v),
                               total_s=sum(c[1] - c[0] for c in v),
                               cpu_s=sum(c[2] for c in v),
                               calls=[[round(x, 3) for x in c] for c in v])
                       for k, v in calls.items()},
               threads=[dict(tid=tid, main=tid == me,
                             sampler=tid == sampler_tid[0], **{
                   k: round(v, 3) if isinstance(v, float) else v
                   for k, v in t.items()})
                   for tid, t in sorted(threads.items())
                   if t["user"] + t["system"] >= CPU_MIN_S])
    with open(out_json, "w") as f:
        json.dump(rec, f)
    return rc


def pass_threads(rec):
    """The native pass's threads: those born inside a sketch_pass call;
    the spiller is the one created last."""
    spans = rec["series"].get("sketch_pass", {}).get("calls", [])
    born = [t for t in rec["threads"] if not t["at_start"] and any(
        c[0] - 2 * PERIOD_S * THREADS_EVERY <= t["born"] <= c[1]
        for c in spans)]
    if not born:
        return {}
    spiller = max(born, key=lambda t: t["tid"])
    workers = [t for t in born if t is not spiller]
    return dict(spiller_user_s=spiller["user"],
                spiller_system_s=spiller["system"],
                workers=len(workers),
                workers_cpu_s=sum(t["user"] + t["system"] for t in workers),
                worker_max_cpu_s=max((t["user"] + t["system"]
                                      for t in workers), default=0.0))


WARM = """import sys
sys.path.insert(0, sys.argv[1])
import torch
from metacache_tpu_torch import native, ops
native.load_mcio()
if torch.cuda.is_available():
    import importlib, pkgutil
    for m in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"metacache_tpu_torch.ops.{m.name}")
        lib = getattr(mod, "LIBRARY", None)
        if lib is not None:
            lib.load()
"""


def warm(root):
    """Build the tree's native library and kernel libraries before its
    timed runs (the benchmark's trials find them built too)."""
    r = subprocess.run([sys.executable, "-c", WARM, root], cwd=root,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise SystemExit(f"FAIL: building {root}'s libraries:\n"
                         f"{r.stderr[-3000:]}")


def run_tree(root, tag, argv, logdir):
    rec_path = os.path.join(logdir, f"{tag}.json")
    t0 = time.time()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", rec_path, root, repr(t0)] + argv,
                       cwd=root, capture_output=True, text=True,
                       timeout=3000)
    t_end = time.time()
    for name, text in (("out", r.stdout), ("err", r.stderr)):
        with open(os.path.join(logdir, f"{tag}.{name}.log"), "w") as f:
            f.write(text)
    if r.returncode != 0:
        raise SystemExit(f"FAIL: {tag}: exit {r.returncode}\n"
                         f"{r.stderr[-3000:]}")
    with open(rec_path) as f:
        rec = json.load(f)
    rec.update(wall_s=t_end - t0, exit_s=t_end - rec.pop("t_cli_done"),
               **pass_threads(rec))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/build_split.py")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--work", default=os.path.join(REPO, "build",
                                                   "bench_torch"))
    ap.add_argument("roots", nargs="+")
    opt = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    from bench_torch import runner
    device = "cpu" if opt.rehearse else opt.device
    if device == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    spec = runner.load_spec()
    info = runner.device_info(device)
    print(info.get("nvidia_smi", info["kind"]), flush=True)
    work = os.path.abspath(opt.work)
    wdir, scale = runner.make_world(work, "config3", spec["seed"],
                                    opt.rehearse)
    gbp = runner.world_gbp("config3", scale)
    logdir = os.path.join(work, "build_split")
    os.makedirs(logdir, exist_ok=True)
    roots = [os.path.abspath(r) for r in opt.roots]
    for root in roots:
        warm(root)
    got = collections.defaultdict(list)
    for run in range(opt.runs):
        for i, root in enumerate(roots):
            tag = f"tree{i}_run{run}"
            db = os.path.join(logdir, f"db_{tag}")
            rec = run_tree(root, tag, [
                "build", db, os.path.join(wdir, "genomes.fa"), "-taxonomy",
                os.path.join(wdir, "tax"), "-num-shards", str(opt.shards),
                "-device", device], logdir)
            for name in os.listdir(logdir):
                if name.startswith(f"db_{tag}_"):
                    os.remove(os.path.join(logdir, name))
            rec.update(root=root, gbps=gbp / rec["wall_s"])
            got[root].append(rec)
            say(tag, root=root, wall_s=f"{rec['wall_s']:.3f}",
                gbps=f"{rec['gbps']:.5f}", start_s=f"{rec['start_s']:.3f}",
                cli_s=f"{rec['cli_s']:.3f}", exit_s=f"{rec['exit_s']:.3f}",
                peak_host_rss_mb=f"{rec['peak_host_rss_mb']:.1f}",
                peak_at_s=f"{rec['peak_host_rss_at_s']:.3f}",
                **{f"{k}_s": f"{v['total_s']:.3f}/{v['n']}/cpu{v['cpu_s']:.3f}"
                   for k, v in rec["series"].items()},
                **{k: (f"{v:.3f}" if isinstance(v, float) else v)
                   for k, v in pass_threads(rec).items()})
            for t in rec["threads"]:
                say(f"{tag}_thread", **t)
    print(json.dumps(dict(device=info, gbp=gbp, shards=opt.shards,
                          runs=got)), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2], sys.argv[3], float(sys.argv[4]),
                        sys.argv[5:]))
    sys.exit(main())
