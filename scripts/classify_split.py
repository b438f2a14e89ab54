#!/usr/bin/env python3
"""The query CLI's classify span ('# time:') split by thread and by step,
per batch, for one or more trees of the port on a query cell of
BENCHMARK.json:

    python3 scripts/classify_split.py --cell NAME [--cell NAME ...]
        [--trace] [--switch-interval S] [--env KEY=VALUE ...]
        [--device cuda|cpu] [--rehearse] ROOT [ROOT ...]

The worlds and databases are the benchmark's (bench_torch.runner's
make_world and ensure_db, under build/bench_torch/). For each cell, each
tree runs the cell's query once untimed (kernels built, files in the page
cache), then once more with its functions wrapped in its own process
(--worker), which records per batch, in ms on the host's clock:

  reader_next        NativeBatchReader.__next__ (the reader thread's parse)
  reader_put_wait    the reader thread blocked handing a batch on
  dispatch_get_wait  the dispatching thread blocked waiting for a batch
  dispatch           dispatch_packed (the host's enqueueing of a batch)
  reserve_wait       the dispatching thread blocked on the writer's
                     in-flight limit (a tree with a writer thread)
  writer_get_wait    the writer thread blocked waiting for a batch
  materialize        BatchResult.__init__ (the wait for the batch's
                     summary, then its copy)
  format_write       _postprocess_fast_native (taxon strings, the native
                     formatter, the write)
  finalize           _finalize_window (materialize + format + write)
  library_load       each kernel library's first load (ctypes)

and on a card, from CUDA events recorded on the dispatching thread's
stream around each dispatch_packed: device_batch (the device from a
batch's first queued operation to its last) and device_gap (from one
batch's last to the next one's first: the device idle between batches),
with the span's head and tail. The first batch's extra cost is its
dispatch less the median of the others. The record also holds each
step's start and end per batch ('timeline', ms from the span's start on
the host's clock; the device's events from the span's start event).
--switch-interval S runs the split of every tree a second time with
Python's thread switch interval set to S seconds (sys.setswitchinterval:
how long a thread that waits for the GIL lets the holder run); --env
KEY=VALUE (repeatable) runs it once more with those variables in its
environment (CUDA_MODULE_LOADING=EAGER, say, which loads every kernel
module when the CUDA context is made, before the span). With
--trace each tree also runs the query through `python3 -m
bench_torch.probe --trace` (the benchmark's traced trial: the device's
idle share over the span and its longest idle gaps), and the host
operations inside its dispatch spans are summed by name
('dispatch_host_ops', the costliest first). Fails unless every run of
a cell wrote the same mapping lines. Last, one JSON line with every
run's numbers.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import queue
import statistics
import subprocess
import sys
import threading
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SERIES = ("reader_next", "reader_put_wait", "dispatch_get_wait", "dispatch",
          "reserve_wait", "writer_get_wait", "materialize", "format_write",
          "finalize", "library_load", "device_batch", "device_gap")


def summarize(ms):
    if not ms:
        return None
    rest = ms[1:] or ms
    return dict(n=len(ms), total_ms=sum(ms), median_ms=statistics.median(ms),
                max_ms=max(ms), first_ms=ms[0],
                median_rest_ms=statistics.median(rest))


def worker(out_json: str, root: str, args) -> int:
    """The port of `root`'s CLI in this process, its steps timed."""
    if args[0] == "--switch-interval":
        sys.setswitchinterval(float(args[1]))
        args = args[2:]
    sys.path.insert(0, root)
    import torch
    import metacache_tpu_torch
    from metacache_tpu_torch import cli, native
    from metacache_tpu_torch.modes import query as qm
    from metacache_tpu_torch.ops import cuda_build
    from metacache_tpu_torch.parallel import ShardedQueryEngine
    from metacache_tpu_torch.query import engine as em
    assert metacache_tpu_torch.__file__.startswith(os.path.abspath(root))
    series = collections.defaultdict(list)
    timeline = collections.defaultdict(list)
    lock = threading.Lock()
    cuda = torch.cuda.is_available()
    marks = []          # (start event, end event) per dispatched batch
    span = {}

    def add(name, t0):
        t1 = time.perf_counter()
        with lock:
            series[name].append((t1 - t0) * 1e3)
            if "t0" in span:
                timeline[name].append(((t0 - span["t0"]) * 1e3,
                                       (t1 - span["t0"]) * 1e3))

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                add(name, t0)
        return run

    class TimedQueue(queue.Queue):
        """The query driver's hand-off queues, named by what is put in
        them."""
        def put(self, item, *a, **k):
            if not hasattr(self, "name") and item is not None \
                    and not isinstance(item, BaseException):
                self.name = "reader" if isinstance(item, native.PackedBatch) \
                    else "writer"
            t0 = time.perf_counter()
            super().put(item, *a, **k)
            if getattr(self, "name", "") == "reader":
                add("reader_put_wait", t0)

        def get(self, *a, **k):
            t0 = time.perf_counter()
            item = super().get(*a, **k)
            name = getattr(self, "name", "")
            if name:
                add("dispatch_get_wait" if name == "reader"
                    else "writer_get_wait", t0)
            return item

    def dispatch(fn):
        def run(*a, **k):
            ev = None
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            add("dispatch", t0)
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                marks.append((ev, end))
            return out
        return run

    def whole(fn):
        def run(*a, **k):
            if cuda:
                span["start"] = torch.cuda.Event(enable_timing=True)
                span["start"].record()
            t0 = span["t0"] = time.perf_counter()
            out = fn(*a, **k)
            span["host_ms"] = (time.perf_counter() - t0) * 1e3
            if cuda:
                span["end"] = torch.cuda.Event(enable_timing=True)
                span["end"].record()
                torch.cuda.synchronize()
            return out
        return run

    def first_load(fn):
        def run(self):
            if self._lib is not None:
                return fn(self)
            t0 = time.perf_counter()
            try:
                return fn(self)
            finally:
                add("library_load", t0)
        return run

    qm.queue = types.SimpleNamespace(Queue=TimedQueue, Empty=queue.Empty)
    native.NativeBatchReader.__next__ = timed(
        "reader_next", native.NativeBatchReader.__next__)
    for cls in (em.QueryEngine, ShardedQueryEngine):
        cls.dispatch_packed = dispatch(cls.dispatch_packed)
    em.BatchResult.__init__ = timed("materialize", em.BatchResult.__init__)
    P = qm.QueryProcessor
    P._postprocess_fast_native = timed("format_write",
                                       P._postprocess_fast_native)
    P._finalize_window = timed("finalize", P._finalize_window)
    P.process_files = whole(P.process_files)
    if hasattr(qm, "_Writer"):
        qm._Writer.reserve = timed("reserve_wait", qm._Writer.reserve)
    cuda_build.CudaLibrary.load = first_load(cuda_build.CudaLibrary.load)

    rc = cli.main(args)
    rec = dict(rc=rc, span_host_ms=span.get("host_ms"))
    if cuda and marks:
        series["device_batch"] = [a.elapsed_time(b) for a, b in marks]
        series["device_gap"] = [b.elapsed_time(a) for (_, b), (a, _)
                                in zip(marks, marks[1:])]
        rec["device_head_ms"] = span["start"].elapsed_time(marks[0][0])
        rec["device_tail_ms"] = marks[-1][1].elapsed_time(span["end"])
        idle = rec["device_head_ms"] + sum(series["device_gap"]) \
            + rec["device_tail_ms"]
        rec["device_idle_between_batches_share"] = \
            idle / span["start"].elapsed_time(span["end"])
        timeline["device_batch"] = [
            (span["start"].elapsed_time(a), span["start"].elapsed_time(b))
            for a, b in marks]
    rec["series"] = {k: summarize(series.get(k, [])) for k in SERIES}
    rec["timeline"] = {k: [[round(a, 3), round(b, 3)] for a, b in v]
                       for k, v in timeline.items()}
    d = series.get("dispatch", [])
    if len(d) > 1:
        rec["first_batch_extra_ms"] = d[0] - statistics.median(d[1:])
    with open(out_json, "w") as f:
        json.dump(rec, f)
    return rc


def run_tree(root, tag, argv, device, logdir, mode, switch=None,
             env=None):
    """One query of the tree at `root`: mode 'split' through this
    script's worker, 'trace' through its bench_torch.probe --trace,
    'warm' untimed -> (record, mapping-line digest)."""
    from bench_torch import runner
    rec_path = os.path.join(logdir, f"{tag}.json")
    out = os.path.join(logdir, f"{tag}.txt")
    args = argv + ["-out", out, "-device", device]
    if mode == "split":
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               rec_path, root] \
            + (["--switch-interval", str(switch)] if switch else []) + args
    else:
        opts = ["--trace", os.path.join(logdir, f"{tag}_trace.json")] \
            if mode == "trace" else []
        cmd = [sys.executable, "-m", "bench_torch.probe", rec_path] \
            + opts + args
    t0 = time.time()
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       timeout=runner.CLI_TIMEOUT,
                       env=dict(os.environ, **(env or {})))
    runner.check(r.returncode == 0, f"{tag}: exit {r.returncode}\n"
                 f"{r.stderr[-3000:]}")
    with open(rec_path) as f:
        rec = json.load(f)
    res = runner.result_file(out, "-pairfiles" in argv)
    os.remove(out)
    if mode == "trace":
        rec["dispatch_host_ops"] = dispatch_host_ops(opts[1])
    rec.update(wall_s=time.time() - t0, time_s=res["classify_s"],
               lines=res["lines"])
    return rec, res["digest"]


def dispatch_host_ops(trace_path, top=16):
    """The host operations (torch.profiler's cpu_op events) whose start
    lies inside a bench.dispatch span of the same thread -> the costliest
    `top` by name: total ms and count (nested operations count in their
    parent too)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("name") == "bench.dispatch":
            spans[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    got = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") == "cpu_op" and any(
                a <= e["ts"] < b for a, b in spans.get(e["tid"], ())):
            got[e["name"]][0] += e["dur"] / 1e3
            got[e["name"]][1] += 1
    return [dict(name=n, ms=round(ms, 3), count=c) for n, (ms, c) in
            sorted(got.items(), key=lambda kv: -kv[1][0])[:top]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/classify_split.py")
    ap.add_argument("--cell", action="append", required=True)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--switch-interval", type=float)
    ap.add_argument("--env", action="append", default=[])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--work", default=os.path.join(REPO, "build",
                                                   "bench_torch"))
    ap.add_argument("roots", nargs="+")
    opt = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from bench_torch import runner
    import torch
    device = "cpu" if opt.rehearse else opt.device
    if device == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    spec = runner.load_spec()
    cells = {c["name"]: c for c in spec["workloads"] if c["mode"] == "query"}
    info = runner.device_info(device)
    print(info.get("nvidia_smi", info["kind"]), flush=True)
    roots = [os.path.abspath(r) for r in opt.roots]
    got = {}
    try:
        for name in opt.cell:
            cell = cells[name]
            wdir, scale = runner.make_world(os.path.abspath(opt.work),
                                            cell["world"], spec["seed"],
                                            opt.rehearse)
            db = runner.ensure_db(wdir, cell["shards"], device)
            flags = list(spec["flags"])
            if opt.rehearse:
                flags[flags.index("-batch-size") + 1] = \
                    runner.REHEARSAL_BATCH
            argv_q = ["query", db] + [os.path.join(wdir, r)
                                      for r in cell["reads"]] \
                + flags + cell["flags"]
            logdir = os.path.join(os.path.abspath(opt.work), "split", name)
            os.makedirs(logdir, exist_ok=True)
            env = dict(kv.split("=", 1) for kv in opt.env)
            modes = ("warm", "split") \
                + (("switch",) if opt.switch_interval else ()) \
                + (("env",) if env else ()) \
                + (("trace",) if opt.trace else ())
            digest = None
            for mode in modes:
                for i, root in enumerate(roots):
                    rec, dg = run_tree(
                        root, f"{mode}{i}", argv_q, device, logdir,
                        "split" if mode in ("switch", "env") else mode,
                        opt.switch_interval if mode == "switch" else None,
                        env if mode == "env" else None)
                    digest = digest or dg
                    runner.check(dg == digest, f"{name} {mode}{i}: other "
                                 "mapping lines than the first run")
                    if mode == "warm":
                        continue
                    got.setdefault(name, {}).setdefault(root, {})[mode] = rec
                    show(name, root, mode, rec)
    except runner.BenchFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(dict(device=info, on=device, runs=got)), flush=True)
    return 0


def show(name, root, mode, rec):
    from bench_torch import runner
    fields = dict(tree=os.path.basename(root) or root, mode=mode,
                  wall_s=f"{rec['wall_s']:.3f}", time_s=rec["time_s"])
    if mode in ("split", "switch", "env"):
        for k, s in rec["series"].items():
            if s:
                fields[k] = (f"n{s['n']}/sum{s['total_ms']:.1f}/"
                             f"med{s['median_ms']:.2f}/max{s['max_ms']:.1f}/"
                             f"first{s['first_ms']:.1f}")
        for k in ("first_batch_extra_ms", "device_head_ms",
                  "device_tail_ms", "device_idle_between_batches_share"):
            if k in rec:
                fields[k] = f"{rec[k]:.4f}"
    else:
        dev = rec.get("layers", {}).get("device", {})
        fields["device_idle_share"] = dev.get("device_idle_share")
        fields["longest_idle_gaps"] = json.dumps(
            dev.get("longest_idle_gaps", [])[:4]).replace(" ", "")
        fields["stage_ms_per_batch"] = json.dumps(
            rec.get("layers", {}).get("stage_ms_per_batch")).replace(" ", "")
        fields["dispatch_host_ops"] = json.dumps(
            rec["dispatch_host_ops"][:10]).replace(" ", "")
    runner.say(name, **fields)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
