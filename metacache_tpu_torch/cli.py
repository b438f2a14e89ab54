"""Command line entry of the port: mode dispatch (src/main.cpp:41-106).

Usage: python -m metacache_tpu_torch.cli <mode> ... [-device cuda|cpu]

`build`, `modify`, `query`, `info` and `merge` run their device work on
-device (default cuda); `help` and `annotate` are host-only.

Multi-process launch (the reference's mpirun): start P processes with
MC_COORDINATOR=<host:port> MC_NUM_PROCS=P MC_PROC_ID=<r>; the process
group starts here, before any mode runs (parallel/distributed.py). Then
`build` writes the shards s % P == r on rank r and `query -mesh` serves
them there.
"""
from __future__ import annotations

import sys

from .utils import ArgsParser

MODES = ("help", "build", "modify", "query", "info", "annotate", "merge")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ArgsParser(argv)
    if not args.positionals:
        print("metacache_tpu_torch — metagenomic classifier (PyTorch/CUDA)\n"
              f"available modes: {', '.join(MODES)}\n"
              "usage: python -m metacache_tpu_torch.cli <mode> ... "
              "[-device cuda|cpu]", file=sys.stderr)
        return 1
    from .parallel.distributed import maybe_initialize
    maybe_initialize(args.get("device", "cuda"))
    mode = args.positionals[0]
    if mode == "build":
        from .modes.build import main_mode_build
        return main_mode_build(args)
    if mode == "modify":
        from .modes.modify import main_mode_modify
        return main_mode_modify(args)
    if mode == "query":
        from .modes.query import main_mode_query
        return main_mode_query(args)
    if mode == "info":
        from .modes.info import main_mode_info
        return main_mode_info(args)
    if mode == "merge":
        from .modes.merge import main_mode_merge
        return main_mode_merge(args)
    if mode == "help":
        from .modes.help import main_mode_help
        return main_mode_help(args)
    if mode == "annotate":
        from .modes.annotate import main_mode_annotate
        return main_mode_annotate(args)
    print(f"unknown mode '{mode}'; available: {', '.join(MODES)}",
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
