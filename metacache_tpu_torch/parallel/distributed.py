"""Multi-process launch: the reference's MPI model on torch.distributed.

Counterpart of metacache_tpu/parallel/distributed.py, with the same
environment variables:

  mpirun -np P metacache_mpi ...        MC_NUM_PROCS=P MC_PROC_ID=r
    (MPI_Init, main.cpp:48)             MC_COORDINATOR=host:port
                                        python -m metacache_tpu_torch.cli ...
  rank r builds + owns DB shards        rank r builds and serves the shards
    t % P == r (mode_build.cpp:1079)     s with s % P == r
  every rank reads the same queries    every rank streams the same reads
  log2(P) candidate tree reduce        all_gather of [B, C] candidates
    (querying.h:892-1071)               + the deterministic merge
  rank 0 writes output                 rank 0 writes output

The backend is chosen by rule when the process group starts: nccl when
the ranks run on CUDA and each has a card of its own (world size <=
torch.cuda.device_count()); gloo otherwise, on the CPU or when ranks share
a card. Over gloo, the collectives' CUDA tensors are staged through pinned
host memory. A failing nccl start is an error, never a switch to gloo.

Without MC_COORDINATOR nothing starts and every helper is the identity of
a one-process world.
"""
from __future__ import annotations

import atexit
import os
import sys
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist


def choose_backend(device: str, world: int, cards: int) -> str:
    """nccl if the ranks run on CUDA and each has a card of its own,
    gloo otherwise."""
    return "nccl" if device == "cuda" and 0 < world <= cards else "gloo"


def maybe_initialize(device: str = "cuda") -> None:
    """Start the process group from MC_* variables if MC_COORDINATOR is
    set (the reference's MPI_Init); otherwise do nothing.

    MC_COORDINATOR=<host:port>  rank 0's address
    MC_NUM_PROCS=<P>            number of processes
    MC_PROC_ID=<r>              this process's rank
    MC_LOCAL_DEVICE_IDS         optional comma-separated card ids of this
                                rank (default: card r % device count)

    `device` is the run's -device (cuda | cpu). The group is destroyed
    when the process exits."""
    coord = os.environ.get("MC_COORDINATOR")
    if not coord or dist.is_initialized():
        return
    world = int(os.environ["MC_NUM_PROCS"])
    rank = int(os.environ["MC_PROC_ID"])
    cards = torch.cuda.device_count() if device == "cuda" else 0
    backend = choose_backend(device, world, cards)
    if backend == "nccl":
        torch.cuda.set_device(local_devices(device, rank)[0])
    print(f"[distributed] rank {rank} of {world}, backend {backend} "
          f"({cards} card(s) for {world} rank(s) on {device})",
          file=sys.stderr, flush=True)
    dist.init_process_group(backend=backend, init_method=f"tcp://{coord}",
                            world_size=world, rank=rank)
    atexit.register(dist.destroy_process_group)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """Only rank 0 writes results (querying.h:1088-1136)."""
    return rank() == 0


def local_shard_ids(num_shards: int) -> List[int]:
    """The shards this rank owns: s % world == rank (the reference's
    t % P == rank file ownership, mode_query.cpp:421-426)."""
    return [s for s in range(num_shards) if s % world_size() == rank()]


def local_devices(device: str, r: int = None) -> List[torch.device]:
    """This rank's devices: its MC_LOCAL_DEVICE_IDS cards, else card
    r % device count; the CPU for -device cpu."""
    if device != "cuda":
        return [torch.device("cpu")]
    r = rank() if r is None else r
    ids = [int(x) for x in os.environ.get("MC_LOCAL_DEVICE_IDS",
                                          "").split(",") if x.strip()]
    ids = ids or [r % torch.cuda.device_count()]
    return [torch.device("cuda", i) for i in ids]


def _staged(t: torch.Tensor):
    """A copy of t where the backend's collectives take it: on the rank's
    card for nccl, in host memory (pinned, for a CUDA tensor) for gloo."""
    if dist.get_backend() == "nccl":
        card = torch.device("cuda", torch.cuda.current_device())
        return t.to(card, copy=True, memory_format=torch.contiguous_format)
    host = torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")
    return host.copy_(t)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Element-wise sum over ranks (JAX psum), on t's device."""
    if world_size() == 1:
        return t
    s = _staged(t)
    dist.all_reduce(s)
    return s.to(t.device)


def all_gather_candidates(cand: dict) -> dict:
    """[B, C] candidate fields of every rank side by side -> [B, P*C], in
    rank order, on the device of the fields (one collective)."""
    if world_size() == 1:
        return cand
    names = list(cand)
    stacked = torch.stack([cand[n] for n in names])
    s = _staged(stacked)
    parts = [torch.empty_like(s) for _ in range(world_size())]
    dist.all_gather(parts, s)
    joined = torch.cat(parts, dim=2).to(stacked.device)
    return {n: joined[i] for i, n in enumerate(names)}


def all_gather_int64(rows: np.ndarray) -> np.ndarray:
    """Concatenate every rank's [n_r, K] int64 host array, in rank order
    (the build's (key, count) dumps; n_r may differ, so rows are padded to
    the largest n_r for the collective and the padding dropped)."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if world_size() == 1:
        return rows
    n = _staged(torch.tensor([rows.shape[0]], dtype=torch.int64))
    counts = [torch.empty_like(n) for _ in range(world_size())]
    dist.all_gather(counts, n)
    counts = [int(c.item()) for c in counts]
    pad = np.zeros((max(counts),) + rows.shape[1:], np.int64)
    pad[:rows.shape[0]] = rows
    s = _staged(torch.from_numpy(pad))
    parts = [torch.empty_like(s) for _ in range(world_size())]
    dist.all_gather(parts, s)
    return np.concatenate([p.cpu().numpy()[:c] for p, c in
                           zip(parts, counts)])


def place_shards(shard_ids: Sequence[int], device: str
                 ) -> List[torch.device]:
    """A device for each shard: single process, shard s on card
    s % device count; with several ranks, the rank's devices in turn. The
    CPU for -device cpu."""
    if device != "cuda":
        return [torch.device("cpu")] * len(shard_ids)
    if world_size() == 1:
        n = torch.cuda.device_count()
        return [torch.device("cuda", s % n) for s in shard_ids]
    mine = local_devices(device)
    return [mine[i % len(mine)] for i in range(len(shard_ids))]
