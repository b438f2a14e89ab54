"""Wrapper of the hand-written CUDA shard-merge kernels (csrc/merge.cu).

No TPU kernel is replaced: the JAX package merges shards on the host.
The kernels are built at first use (ops/cuda_build.py). CPU tensors go to
the plain versions (ops/merge.py); CUDA tensors go to the kernels or
raise.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, describe, launch
from .merge import count_keys_reference, merge_chunk_reference

#: kernel launches made by merge_chunk and count_keys (not by the plain
#: paths)
merge_launches = 0
count_launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    lib.mc_merge_scratch_bytes.restype = ctypes.c_longlong
    lib.mc_merge_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.mc_merge_locations.restype = ctypes.c_int
    lib.mc_merge_locations.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p] * 4)
    lib.mc_merge_count_keys.restype = ctypes.c_int
    lib.mc_merge_count_keys.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_void_p] * 2)


LIBRARY = CudaLibrary("merge.cu", "libmc_merge", _declare)


def _check(what: str, ok: bool, **tensors) -> None:
    if not ok:
        raise ValueError(f"{what} takes contiguous tensors on one card: "
                         "int32 keys [NK], int64 offs [NK + P], int32 tgt "
                         "and win [NL], int64 bounds [2, P + 1] (and an "
                         f"int64 out_loc [NL]); got {describe(**tensors)}")


def merge_chunk(keys: torch.Tensor, offs: torch.Tensor, tgt: torch.Tensor,
                win: torch.Tensor, bounds: torch.Tensor,
                out_loc: torch.Tensor) -> torch.Tensor:
    """One chunk of P shard tables merged (ops/merge.py has the layout):
    writes the packed locations in the fused order into out_loc [NL] int64
    and returns their keys [NL] int32 (u32 bits). On the card the kernels
    take a scratch buffer (the partition and the locations' keys; for
    P > 2 also the rounds' outputs), allocated here for the call."""
    global merge_launches
    if keys.device.type == "cpu":
        loc, key = merge_chunk_reference(keys, offs, tgt, win, bounds)
        out_loc.copy_(loc)
        return key
    all_ = dict(keys=keys, offs=offs, tgt=tgt, win=win, bounds=bounds,
                out_loc=out_loc)
    d = keys.get_device()
    P = bounds.shape[-1] - 1
    nl = tgt.numel()
    _check("merge_chunk", keys.device.type == "cuda"
           and all(t.get_device() == d and t.is_contiguous()
                   for t in all_.values())
           and keys.dtype is torch.int32 and offs.dtype is torch.int64
           and tgt.dtype is torch.int32 and win.dtype is torch.int32
           and bounds.dtype is torch.int64 and out_loc.dtype is torch.int64
           and bounds.shape == (2, P + 1) and P >= 1
           and offs.numel() == keys.numel() + P and win.numel() == nl
           and out_loc.numel() == nl, **all_)
    out_key = torch.empty(nl, dtype=torch.int32, device=keys.device)
    if nl:
        lib = LIBRARY.load()
        scratch = torch.empty(lib.mc_merge_scratch_bytes(P, nl),
                              dtype=torch.uint8, device=keys.device)
        launch(d, lib.mc_merge_locations, keys.data_ptr(), offs.data_ptr(),
               tgt.data_ptr(), win.data_ptr(), bounds.data_ptr(), P,
               keys.numel(), nl, out_loc.data_ptr(), out_key.data_ptr(),
               scratch.data_ptr())
        merge_launches += 1
    return out_key


def count_keys(keys: torch.Tensor, bounds: torch.Tensor,
               count: torch.Tensor) -> None:
    """count [1] int64 += the distinct keys of one chunk (a key several
    shards hold counts once); bounds as merge_chunk's (row 0 is read).
    On the card one kernel launch (csrc/merge.cu): blocks take tiles of
    2,048 keys of the higher shards, find each lower shard's keys in the
    tile's key range by two warp-wide searches, stage them in shared
    memory and look the tile's keys up there; no scratch. 0.0204 ms on
    a seeded 2-shard chunk of 7.6 M keys, 44.6% of its bound (NVIDIA H100
    80GB HBM3, 700 W; PERF.md)."""
    global count_launches
    if keys.device.type == "cpu":
        count += count_keys_reference(keys)
        return
    all_ = dict(keys=keys, bounds=bounds, count=count)
    d = keys.get_device()
    P = bounds.shape[-1] - 1
    _check("count_keys", keys.device.type == "cuda"
           and all(t.get_device() == d and t.is_contiguous()
                   for t in all_.values())
           and keys.dtype is torch.int32 and bounds.dtype is torch.int64
           and count.dtype is torch.int64 and count.numel() == 1
           and bounds.shape == (2, P + 1) and P >= 1, **all_)
    if keys.numel():
        launch(d, LIBRARY.load().mc_merge_count_keys, keys.data_ptr(),
               bounds.data_ptr(), P, keys.numel(), count.data_ptr())
        count_launches += 1
