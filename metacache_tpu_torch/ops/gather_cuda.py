"""Wrapper of the hand-written CUDA gather kernel (csrc/gather.cu).

Counterpart of the Pallas gather probes k1 / k2 of
tools/exp_pallas_gather.py. The kernel is built at first use
(ops/cuda_build.py). CPU tensors go to the plain version
(ops/gather.py::gather_rows_reference); CUDA tensors go to the kernel or
raise.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, describe, launch
from .gather import gather_rows_reference

#: number of kernel launches made by gather_rows (not by the plain path)
launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    for name, pad in (("mc_gather_rows_i32", ctypes.c_int),
                      ("mc_gather_rows_i64", ctypes.c_longlong)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                ctypes.c_int, pad,
                                                ctypes.c_void_p]


LIBRARY = CudaLibrary("gather.cu", "libmc_gather", _declare)

_ENTRY = {torch.int32: "mc_gather_rows_i32", torch.int64: "mc_gather_rows_i64"}
#: the loaded C launchers, by table dtype
_FNS = {}


def _launcher(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = _FNS[dtype] = getattr(LIBRARY.load(), _ENTRY[dtype])
    return fn


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                n_valid: torch.Tensor, pad: int) -> torch.Tensor:
    """out[b, j] = table[idx[b, j]] if j < n_valid[b] else pad.

    table [N] int32 or int64, idx [B, L] int64, n_valid [B] int64, all
    contiguous and on one device -> [B, L] of table's dtype. On the card,
    the index of every slot below n_valid[b] must lie in [0, N)."""
    global launches
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx, n_valid, pad)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    # the checks in one expression of cheap reads (no torch.device or
    # iinfo objects): this path runs once per batch and shard
    d = table.get_device()
    dtype = table.dtype
    if not (idx.dim() == 2 and idx.get_device() == d
            and n_valid.get_device() == d and dtype in _ENTRY
            and idx.dtype is torch.int64 and n_valid.dtype is torch.int64
            and table.dim() == 1 and n_valid.shape == idx.shape[:1]
            and table.is_contiguous() and idx.is_contiguous()
            and n_valid.is_contiguous()
            and (table.numel() > 0 or idx.numel() == 0)
            and -(1 << (8 * table.element_size() - 1)) <= pad
            < 1 << (8 * table.element_size() - 1)):
        raise ValueError(
            "gather_rows takes a contiguous int32 or int64 table [N] (N > 0 "
            "unless idx is empty), int64 idx [B, L] and n_valid [B] on one "
            f"device, and a pad that fits the table's dtype; got "
            f"{describe(table=table, idx=idx, n_valid=n_valid)}, pad {pad}")
    B, L = idx.shape
    out = torch.empty((B, L), dtype=dtype, device=table.device)
    if out.numel() == 0:
        return out
    launch(d, _launcher(dtype), table.data_ptr(), idx.data_ptr(),
           n_valid.data_ptr(), out.data_ptr(), B, L, int(pad))
    launches += 1
    return out
