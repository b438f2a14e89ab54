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

from .cuda_build import CudaLibrary
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
    dev = table.device
    if idx.dim() != 2:
        raise ValueError(f"gather_rows: idx must be [B, L], got "
                         f"{tuple(idx.shape)}")
    B, L = idx.shape
    for name, t, dtypes, shape in (
            ("table", table, tuple(_ENTRY), (table.numel(),)),
            ("idx", idx, (torch.int64,), (B, L)),
            ("n_valid", n_valid, (torch.int64,), (B,))):
        if t.device != dev or t.dtype not in dtypes \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"gather_rows: {name} must be a contiguous tensor of shape "
                f"{shape} and dtype {' or '.join(map(str, dtypes))} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if table.numel() == 0 and B * L:
        raise ValueError("gather_rows: empty table")
    info = torch.iinfo(table.dtype)
    if not info.min <= pad <= info.max:
        raise ValueError(f"gather_rows: pad {pad} does not fit {table.dtype}")
    out = torch.empty((B, L), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = getattr(LIBRARY.load(), _ENTRY[table.dtype])
    with torch.cuda.device(dev):
        rc = fn(table.data_ptr(), idx.data_ptr(), n_valid.data_ptr(),
                out.data_ptr(), B, L, int(pad),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
