"""Wrapper of the hand-written CUDA sketch kernel (csrc/sketch.cu).

Counterpart of metacache_tpu/ops/sketch_pallas.py::sketch_packed_pallas.
The kernel is built at first use (ops/cuda_build.py). CPU tensors go to
the plain version (ops/sketch.py::sketch_packed_reference); CUDA tensors
go to the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from .cuda_build import CudaLibrary, describe, launch
from .sketch import sketch_packed_reference

#: must equal kMaxSketch in csrc/sketch.cu
MAX_SKETCH_SIZE = 256

#: number of kernel launches made by sketch_packed (not by the plain path)
launches = 0

_starts_cache: Dict[Tuple[int, Tuple[int, ...]], torch.Tensor] = {}


def _declare(lib: ctypes.CDLL) -> None:
    lib.mc_sketch_packed.restype = ctypes.c_int
    lib.mc_sketch_packed.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


LIBRARY = CudaLibrary("sketch.cu", "libmc_sketch", _declare)


def _starts_tensor(device: int, starts: Tuple[int, ...]) -> torch.Tensor:
    key = (device, starts)
    t = _starts_cache.get(key)
    if t is None:
        t = torch.tensor(starts, dtype=torch.int32, device=device)
        _starts_cache[key] = t
    return t


def sketch_packed(packed: torch.Tensor, ambig: torch.Tensor,
                  lens: torch.Tensor, *, k: int, sketch_size: int,
                  window_size: int, starts: Sequence[int]) -> torch.Tensor:
    """Fused sketch of 2-bit packed reads.

    packed [B, L/4] uint8, ambig [B, L/8] uint8, lens [B] int32 ->
    [B, len(starts) * sketch_size] int64 (u32 values; each window's
    block ascending, padded with 0xFFFFFFFF)."""
    global launches
    if type(starts) is not tuple:
        starts = tuple(int(s) for s in starts)
    if packed.device.type == "cpu":
        return sketch_packed_reference(
            packed, ambig, lens, k=k, sketch_size=sketch_size,
            window_size=window_size, starts=starts)
    if packed.device.type != "cuda":
        raise ValueError(f"sketch_packed: unsupported device {packed.device}")
    # the checks in one expression of cheap reads (no torch.device
    # objects): this path runs once per batch, mate and device
    d = packed.get_device()
    if not (packed.dim() == 2 and ambig.get_device() == d
            and lens.get_device() == d and packed.dtype is torch.uint8
            and ambig.dtype is torch.uint8 and lens.dtype is torch.int32
            and packed.shape[1] % 2 == 0
            and ambig.shape == (packed.shape[0], packed.shape[1] // 2)
            and lens.shape == packed.shape[:1] and packed.is_contiguous()
            and ambig.is_contiguous() and lens.is_contiguous()
            and 1 <= k <= 16 and 1 <= sketch_size <= MAX_SKETCH_SIZE):
        raise ValueError(
            "sketch_packed takes contiguous uint8 packed [B, L/4] with L % 8 "
            "== 0, uint8 ambig [B, L/8] and int32 lens [B] on one device, "
            f"1 <= k <= 16 and 1 <= sketch_size <= {MAX_SKETCH_SIZE}; got "
            + describe(packed=packed, ambig=ambig, lens=lens)
            + f", k {k}, sketch_size {sketch_size}")
    B, P4 = packed.shape
    out = torch.empty((B, len(starts) * sketch_size), dtype=torch.int64,
                      device=packed.device)
    if out.numel() == 0:
        return out
    launch(d, LIBRARY.load().mc_sketch_packed, packed.data_ptr(),
           ambig.data_ptr(), lens.data_ptr(),
           _starts_tensor(d, starts).data_ptr(), out.data_ptr(), B, P4,
           P4 // 2, len(starts), k, sketch_size, window_size)
    launches += 1
    return out
