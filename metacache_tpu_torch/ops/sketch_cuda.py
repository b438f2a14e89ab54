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

from .cuda_build import CudaLibrary
from .sketch import sketch_packed_reference

#: must equal kMaxSketchLarge in csrc/sketch.cu (sizes up to 64 run the
#: kMaxSketch instantiation)
MAX_SKETCH_SIZE = 256

#: number of kernel launches made by sketch_packed (not by the plain path)
launches = 0

_starts_cache: Dict[Tuple[int, Tuple[int, ...]], torch.Tensor] = {}


def _declare(lib: ctypes.CDLL) -> None:
    lib.mc_sketch_packed.restype = ctypes.c_int
    lib.mc_sketch_packed.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


LIBRARY = CudaLibrary("sketch.cu", "libmc_sketch", _declare)


def _starts_tensor(device: torch.device,
                   starts: Tuple[int, ...]) -> torch.Tensor:
    key = (device.index, starts)
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
    starts = tuple(int(s) for s in starts)
    if packed.device.type == "cpu":
        return sketch_packed_reference(
            packed, ambig, lens, k=k, sketch_size=sketch_size,
            window_size=window_size, starts=starts)
    if packed.device.type != "cuda":
        raise ValueError(f"sketch_packed: unsupported device {packed.device}")
    B, P4 = packed.shape
    dev = packed.device
    for name, t, dtype, shape in (("packed", packed, torch.uint8, (B, P4)),
                                  ("ambig", ambig, torch.uint8, (B, P4 // 2)),
                                  ("lens", lens, torch.int32, (B,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"sketch_packed: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if P4 % 2 or not 1 <= k <= 16 or not 1 <= sketch_size <= MAX_SKETCH_SIZE:
        raise ValueError(f"sketch_packed: unsupported L={P4 * 4} k={k} "
                         f"sketch_size={sketch_size} (the CUDA kernel takes "
                         f"L % 8 == 0, 1 <= k <= 16 and sketch sizes up to "
                         f"{MAX_SKETCH_SIZE})")
    out = torch.empty((B, len(starts) * sketch_size), dtype=torch.int64,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.mc_sketch_packed(
            packed.data_ptr(), ambig.data_ptr(), lens.data_ptr(),
            _starts_tensor(dev, starts).data_ptr(), out.data_ptr(),
            B, P4, P4 // 2, len(starts), k, sketch_size, window_size,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sketch kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
