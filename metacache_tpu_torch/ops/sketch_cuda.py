"""Wrappers of the hand-written CUDA sketch kernels (csrc/sketch.cu).

sketch_packed (the query's reads) is the counterpart of
metacache_tpu/ops/sketch_pallas.py::sketch_packed_pallas; sketch_windows
(the build's reference windows) computes the same per-window function
over whole records, where the JAX build sketches packed windows with
that kernel or natively on the host. The kernels are built at first use
(ops/cuda_build.py). CPU tensors go to the plain versions
(ops/sketch.py::sketch_packed_reference, sketch_windows_reference); CUDA
tensors go to the kernels or raise.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from .cuda_build import CudaLibrary, describe, launch
from .sketch import sketch_packed_reference, sketch_windows_reference

#: must equal kMaxSketch in csrc/sketch.cu
MAX_SKETCH_SIZE = 256

#: number of kernel launches made by sketch_packed (not by the plain path)
launches = 0
#: number of kernel launches made by sketch_windows (not by the plain path)
window_launches = 0

_starts_cache: Dict[Tuple[int, Tuple[int, ...]], torch.Tensor] = {}


def _declare(lib: ctypes.CDLL) -> None:
    lib.mc_sketch_packed.restype = ctypes.c_int
    lib.mc_sketch_packed.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.mc_sketch_windows.restype = ctypes.c_int
    lib.mc_sketch_windows.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)


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


def sketch_windows(seq: torch.Tensor, rec_off: torch.Tensor,
                   rec_len: torch.Tensor, win_off: torch.Tensor, *,
                   n_windows: int, k: int, sketch_size: int,
                   window_size: int, stride: int) -> torch.Tensor:
    """Sketch of every window of whole reference records (the build).

    seq [bytes] uint8 (ASCII, as read), rec_off / rec_len [R] int64,
    win_off [R + 1] int64 window prefix counts (win_off[0] = 0,
    win_off[R] = n_windows, which the caller passes from the host so that
    the launch needs no wait for the card) -> [n_windows, sketch_size]
    int32 (u32 bit patterns, each window's sketch ascending, padded with
    0xFFFFFFFF = -1); window w of record r starts at rec_off[r] +
    w * stride and holds min(window_size, rec_len[r] - w * stride)
    characters."""
    global window_launches
    kw = dict(n_windows=n_windows, k=k, sketch_size=sketch_size,
              window_size=window_size, stride=stride)
    if seq.device.type == "cpu":
        return sketch_windows_reference(seq, rec_off, rec_len, win_off, **kw)
    if seq.device.type != "cuda":
        raise ValueError(f"sketch_windows: unsupported device {seq.device}")
    d = seq.get_device()
    R = rec_off.shape[0] if rec_off.dim() == 1 else -1
    if not (seq.dim() == 1 and seq.dtype is torch.uint8
            and all(t.get_device() == d and t.dtype is torch.int64
                    and t.dim() == 1 and t.is_contiguous()
                    for t in (rec_off, rec_len, win_off))
            and rec_len.shape == (R,) and win_off.shape == (R + 1,)
            and seq.is_contiguous() and 1 <= k <= 16
            and 1 <= sketch_size <= MAX_SKETCH_SIZE and window_size >= 1
            and stride >= 1):
        raise ValueError(
            "sketch_windows takes contiguous uint8 seq [bytes], int64 "
            "rec_off / rec_len [R] and win_off [R + 1] on one device, "
            f"1 <= k <= 16 and 1 <= sketch_size <= {MAX_SKETCH_SIZE}; got "
            + describe(seq=seq, rec_off=rec_off, rec_len=rec_len,
                       win_off=win_off) + f", {kw}")
    out = torch.empty((n_windows, sketch_size), dtype=torch.int32,
                      device=seq.device)
    if n_windows == 0:
        return out
    launch(d, LIBRARY.load().mc_sketch_windows, seq.data_ptr(),
           rec_off.data_ptr(), rec_len.data_ptr(), win_off.data_ptr(), R,
           n_windows, k, sketch_size, window_size, stride, out.data_ptr())
    window_launches += 1
    return out
