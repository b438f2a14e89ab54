"""Wrapper of the hand-written CUDA sketch kernel (csrc/sketch.cu).

Counterpart of metacache_tpu/ops/sketch_pallas.py::sketch_packed_pallas.
The kernel is compiled with nvcc for sm_90a at first use, from the source
in the package, into build/metacache_tpu_torch/ beside the package, and
loaded with ctypes (plain C interface; no PyTorch headers, so the build
takes seconds). CPU tensors go to the plain version
(ops/sketch.py::sketch_packed_reference); CUDA tensors go to the kernel
or raise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence, Tuple

import torch

from .sketch import sketch_packed_reference

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "sketch.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "metacache_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: must equal kMaxSketch in csrc/sketch.cu
MAX_SKETCH_SIZE = 64

#: number of kernel launches made by sketch_packed (not by the plain path)
launches = 0
#: nvcc's output (ptxas register / local-memory report) of the last build
build_log = ""

_lock = threading.Lock()
_lib = None
_starts_cache: Dict[Tuple[int, Tuple[int, ...]], torch.Tensor] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA sketch kernel is built "
                           "from csrc/sketch.cu at first use")
    return nvcc


def library_path() -> str:
    """Build (if needed) and return the kernel library. The file name
    carries a hash of the source and flags, so an edit rebuilds."""
    global build_log
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"libmc_sketch_{digest.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                       capture_output=True, text=True)
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{build_log}")
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(library_path())
            lib.mc_sketch_packed.restype = ctypes.c_int
            lib.mc_sketch_packed.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                + [ctypes.c_void_p])
            _lib = lib
    return _lib


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
                         f"sketch_size={sketch_size}")
    out = torch.empty((B, len(starts) * sketch_size), dtype=torch.int64,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = load_library()
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
