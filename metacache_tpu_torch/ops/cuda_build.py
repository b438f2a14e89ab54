"""Build-at-first-use of the port's native libraries.

Each kernel source in csrc/ is compiled with nvcc for sm_90a into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under build/metacache_tpu_torch/ beside the package, and loaded
with ctypes; the host library native/mcio.cpp is compiled there with g++
the same way (build_library). A library's file name carries a hash of the
source and the flags, so an edit rebuilds; a build writes to a temporary
name and renames it into place, so concurrent builders never load a
half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "metacache_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from csrc/ at first use")
    return path


def build_library(source: str, stem: str, compiler: str,
                  flags: Sequence[str],
                  libs: Sequence[str] = ()) -> Tuple[str, str]:
    """Compile `source` into BUILD_DIR/<stem>_<hash>.so unless that file
    exists. Returns (path, the compiler's output, "" if nothing was built);
    raises RuntimeError if the compiler fails."""
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join([*flags, *libs]).encode())
    path = os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    r = subprocess.run([compiler, *flags, "-o", tmp, source, *libs],
                       capture_output=True, text=True)
    log = r.stdout + r.stderr
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{compiler} failed on {source}:\n{log}")
    os.replace(tmp, path)
    return path, log


class CudaLibrary:
    """One kernel source and its ctypes library, built and loaded once.

    `declare` sets argtypes / restype of the library's C functions."""

    def __init__(self, source: str, stem: str,
                 declare: Callable[[ctypes.CDLL], None]):
        self.source = os.path.join(CSRC_DIR, source)
        self.stem = stem
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        #: nvcc's output (ptxas register / local-memory report) of the
        #: build made by this process, "" if the library was already built
        self.build_log = ""

    def path(self) -> str:
        """Build (if needed) and return the library's path."""
        path, log = build_library(self.source, self.stem, nvcc(), NVCC_FLAGS)
        self.build_log = log or self.build_log
        return path

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(self.path())
                    self._declare(lib)
                    self._lib = lib
        return self._lib


def launch(device: int, fn, *args) -> None:
    """Call the C launcher `fn(*args, stream)` with card `device` current
    and the raw handle of its current stream (the capture stream under a
    CUDA graph), read without making a Stream object; the device context
    is switched only when `device` is not the current one. Raises if the
    launcher returns a CUDA error."""
    import torch
    if device == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {rc}")


def describe(**tensors) -> str:
    """'name dtype shape on device' of each tensor, for a wrapper's
    error message."""
    return ", ".join(f"{name} {t.dtype} {tuple(t.shape)} on {t.device}"
                     f"{'' if t.is_contiguous() else ' (strided)'}"
                     for name, t in tensors.items())
