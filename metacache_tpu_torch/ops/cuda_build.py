"""Build-at-first-use of the port's hand-written CUDA kernels.

Each kernel source in csrc/ is compiled with nvcc for sm_90a into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under build/metacache_tpu_torch/ beside the package, and loaded
with ctypes. The library's file name carries a hash of the source and the
flags, so an edit rebuilds; a build writes to a temporary name and renames
it into place, so concurrent builders never load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional

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
        with open(self.source, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
        path = os.path.join(BUILD_DIR,
                            f"{self.stem}_{digest.hexdigest()[:12]}.so")
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                           capture_output=True, text=True)
        self.build_log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n"
                               f"{self.build_log}")
        os.replace(tmp, path)
        return path

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.path())
                self._declare(lib)
                self._lib = lib
        return self._lib
