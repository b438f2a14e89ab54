"""metacache_tpu_torch — the PyTorch + CUDA port of metacache_tpu.

Runs the `build` -> `query` main path of the JAX package on an NVIDIA GPU
(or, with the kernels' plain PyTorch versions, on the CPU). It reads and
writes the same database shard files and prints the same mapping lines.
It stands on its own: it imports neither JAX nor `metacache_tpu`. The
host half that never touched JAX there (config, database files, taxonomy,
the native library's source, output formatting, statistics, help and
annotate) is the port's own copy under the same relative paths; every
module that imports JAX there has a counterpart here under the same
name.
"""
__version__ = "0.1.0"
