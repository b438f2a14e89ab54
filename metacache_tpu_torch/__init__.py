"""metacache_tpu_torch — the PyTorch + CUDA port of metacache_tpu.

Runs the `build` -> `query` main path of the JAX package on an NVIDIA GPU
(or, with the kernels' plain PyTorch versions, on the CPU). It reads and
writes the same database shard files and prints the same mapping lines.
The host half that never touched JAX (database files, taxonomy, the
native reader, output formatting, statistics) is imported from
`metacache_tpu` unchanged; every module that imports JAX there has a
counterpart here under the same name. This package never imports JAX.
"""
__version__ = "0.1.0"
