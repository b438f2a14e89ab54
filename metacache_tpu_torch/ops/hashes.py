"""Thomas-Mueller 32-bit hash (src/hash_int.h:39-45) on int64 tensors.

Counterpart of metacache_tpu/ops/hashes.py::thomas_mueller_hash. PyTorch
on the CPU has no `>>`, `<`, `minimum` or `searchsorted` for uint32, so
the port carries every u32 value (k-mers, hashes, features) in int64 and
masks each product back to 32 bits: a 32-bit value times the 27-bit
constant stays below 2^59, so no int64 product overflows.
"""
from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF
_TM_MUL = 0x45D9F3B


def thomas_mueller_hash(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> their u32 hash, in int64."""
    x = x.to(torch.int64) & U32_MASK
    x = (((x >> 16) ^ x) * _TM_MUL) & U32_MASK
    x = (((x >> 16) ^ x) * _TM_MUL) & U32_MASK
    return (x >> 16) ^ x
