"""2-bit DNA encoding, windowing and canonical k-mers.

Counterpart of metacache_tpu/ops/encode.py. Its numpy helpers are
re-implemented here because that module imports JAX at load time. Same
conventions: A=0 C=1 G=2 T=3, anything else ambiguous (255); canonical
k-mer = min(kmer, reverse complement) (src/dna_encoding.h:113-121,
:187-197); u32 k-mers are carried in int64 (see ops/hashes.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .hashes import U32_MASK

AMBIG_CODE = np.uint8(255)

CHAR_LUT = np.full(256, AMBIG_CODE, dtype=np.uint8)
for _ch, _code in (("A", 0), ("a", 0), ("C", 1), ("c", 1),
                   ("G", 2), ("g", 2), ("T", 3), ("t", 3)):
    CHAR_LUT[ord(_ch)] = _code


# --------------------------------------------------------------- host side
def np_encode_bytes(seq_bytes: np.ndarray) -> np.ndarray:
    """Raw ASCII bytes -> 2-bit codes (255 = ambiguous)."""
    return CHAR_LUT[seq_bytes]


def np_pack_codes(codes: np.ndarray):
    """[B, L] uint8 codes (0..3, 255 = ambiguous) -> (packed [B, L/4],
    ambiguity bitplane [B, L/8]); L must be a multiple of 8. Char i sits
    at bits 2*(i&3) of packed byte i>>2 and bit i&7 of ambig byte i>>3."""
    B, L = codes.shape
    if L % 8:
        raise ValueError("pack length must be a multiple of 8")
    c = np.where(codes == AMBIG_CODE, 0, codes).astype(np.uint8)
    c = c.reshape(B, L // 4, 4)
    packed = (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
              | (c[..., 3] << 6)).astype(np.uint8)
    a = (codes == AMBIG_CODE).reshape(B, L // 8, 8)
    ambig = np.packbits(a, axis=-1, bitorder="little")[..., 0]
    return packed, ambig


def np_rows_with_ambiguity(ambig: np.ndarray, lens: np.ndarray,
                           qlen: int) -> np.ndarray:
    """Boolean [B]: does row b have an ambiguity bit at a position
    < lens[b]?"""
    bits = np.unpackbits(ambig, axis=1, bitorder="little")[:, :qlen]
    pos = np.arange(qlen)
    return ((bits != 0) & (pos[None, :] < np.asarray(lens)[:, None])).any(
        axis=1)


def window_starts(seq_len: int, window: int, stride: int) -> np.ndarray:
    """Start offsets of all windows incl. the tail window
    (for_each_window, src/dna_encoding.h:261-276): one window if
    seq_len <= window, else full windows every `stride` plus a tail window
    if characters remain."""
    if seq_len <= window:
        return np.zeros(1, dtype=np.int64)
    n_full = (seq_len - window) // stride + 1
    starts = np.arange(n_full, dtype=np.int64) * stride
    tail_start = n_full * stride
    if tail_start < seq_len:
        starts = np.append(starts, tail_start)
    return starts


# ------------------------------------------------------------- tensor side
def unpack_codes(packed: torch.Tensor, ambig: torch.Tensor) -> torch.Tensor:
    """Inverse of np_pack_codes on tensors -> [B, L] uint8 (0..3, 255)."""
    B, P4 = packed.shape
    shifts = torch.arange(0, 8, 2, device=packed.device)
    c = (packed.long()[:, :, None] >> shifts) & 3
    bshifts = torch.arange(8, device=ambig.device)
    a = (ambig.long()[:, :, None] >> bshifts) & 1
    codes = torch.where(a.reshape(B, P4 * 4) == 1, int(AMBIG_CODE),
                        c.reshape(B, P4 * 4))
    return codes.to(torch.uint8)


def reverse_complement_u32(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Bit-twiddled reverse complement (src/dna_encoding.h:113-121):
    reverse the 2-bit groups, complement, shift down to the low 2k bits."""
    s = kmer & U32_MASK
    s = ((s >> 2) & 0x33333333) | ((s & 0x33333333) << 2)
    s = ((s >> 4) & 0x0F0F0F0F) | ((s & 0x0F0F0F0F) << 4)
    s = ((s >> 8) & 0x00FF00FF) | ((s & 0x00FF00FF) << 8)
    s = ((s >> 16) & 0x0000FFFF) | ((s & 0x0000FFFF) << 16)
    return (U32_MASK - s) >> (32 - 2 * k)


def canonical_u32(kmer: torch.Tensor, k: int) -> torch.Tensor:
    return torch.minimum(kmer, reverse_complement_u32(kmer, k))


def window_kmers(codes: torch.Tensor, valid_len: torch.Tensor, k: int):
    """Canonical k-mers + validity of every position of [B, W] windows.

    Position i is valid iff i + k <= valid_len[b] and none of its k
    characters is ambiguous (for_each_kmer_2bit,
    src/dna_encoding.h:305-348). Returns ([B, W-k+1] int64, bool)."""
    B, W = codes.shape
    n = max(0, W - k + 1)
    kmer = torch.zeros((B, n), dtype=torch.int64, device=codes.device)
    amb = torch.zeros((B, n), dtype=torch.bool, device=codes.device)
    for j in range(k if n else 0):
        c = codes[:, j:j + n]
        amb |= c == int(AMBIG_CODE)
        kmer = (kmer << 2) | (c.long() & 3)
    pos = torch.arange(n, device=codes.device)
    valid = (pos[None, :] + k <= valid_len.long()[:, None]) & ~amb
    return canonical_u32(kmer, k), valid
