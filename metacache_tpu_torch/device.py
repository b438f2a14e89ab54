"""Device selection: the port never picks the CPU silently."""
from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """'cuda' or 'cpu' -> torch.device. Raises if CUDA is asked for and no
    card is visible, instead of falling back to the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("-device cuda requested but "
                               "torch.cuda.is_available() is False")
        return torch.device("cuda")
    raise ValueError(f"unknown device '{name}' (expected 'cuda' or 'cpu')")
