"""Device selection for the port's main path."""

from __future__ import annotations

import torch


def cuda_device() -> torch.device:
    """The CUDA device the main path runs on. Raises when no GPU is
    present: the main path never drops to the CPU by itself (CPU runs
    pass ``device="cpu"`` explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "m2dec_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch path")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``None`` -> :func:`cuda_device`; anything else -> torch.device."""
    return cuda_device() if device is None else torch.device(device)
