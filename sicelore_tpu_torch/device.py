"""Device selection: an explicit "cuda" or "cpu", never a silent fallback."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device) -> torch.device:
    """"cuda"/"cpu" (or a torch.device) -> torch.device.

    Raises RuntimeError when CUDA is asked for and no GPU is visible, or a
    card index past the visible ones is named: the plain CPU bodies must
    never stand in for the kernels unasked."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False (torch {torch.__version__}, "
            f"CUDA build {torch.version.cuda})")
    if dev.type == "cuda" and dev.index is not None and \
            dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {str(device)!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) are visible")
    return dev
