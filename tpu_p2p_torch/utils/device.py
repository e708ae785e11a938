"""The device choice both entry points share."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` or ``"cpu"`` → a device; ``"cuda"`` without a card
    raises rather than running on the CPU."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (pass "
            "--device cpu to run on the CPU)"
        )
    return torch.device(name)
