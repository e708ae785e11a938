"""Rotary position embeddings — the port's copy of ``tpu_p2p/ops/rope.py``.

Rotate-half layout (pairs are the two halves of the head dim, the
GPT-NeoX/LLaMA convention), float32 angles ``theta^(-2i/d)`` with
``theta = 10000``.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """``(cos, sin)`` of shape ``[..., head_dim/2]`` for integer
    ``positions [...]``."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head dim, got {head_dim}")
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=positions.device) / head_dim
    inv_freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                      device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x [B, H, T, D]`` by its positions — ``[T]`` shared by
    the batch, or ``[B, T]`` with each row at its own offsets (the
    reference's vmapped per-slot rotation). Float32 internally,
    returned in x's dtype."""
    d = x.shape[-1]
    cos, sin = rope_angles(positions, d, theta)
    if positions.dim() == 2:
        cos, sin = cos[:, None], sin[:, None]
    x1 = x[..., : d // 2].float()
    x2 = x[..., d // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)
