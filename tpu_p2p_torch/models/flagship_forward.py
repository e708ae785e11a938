"""Flagship forward pieces the serving path needs — the port's copy of
``_rms_norm`` and ``_dense_ffn`` from
``tpu_p2p/models/flagship_forward.py``.

The reference computes both with float32 internals and
``preferred_element_type=float32`` matmuls. Here the casts are spelled
out: bf16 operands are widened to float32 before each product, which
reproduces an f32-accumulated bf16 product exactly (a product of two
bf16 values is exact in float32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_p2p_torch.models.flagship_params import Params


def _rms_norm(x: torch.Tensor, gain: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with a learnable gain, returned in x's dtype."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * r * gain.float()).to(x.dtype)


def _dense_ffn(sub: Params, h: torch.Tensor) -> torch.Tensor:
    """Dense 2-layer MLP: ``gelu(h @ wf1) @ wf2`` with float32
    accumulation. GELU is the tanh approximation (``jax.nn.gelu``'s
    default, not torch's erf default); the hidden stays float32 and
    meets ``wf2`` under float32 promotion, as in the reference; the
    result is cast back to ``h``'s dtype."""
    f_h = F.gelu(torch.matmul(h.float(), sub["wf1"].float()),
                 approximate="tanh")
    return torch.matmul(f_h, sub["wf2"].float()).to(h.dtype)
