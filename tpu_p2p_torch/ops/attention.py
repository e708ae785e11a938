"""Single-device attention helpers — the port's copy of the one-device
half of ``tpu_p2p/ops/attention.py``.

``dense_attention`` is the ``use_flash=False`` path and the test oracle
of the flash kernels; ``finalize`` owns the fully-masked-row policy
(``l == 0`` rows → 0) shared with :mod:`tpu_p2p_torch.ops.
flash_attention`; ``_merge`` is the streaming-softmax update. The ring,
zigzag and sharding helpers of the reference belong to the multi-card
slice and are not here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: no NaN from
# (-inf) - (-inf) on fully-masked rows


def repeat_kv(x: torch.Tensor, h_q: int) -> torch.Tensor:
    """``[B, H_kv, T, D] → [B, H_q, T, D]``: repeat each KV head over its
    query group (GQA; ``H_kv == 1`` is MQA). Identity when the head
    counts already match."""
    h_kv = x.shape[1]
    if h_kv == h_q:
        return x
    if h_q % h_kv:
        raise ValueError(
            f"query heads ({h_q}) must be a multiple of KV heads ({h_kv})"
        )
    return torch.repeat_interleave(x, h_q // h_kv, dim=1)


def _window_mask(t: int, window: Optional[int], device) -> torch.Tensor:
    """``[t, t]`` bool: key ``j`` visible from query ``i`` when
    ``j <= i`` (and ``i - j < window``)."""
    ones = torch.ones((t, t), dtype=torch.bool, device=device)
    mask = torch.tril(ones)
    if window is not None:
        mask &= ~torch.tril(ones, -window)
    return mask


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    window: Optional[int] = None) -> torch.Tensor:
    """Reference single-device attention (test oracle), ``[B, H, T, D]``.

    GQA/MQA: ``k``/``v`` may carry fewer heads than ``q``. Scores are a
    float32 product of the widened operands (exact for bf16 products,
    as the reference's ``preferred_element_type=float32``), divided by
    ``sqrt(D)``; masked scores are ``NEG_INF``; the softmax runs in
    float32 and ``p`` is cast to v's dtype before the float32 PV
    product; the result comes back in q's dtype.
    """
    k = repeat_kv(k, q.shape[1])
    v = repeat_kv(v, q.shape[1])
    t, d = q.shape[2], q.shape[3]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    if causal:
        s = torch.where(_window_mask(t, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def finalize(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Normalize a streaming-softmax carry into attention output; rows
    with ``l == 0`` (fully masked) come out 0."""
    del m
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / safe[..., None]).to(dtype)


def _merge(o, m, l, s, v):
    """Fold one block's scores ``s [..., Tq, Tk]`` and values into the
    ``(o, m, l)`` accumulator: rescale the running numerator by
    ``exp(m - m_new)`` and add the block's contribution."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.matmul(p.to(v.dtype).float(),
                                                v.float())
    return o_new, m_new, l_new
