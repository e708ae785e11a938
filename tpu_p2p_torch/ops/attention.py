"""Attention helpers and ring attention — the port of
``tpu_p2p/ops/attention.py``.

``dense_attention`` is the ``use_flash=False`` path and the test oracle
of the flash kernels; ``finalize`` owns the fully-masked-row policy
(``l == 0`` rows → 0) shared with :mod:`tpu_p2p_torch.ops.
flash_attention`; ``_merge`` is the streaming-softmax update.

Sequence parallelism: with the sequence split over a mesh line, each
rank holds a ``[B, H, T_local, D]`` block of q, k and v.
:func:`ring_attention_local` rotates the KV blocks around the line
(``n - 1`` shift-by-1 hops, fewer where a window makes the rest dead)
while each rank folds them into its ``(o, m, l)`` carry; the flash form
is :mod:`tpu_p2p_torch.ops.ring_flash`. The zigzag layout
(:func:`zigzag_chunks`) gives every rank one early and one mirrored
late half-chunk, so causal work is even across ranks.
:func:`ring_attention` is the benchmark's entry (this rank's blocks in
and out), with :func:`flops_per_step` and :func:`kv_bytes_per_hop` its
accounting.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_p2p_torch.utils.remat import product

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
    with product("attn_scores", batch_dims=True):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s / math.sqrt(d)
    if causal:
        s = torch.where(_window_mask(t, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    with product("attn_values", batch_dims=True):
        o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


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
    with product("attn_values", batch_dims=True):
        pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return o * alpha[..., None] + pv, m_new, l_new


def _block_scores(q: torch.Tensor, k: torch.Tensor, scale: float):
    with product("attn_scores", batch_dims=True):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return s * scale


def zigzag_chunks(rank: int, n: int, t_local: int):
    """Global start positions of a rank's two zigzag half-chunks: the
    sequence is cut into ``2n`` chunks of ``t_local / 2``, and rank ``r``
    holds chunks ``r`` and ``2n - 1 - r``."""
    half = t_local // 2
    return rank * half, (2 * n - 1 - rank) * half


def live_ring_hops(n: int, t: int, causal: bool, layout: str,
                   window) -> int:
    """Ring rotations that can carry a live KV block: under a causal
    window on the contiguous layout, rank ``my``'s queries see only the
    blocks ``my - H .. my`` with ``H = ceil((window - 1) / T_local)``, so
    later hops would ship dead blocks and are dropped. Zigzag holds a
    late chunk on every rank: every hop stays live there."""
    if window is not None and causal and layout == "contiguous":
        return min(n - 1, -(-(window - 1) // t))
    return n - 1


def _check_window(window, causal: bool) -> None:
    """Reject the silently wrong windows: non-causal, and < 1."""
    if window is None:
        return
    if not causal:
        raise ValueError("window requires causal attention")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _block_positions(src_block: int, n: int, t: int, layout: str,
                     device=None) -> torch.Tensor:
    """Global positions ``[t]`` of block ``src_block`` of ``n``."""
    if layout == "zigzag":
        lo, hi = zigzag_chunks(src_block, n, t)
        half = torch.arange(t // 2, device=device)
        return torch.cat([lo + half, hi + half])
    return src_block * t + torch.arange(t, device=device)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         line, *, causal: bool = False,
                         use_flash: bool = False,
                         layout: str = "contiguous",
                         window: Optional[int] = None) -> torch.Tensor:
    """Ring attention of this rank's block over the sequence split along
    ``line`` (a mesh line, :meth:`Mesh.line`).

    ``q [B, H, T_local, D]``, ``k/v [B, H_kv, T_local, D]`` (GQA: the
    rotating blocks stay narrow). The KV block rotates right (the
    ``ring`` workload's edge set) while this rank folds each arriving
    block into its float32 ``(o, m, l)`` carry, masked at the block's
    global positions. Differentiable through autograd: each hop is an
    :func:`~tpu_p2p_torch.parallel.collectives.axis_ppermute`.
    ``use_flash`` runs the folds and the backward in the flash kernels
    (:func:`tpu_p2p_torch.ops.ring_flash.ring_flash_attention`).
    ``layout="zigzag"`` reads the blocks as zigzag chunks (even
    ``T_local``).
    """
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    _check_window(window, causal)
    if use_flash:
        from tpu_p2p_torch.ops.ring_flash import ring_flash_attention

        return ring_flash_attention(q, k, v, line, causal, layout, window)
    from tpu_p2p_torch.parallel.collectives import axis_ppermute, ring_edges

    n, my = line.size, line.index
    b, h, t, d = q.shape
    if layout == "zigzag" and t % 2:
        raise ValueError(f"zigzag needs an even local length, got {t}")
    scale = 1.0 / math.sqrt(d)
    edges = ring_edges(n)
    o = q.new_zeros((b, h, t, d), dtype=torch.float32)
    m = q.new_full((b, h, t), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, t), dtype=torch.float32)
    q_pos = _block_positions(my, n, t, layout, q.device)

    def accumulate(o, m, l, k_blk, v_blk, src):
        s = _block_scores(q, repeat_kv(k_blk, h), scale)
        if causal:
            k_pos = _block_positions(src, n, t, layout, q.device)
            vis = q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                vis &= q_pos[:, None] - k_pos[None, :] < window
            s = torch.where(vis, s, NEG_INF)
        return _merge(o, m, l, s, repeat_kv(v_blk, h))

    hops = live_ring_hops(n, t, causal, layout, window)
    k_cur, v_cur = k, v
    for i in range(hops):
        k_nxt = axis_ppermute(k_cur, line, edges)
        v_nxt = axis_ppermute(v_cur, line, edges)
        o, m, l = accumulate(o, m, l, k_cur, v_cur, (my - i) % n)
        k_cur, v_cur = k_nxt, v_nxt
    o, m, l = accumulate(o, m, l, k_cur, v_cur, (my - hops) % n)
    return finalize(o, m, l, q.dtype)


def ring_attention(mesh, axis: str, causal: bool = False,
                   use_flash: bool = False, layout: str = "contiguous",
                   window: Optional[int] = None):
    """Ring attention over ``mesh`` as the benchmark calls it: → ``fn(q,
    k, v)`` of this rank's blocks of global ``[B, H, T, D]`` arrays
    with ``T`` split along ``axis`` (placed with
    :func:`attention_sharding`), returning this rank's block of the
    output. The other axes of the mesh replicate. ``layout="zigzag"``:
    the global arrays are in zigzag order (:func:`to_zigzag`)."""
    line = mesh.line(axis)

    def fn(q, k, v):
        return ring_attention_local(q, k, v, line, causal=causal,
                                    use_flash=use_flash, layout=layout,
                                    window=window)

    return fn


def attention_sharding(mesh, axis: str) -> tuple:
    """The spec of a global ``[B, H, T, D]`` attention operand: ``T``
    split along ``axis`` (:func:`~tpu_p2p_torch.parallel.runtime.
    local_shard` takes this rank's block)."""
    del mesh
    return (None, None, axis, None)


def flops_per_step(b: int, h: int, t: int, d: int, *, causal: bool = False,
                   window: Optional[int] = None) -> int:
    """Attention FLOPs of one forward: 2·(QK) + 2·(PV) products. Causal
    halves the score matrix; a window further limits query ``i`` to
    ``min(i + 1, W)`` keys."""
    if causal and window is not None:
        w = min(window, t)
        keys = t * w - w * (w - 1) // 2
        return 4 * b * h * keys * d
    total = 4 * b * h * t * t * d
    return total // 2 if causal else total


def itemsize(dtype) -> int:
    """Bytes of one element of ``dtype`` (a torch dtype or its name)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return dtype.itemsize


def kv_bytes_per_hop(b: int, h: int, t_local: int, d: int, dtype) -> int:
    """Bytes each rank ships a ring hop (its K and V blocks)."""
    return 2 * b * h * t_local * d * itemsize(dtype)


def zigzag_perm(n: int, seq: int) -> list:
    """Sequence permutation into zigzag order: shard ``r`` of the
    permuted sequence holds chunks ``(r, 2n-1-r)`` of the original."""
    if seq % (2 * n):
        raise ValueError(f"sequence {seq} must divide by 2n = {2 * n}")
    half = seq // (2 * n)
    perm = []
    for r in range(n):
        perm.extend(range(r * half, (r + 1) * half))
        perm.extend(range((2 * n - 1 - r) * half, (2 * n - r) * half))
    return perm


def to_zigzag(x: torch.Tensor, n: int, seq_axis: int = 2) -> torch.Tensor:
    """Reorder the sequence axis into the zigzag layout."""
    perm = torch.tensor(zigzag_perm(n, x.shape[seq_axis]), device=x.device)
    return x.index_select(seq_axis, perm)


def from_zigzag(x: torch.Tensor, n: int, seq_axis: int = 2) -> torch.Tensor:
    """Inverse of :func:`to_zigzag`."""
    perm = zigzag_perm(n, x.shape[seq_axis])
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return x.index_select(seq_axis, torch.tensor(inv, device=x.device))
