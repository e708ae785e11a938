"""Trainable ring flash attention — the flash kernels streamed over the
ring of a mesh line, differentiable end to end. The port of
``tpu_p2p/ops/ring_flash.py``.

Forward: the math of :func:`tpu_p2p_torch.ops.attention.
ring_attention_local`, with each hop's fold in the flash kernel
(:func:`~tpu_p2p_torch.ops.flash_attention.flash_carry_block`) at the
block's global offsets. The KV block rotates right around the line
while each rank folds it into its float32 ``(o, m, l)`` carry; the next
block's transfer is in flight while the current one folds. Saved for
the backward: the inputs, the output and the logsumexp ``L = m + log
l`` — O(T_local) a rank.

Backward: the FlashAttention-2 block recipe
(:func:`~tpu_p2p_torch.ops.flash_attention.flash_bwd_block`) over the
same ring. ``P = exp(S - L)`` needs only the global ``L`` and ``delta =
rowsum(dO·O)``, both local, so a KV block's dK/dV contribution can be
taken wherever the block is: K/V rotate again, a float32 (dK, dV)
accumulator travels with its block, ``dq`` accumulates in place, and
after the last live hop the accumulators go home the shorter way round.

The per-hop steps :func:`_accumulate` and :func:`_block_grads` take
host integers ``(my, src, n)``: the kernels take host offsets, and
``chip_smoke.py`` drives the same steps for every rank of a ring in one
process. Under ``layout="zigzag"`` each hop is four half x half calls
(the offset masks need contiguous position runs).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_p2p_torch.ops.attention import (
    NEG_INF,
    _check_window,
    finalize,
    live_ring_hops,
    zigzag_chunks,
)
from tpu_p2p_torch.ops.flash_attention import (
    delta_of,
    flash_bwd_block,
    flash_carry_block,
    logsumexp,
)
from tpu_p2p_torch.parallel.collectives import (
    axis_group,
    ppermute,
    ppermute_start,
    ppermute_wait,
    ring_edges,
)


def _halves(rank: int, n: int, t: int):
    """Zigzag half-slices of a local block with their global offsets."""
    half = t // 2
    lo, hi = zigzag_chunks(rank, n, t)
    return ((slice(0, half), lo), (slice(half, t), hi))


def _accumulate(q, k_blk, v_blk, o, m, l, my: int, src: int, n: int,
                causal: bool, layout: str, window,
                carry_block=flash_carry_block):
    """Fold block ``src``'s K/V into rank ``my``'s carry at the blocks'
    global offsets; → the new ``(o, m, l)``. ``carry_block``: the
    kernel's wrapper, or its plain twin."""
    t = q.shape[2]
    if layout == "zigzag" and causal:
        o, m, l = o.clone(), m.clone(), l.clone()
        for qs, q_off in _halves(my, n, t):
            oq, mq, lq = o[:, :, qs], m[:, :, qs], l[:, :, qs]
            for ks, k_off in _halves(src, n, t):
                oq, mq, lq = carry_block(
                    q[:, :, qs], k_blk[:, :, ks], v_blk[:, :, ks],
                    oq, mq, lq, q_off, k_off, causal=causal, window=window)
            o[:, :, qs], m[:, :, qs], l[:, :, qs] = oq, mq, lq
        return o, m, l
    return carry_block(q, k_blk, v_blk, o, m, l, my * t, src * t,
                       causal=causal, window=window)


def _block_grads(dq, dka, dva, q, k_blk, v_blk, g, L, delta, my: int,
                 src: int, n: int, causal: bool, layout: str, window,
                 bwd_block=flash_bwd_block):
    """Add block ``src``'s gradient terms against rank ``my``'s queries:
    ``dq`` (rank ``my``'s) and the block's traveling ``dka``/``dva``, in
    place; → ``(dq, dka, dva)``. ``bwd_block``: the kernels' wrapper, or
    its plain twin."""
    t = q.shape[2]
    if layout == "zigzag" and causal:
        for qs, q_off in _halves(my, n, t):
            for ks, k_off in _halves(src, n, t):
                dq_h, dk_h, dv_h = bwd_block(
                    q[:, :, qs], k_blk[:, :, ks], v_blk[:, :, ks],
                    g[:, :, qs], L[:, :, qs], delta[:, :, qs], q_off,
                    k_off, causal=causal, window=window)
                dq[:, :, qs] += dq_h
                dka[:, :, ks] += dk_h
                dva[:, :, ks] += dv_h
        return dq, dka, dva
    dq_b, dk_b, dv_b = bwd_block(q, k_blk, v_blk, g, L, delta, my * t,
                                 src * t, causal=causal, window=window)
    dq += dq_b
    dka += dk_b
    dva += dv_b
    return dq, dka, dva


def _check(q, layout: str, causal: bool, window) -> None:
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    _check_window(window, causal)
    if layout == "zigzag" and q.shape[2] % 2:
        raise ValueError(f"zigzag needs an even local length, got "
                         f"{q.shape[2]}")


def _ring_flash_fwd(q, k, v, line, causal, layout, window):
    n, my = line.size, line.index
    b, h, t, d = q.shape
    o = q.new_zeros((b, h, t, d), dtype=torch.float32)
    m = q.new_full((b, h, t), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, t), dtype=torch.float32)
    edges = ring_edges(n)
    kv = torch.stack((k, v))   # one transfer a hop carries both
    hops = live_ring_hops(n, t, causal, layout, window)
    for i in range(hops):
        # The next block is in flight while this one folds.
        nxt = ppermute_start(kv, line, edges, what="ring attention")
        o, m, l = _accumulate(q, kv[0], kv[1], o, m, l, my, (my - i) % n,
                              n, causal, layout, window)
        kv = ppermute_wait(*nxt)
    o, m, l = _accumulate(q, kv[0], kv[1], o, m, l, my, (my - hops) % n,
                          n, causal, layout, window)
    return finalize(o, m, l, q.dtype), logsumexp(m, l)


def _ring_flash_bwd(line, causal, layout, window, saved, g):
    q, k, v, out, L = saved
    n, my = line.size, line.index
    b, h, t, d = q.shape
    delta = delta_of(g, out)
    g = g.to(q.dtype)
    dq = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                      device=k.device)
    edges = ring_edges(n)
    kv = torch.stack((k, v))
    hops = live_ring_hops(n, t, causal, layout, window)
    for i in range(hops):
        nxt = ppermute_start(kv, line, edges, what="ring attention")
        _block_grads(dq, dkv[0], dkv[1], q, kv[0], kv[1], g, L, delta, my,
                     (my - i) % n, n, causal, layout, window)
        # The accumulators travel with their block.
        dkv = ppermute(dkv, line, edges, what="ring attention")
        kv = ppermute_wait(*nxt)
    _block_grads(dq, dkv[0], dkv[1], q, kv[0], kv[1], g, L, delta, my,
                 (my - hops) % n, n, causal, layout, window)
    # The accumulators sit ``hops`` rotations past their owners: on
    # forward the remaining ``n - hops``, or back ``hops``, the shorter.
    if 0 < hops < n - hops:
        for _ in range(hops):
            dkv = ppermute(dkv, line, ring_edges(n, -1),
                           what="ring attention")
    elif hops:
        for _ in range(n - hops):
            dkv = ppermute(dkv, line, edges, what="ring attention")
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, line, causal, layout, window):
        out, L = _ring_flash_fwd(q, k, v, line, causal, layout, window)
        ctx.save_for_backward(q, k, v, out, L)
        ctx.args = (line, causal, layout, window)
        return out

    @staticmethod
    def backward(ctx, g):
        grads = _ring_flash_bwd(*ctx.args, ctx.saved_tensors, g)
        return (*grads, None, None, None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         line, causal: bool = False,
                         layout: str = "contiguous",
                         window: Optional[int] = None) -> torch.Tensor:
    """Ring attention on the flash kernels over the sequence split along
    ``line``, differentiable: ``q [B, H, T_local, D]`` against ``k/v
    [B, H_kv, T_local, D]`` (GQA: the rotating blocks and the traveling
    accumulators stay narrow). ``layout="zigzag"`` reads the blocks as
    zigzag chunks. On a line of one rank this is single-device flash
    attention at offset 0."""
    _check(q, layout, causal, window)
    if line.size > 1:
        axis_group(line, "ring attention")  # ranks sharing a card raise
    return _RingFlashAttention.apply(q, k, v, line, causal, layout, window)
