"""Pipeline parallelism — GPipe microbatching over the pp line, the port
of ``tpu_p2p/models/pipeline.py::pipeline_apply_local``.

Each rank of the pp line owns one stage (its slice of the stage-major
params); activations hop stage → stage + 1 on the no-wraparound
neighbour edges. The schedule is the reference's masked tick loop: ``M +
S - 1`` ticks (``M`` microbatches, ``S`` stages), every stage running its
block every tick, on zeros in the fill and drain bubbles (a zero input
gives a zero output), with the results masked.

The masks are tensor operations, never a branch on the rank: every rank
of the line builds the same autograd graph, so every rank runs every
hop's backward, in the same order. (A branch would drop a hop's arrival
from the graph of the rank that ignores it, whose backward would then
never post the receive its neighbour sends.)

``pp_overlap="wave"`` (with ``pp_chunks`` > 1) ships each tick's hop as
a wave of token chunks (:func:`chunked_ppermute_compute`, the identity
compute along ``T``): every chunk's hop is issued before the first is
waited for. The arrivals are the one-shot hop's values, bitwise.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_p2p_torch.parallel.collectives import (
    axis_ppermute,
    chunked_ppermute_compute,
    psum_conjugate,
    psum_join,
)


def pipeline_apply_local(block_fn: Callable, params_local, x_mb: torch.Tensor,
                         line, pp_overlap: str = "none",
                         pp_chunks: int = 1) -> torch.Tensor:
    """GPipe over the pp ``line``: ``x_mb [M, mb, T, D]``, replicated over
    the line → the outputs ``[M, mb, T, D]``, replicated. ``pp_overlap=
    "wave"`` with ``pp_chunks`` > 1 splits each hop into that many token
    chunks (module docstring); ``"none"`` or ``pp_chunks=1`` keep the
    one-shot hop.

    Tick ``t``: stage ``s`` runs microbatch ``t - s``; stage 0 reads
    microbatch ``t`` of the input, the others the previous tick's
    arrival. The input enters through :func:`psum_conjugate` (only stage
    0 consumes it, so its cotangent is stage 0's, summed over the line);
    the last stage records each finished microbatch, and
    :func:`psum_join` replicates the record (the other stages' is
    zero)."""
    s_count, my = line.size, line.index
    m = x_mb.shape[0]
    edges = [(i, i + 1) for i in range(s_count - 1)]
    wave = pp_overlap == "wave" and pp_chunks > 1
    x_mb = psum_conjugate(x_mb, line)
    first = torch.tensor(my == 0, device=x_mb.device)
    zero = torch.zeros_like(x_mb[0])
    prev_in = zero
    outs = []
    for t in range(m + s_count - 1):
        feed = x_mb[t] if t < m else zero
        y = block_fn(params_local, torch.where(first, feed, prev_in))
        if t < m + s_count - 2 and s_count > 1:  # the last hop feeds no one
            prev_in = (chunked_ppermute_compute(
                lambda c, _i: c, y, line, edges, chunk_dim=1,
                chunks=pp_chunks) if wave
                else axis_ppermute(y, line, edges))
        out_t = t - (s_count - 1)
        if out_t >= 0:
            last = torch.tensor(my == s_count - 1, device=y.device)
            outs.append(torch.where(last, y, zero))
    return psum_join(torch.stack(outs), line)
