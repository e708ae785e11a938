"""1F1B pipeline parallelism — the port of
``tpu_p2p/models/pipeline_1f1b.py``.

GPipe's step differentiates through the schedule, so autograd keeps
every tick's activations: ``O(M + S)`` microbatches a stage for ``M``
microbatches over ``S`` stages. The 1F1B (one-forward-one-backward,
PipeDream-flush) schedule interleaves each stage's backward of microbatch
``m`` with the forward of microbatch ``m + warmup``, so at most ``O(S)``
microbatches are in flight, with manual backprop a tick and a fixed-size
activation stash.

- :func:`build_1f1b_schedule` is the reference's host simulation of the
  classic policy (warm up with ``min(M, S - s)`` forwards, then alternate
  B/F, then drain), with interval-colored stash slots; pure Python, so
  its tables equal the reference's.
- :func:`make_pipeline_train_step_1f1b` is the ``chunks=1`` interleaved
  step (:mod:`tpu_p2p_torch.models.pipeline_interleaved`), which runs
  through the tick IR (:mod:`tpu_p2p_torch.models.schedule`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from tpu_p2p_torch.models.pipeline import (
    PipelineConfig,
    _check_pp_mesh,
    mlp_block,
)


@dataclass(frozen=True)
class Schedule1F1B:
    """Static 1F1B schedule tables, all ``[T, S]`` int32 (−1 = no op).

    ``f_mb``/``b_mb``: microbatch forwarded / backwarded by stage ``s``
    at tick ``t``. ``f_slot``/``b_slot``: activation-stash slot the fwd
    input is written to / read from. ``recv_slot``: slot to store the
    activation arriving (over the carry) at tick ``t``. ``b_gslot`` /
    ``grecv_slot``: same pair for the incoming-gradient stash (last
    stage computes its loss gradient locally and never uses them).
    """

    num_ticks: int
    stages: int
    microbatches: int
    act_slots: int
    grad_slots: int
    f_mb: np.ndarray
    f_slot: np.ndarray
    b_mb: np.ndarray
    b_slot: np.ndarray
    recv_slot: np.ndarray
    b_gslot: np.ndarray
    grecv_slot: np.ndarray


def _color_intervals(intervals: List[Tuple[int, int, object]]) -> Tuple[int, Dict]:
    """Greedy interval coloring: ``(write_tick, last_read_tick, key)`` →
    ``{key: slot}``. A slot frees strictly *after* its last read tick
    (no same-tick reuse: received values are written at the top of the
    tick body, before the bwd read)."""
    events = sorted(intervals, key=lambda iv: (iv[0], iv[1]))
    free: List[int] = []
    busy: List[Tuple[int, int]] = []  # (last_read, slot)
    assign: Dict = {}
    n = 0
    for w, r, key in events:
        busy.sort()
        while busy and busy[0][0] < w:
            free.append(busy.pop(0)[1])
        if free:
            slot = free.pop()
        else:
            slot = n
            n += 1
        busy.append((r, slot))
        assign[key] = slot
    return n, assign


def build_1f1b_schedule(microbatches: int, stages: int) -> Schedule1F1B:
    """Simulate the 1F1B policy tick-by-tick and assign stash slots.

    Policy per stage: issue ``min(M, S - s)`` warmup forwards, then
    strictly alternate backward/forward (idling when the wanted op's
    input has not arrived), then drain the remaining backwards.
    """
    m, s_count = microbatches, stages
    if m < 1 or s_count < 1:
        raise ValueError(f"need microbatches >= 1, stages >= 1; got {m}, {s_count}")
    warmup = [min(m, s_count - s) for s in range(s_count)]
    next_f = [0] * s_count
    next_b = [0] * s_count
    last_kind = [""] * s_count
    fwd_tick = np.full((s_count, m), -1, np.int64)
    bwd_tick = np.full((s_count, m), -1, np.int64)

    t = 0
    guard = 4 * (m + s_count) + 8
    while any(next_b[s] < m for s in range(s_count)):
        if t > guard:
            raise RuntimeError(f"1F1B schedule did not converge (M={m}, S={s_count})")
        for s in range(s_count):
            # A value produced at tick t' travels over the scan-carry
            # wire and is usable from tick t'+1, hence the strict
            # `< t`; the last stage's own forward also feeds its
            # backward one tick later (stash write → read).
            def _done_before(tick_tbl, row, mb):
                return 0 <= tick_tbl[row, mb] < t

            f_ready = next_f[s] < m and (
                s == 0 or _done_before(fwd_tick, s - 1, next_f[s])
            )
            b_ready = next_b[s] < m and (
                _done_before(bwd_tick, s + 1, next_b[s])
                if s < s_count - 1
                else _done_before(fwd_tick, s, next_b[s])
            )
            if next_f[s] < warmup[s]:
                want = "F"
            elif last_kind[s] == "B" and next_f[s] < m:
                want = "F"
            else:
                want = "B"
            if want == "F" and f_ready:
                last_kind[s] = "F"
                fwd_tick[s, next_f[s]] = t
                next_f[s] += 1
            elif want == "B" and b_ready:
                last_kind[s] = "B"
                bwd_tick[s, next_b[s]] = t
                next_b[s] += 1
        t += 1
    num_ticks = t

    f_mb = np.full((num_ticks, s_count), -1, np.int32)
    b_mb = np.full((num_ticks, s_count), -1, np.int32)
    for s in range(s_count):
        for mb in range(m):
            f_mb[fwd_tick[s, mb], s] = mb
            b_mb[bwd_tick[s, mb], s] = mb

    # Activation stash: at stage s, microbatch m's input activation is
    # written at its arrival tick (stage 0: its own fwd tick; else the
    # upstream fwd tick + 1) and last read at bwd(m, s). Each device
    # owns a private stash, so slots are colored *per stage* and the
    # array is sized by the worst stage.
    act_slots, act_assign = 0, {}
    grad_slots, grad_assign = 1, {}  # >= 1 keeps shapes non-empty for S == 1
    for s in range(s_count):
        act_iv = []
        for mb in range(m):
            w = fwd_tick[s, mb] if s == 0 else fwd_tick[s - 1, mb] + 1
            act_iv.append((int(w), int(bwd_tick[s, mb]), (s, mb)))
        n, assign = _color_intervals(act_iv)
        act_slots = max(act_slots, n)
        act_assign.update(assign)
        if s < s_count - 1:
            # Gradient stash: dL/dy arrives at bwd(m, s+1) + 1, read
            # at bwd(m, s). The last stage computes its own loss grad.
            grad_iv = [
                (int(bwd_tick[s + 1, mb] + 1), int(bwd_tick[s, mb]), (s, mb))
                for mb in range(m)
            ]
            n, assign = _color_intervals(grad_iv)
            grad_slots = max(grad_slots, n)
            grad_assign.update(assign)

    f_slot = np.full((num_ticks, s_count), -1, np.int32)
    b_slot = np.full((num_ticks, s_count), -1, np.int32)
    recv_slot = np.full((num_ticks, s_count), -1, np.int32)
    b_gslot = np.full((num_ticks, s_count), -1, np.int32)
    grecv_slot = np.full((num_ticks, s_count), -1, np.int32)
    for s in range(s_count):
        for mb in range(m):
            slot = act_assign[(s, mb)]
            b_slot[bwd_tick[s, mb], s] = slot
            f_slot[fwd_tick[s, mb], s] = slot
            if s > 0:
                recv_slot[fwd_tick[s - 1, mb] + 1, s] = slot
            if s < s_count - 1:
                gs = grad_assign[(s, mb)]
                b_gslot[bwd_tick[s, mb], s] = gs
                grecv_slot[bwd_tick[s + 1, mb] + 1, s] = gs

    return Schedule1F1B(
        num_ticks=num_ticks,
        stages=s_count,
        microbatches=m,
        act_slots=act_slots,
        grad_slots=grad_slots,
        f_mb=f_mb,
        f_slot=f_slot,
        b_mb=b_mb,
        b_slot=b_slot,
        recv_slot=recv_slot,
        b_gslot=b_gslot,
        grecv_slot=grecv_slot,
    )


def _mse_loss_grad(y: torch.Tensor, target: torch.Tensor):
    """(sum-of-squares loss, dL/dy) of one microbatch, in float32 — the
    GPipe step's objective."""
    d = y.float() - target.float()
    return torch.sum(d * d), 2.0 * d


def make_pipeline_train_step_1f1b(mesh, cfg: PipelineConfig,
                                  block_fn: Callable = mlp_block,
                                  lr: float = 1e-2,
                                  loss_grad_fn: Callable = _mse_loss_grad,
                                  pp_overlap: str = "none",
                                  pp_chunks: int = 1):
    """One SGD step under the 1F1B schedule: the loss normalization and
    update of :func:`~tpu_p2p_torch.models.pipeline.
    make_pipeline_train_step`, with manual backprop and ``O(S)``
    activation memory — the ``chunks=1`` interleaved step, as in the
    reference."""
    from tpu_p2p_torch.models.pipeline_interleaved import \
        make_interleaved_train_step

    _check_pp_mesh(mesh, cfg)
    return make_interleaved_train_step(mesh, cfg, 1, block_fn=block_fn,
                                       lr=lr, loss_grad_fn=loss_grad_fn,
                                       pp_overlap=pp_overlap,
                                       pp_chunks=pp_chunks)
