"""Interleaved 1F1B pipeline parallelism — the host parts of
``tpu_p2p/models/pipeline_interleaved.py``.

Each of the ``n`` pipeline devices owns ``v`` non-contiguous stage chunks
(device ``d`` holds virtual stages ``d, d+n, d+2n, …``), so the
fill/drain bubble shrinks by about ``v`` (the Megatron-LM interleaved
schedule). Every forward hop is device ``d → d+1`` (the wraparound
``n-1 → 0`` carries the chunk boundary) and every backward hop the
reverse: one ring edge set for all ticks.

- :func:`build_interleaved_schedule` is the reference's greedy tick
  simulation (the builder the IR's ``compile_1f1b``/
  ``compile_interleaved`` reuse); pure Python, so its tables equal the
  reference's.
- Params use the device-major chunk layout: row ``d·v + c`` holds
  virtual stage ``d + c·n``, so splitting the stage dim over ``pp`` hands
  device ``d`` exactly its chunks (:func:`to_device_major`,
  :func:`from_device_major`, byte-equal to the reference's).
- :func:`make_interleaved_train_step` runs through the tick IR
  (``compile_interleaved → lower() → tick_grads_local``), as the
  reference's does. The legacy hand-rolled executor
  (:func:`interleaved_grads_local`) survives as the parity fixture
  :func:`make_interleaved_train_step_reference`, which the tests hold
  against the IR path and the GPipe step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from tpu_p2p_torch.models.pipeline import (
    PipelineConfig,
    mlp_block,
    pp_param_specs,
)
from tpu_p2p_torch.models.pipeline_1f1b import _color_intervals, \
    _mse_loss_grad
from tpu_p2p_torch.parallel.runtime import local_shard

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class InterleavedSchedule:
    """Static tables, all ``[T, n]`` int32 (−1 = no op), per device:

    ``f_mb``/``b_mb``: microbatch of the fwd/bwd op; ``f_cidx`` /
    ``b_cidx``: which local chunk (0..v) the op runs; ``f_slot`` /
    ``b_slot`` / ``recv_slot``: activation-stash slots (write-at-fwd /
    read-at-bwd / write-on-receive); ``b_gslot``/``grecv_slot``: the
    incoming-gradient stash pair (unused on the last virtual stage,
    which computes its loss gradient locally).
    """

    num_ticks: int
    devices: int
    chunks: int
    microbatches: int
    act_slots: int
    grad_slots: int
    f_mb: np.ndarray
    f_cidx: np.ndarray
    f_slot: np.ndarray
    b_mb: np.ndarray
    b_cidx: np.ndarray
    b_slot: np.ndarray
    recv_slot: np.ndarray
    b_gslot: np.ndarray
    grecv_slot: np.ndarray


def build_interleaved_schedule(microbatches: int, devices: int,
                               chunks: int) -> InterleavedSchedule:
    """Greedy tick simulation over ``devices·chunks`` virtual stages.

    Per tick each device issues at most one op, alternating F/B kinds
    (after a backward, prefer a forward, and vice versa — strict
    B-first measurably re-opens the bubble). Within a kind the
    *deepest* ready virtual stage goes first: draining the tail for
    backwards, and keeping downstream devices fed for forwards.
    Forward issue also respects a per-virtual-stage in-flight cap
    (``min(M, S_virt - sv) + 1`` microbatches between a stage's
    forward and backward), bounding activation stash growth like the
    plain schedule's warmup policy.
    """
    m, n, v = microbatches, devices, chunks
    if m < 1 or n < 1 or v < 1:
        raise ValueError(f"need m, n, v >= 1; got {m}, {n}, {v}")
    s_virt = n * v
    fwd_tick = np.full((s_virt, m), -1, np.int64)
    bwd_tick = np.full((s_virt, m), -1, np.int64)
    next_f = [0] * s_virt
    next_b = [0] * s_virt
    last_kind = [""] * n

    def done_before(tbl, sv, mb, t):
        return 0 <= tbl[sv, mb] < t

    t = 0
    guard = 8 * (m * v + s_virt) + 16
    while any(next_b[sv] < m for sv in range(s_virt)):
        if t > guard:
            raise RuntimeError(
                f"interleaved schedule did not converge (M={m}, n={n}, v={v})"
            )
        for d in range(n):
            owned = [d + c * n for c in range(v)]

            def ready_bwd():
                # Deepest first: drain the tail.
                for sv in sorted(owned, reverse=True):
                    mb = next_b[sv]
                    if mb >= m:
                        continue
                    ready = (
                        done_before(bwd_tick, sv + 1, mb, t)
                        if sv < s_virt - 1
                        else done_before(fwd_tick, sv, mb, t)
                    )
                    if ready:
                        return ("B", sv, mb)
                return None

            def ready_fwd():
                # Deepest first: advancing the deepest chunk keeps
                # downstream devices fed; pumping chunk-0 starves them.
                for sv in sorted(owned, reverse=True):
                    mb = next_f[sv]
                    if mb >= m:
                        continue
                    cap = min(m, s_virt - sv) + 1
                    if mb - next_b[sv] >= cap:
                        continue  # too many in flight at this stage
                    if sv == 0 or done_before(fwd_tick, sv - 1, mb, t):
                        return ("F", sv, mb)
                return None

            # One-forward-one-backward alternation per device: after a
            # B prefer an F and vice versa. Strict B-first instead
            # drains too eagerly and re-opens the bubble (measured
            # 79 vs 70 ticks at M=16, n=4, v=2; 70 hits the
            # theoretical 2(n-1) fill+drain for this wire model).
            if last_kind[d] == "B":
                op = ready_fwd() or ready_bwd()
            else:
                op = ready_bwd() or ready_fwd()
            if op is not None:
                kind, sv, mb = op
                last_kind[d] = kind
                if kind == "F":
                    fwd_tick[sv, mb] = t
                    next_f[sv] += 1
                else:
                    bwd_tick[sv, mb] = t
                    next_b[sv] += 1
        t += 1
    num_ticks = t

    f_mb = np.full((num_ticks, n), -1, np.int32)
    f_cidx = np.full((num_ticks, n), -1, np.int32)
    b_mb = np.full((num_ticks, n), -1, np.int32)
    b_cidx = np.full((num_ticks, n), -1, np.int32)
    for sv in range(s_virt):
        d, c = sv % n, sv // n
        for mb in range(m):
            f_mb[fwd_tick[sv, mb], d] = mb
            f_cidx[fwd_tick[sv, mb], d] = c
            b_mb[bwd_tick[sv, mb], d] = mb
            b_cidx[bwd_tick[sv, mb], d] = c

    # Stash slots per device: activation of (sv, mb) lives from its
    # arrival (stage 0: own fwd tick; else upstream fwd + 1) to its
    # bwd read; incoming gradient from bwd(sv+1)+1 to bwd(sv).
    act_slots, grad_slots = 0, 1
    act_assign: Dict = {}
    grad_assign: Dict = {}
    for d in range(n):
        act_iv: List[Tuple[int, int, object]] = []
        grad_iv: List[Tuple[int, int, object]] = []
        for c in range(v):
            sv = d + c * n
            for mb in range(m):
                w = (fwd_tick[sv, mb] if sv == 0
                     else fwd_tick[sv - 1, mb] + 1)
                act_iv.append((int(w), int(bwd_tick[sv, mb]), (sv, mb)))
                if sv < s_virt - 1:
                    grad_iv.append((int(bwd_tick[sv + 1, mb] + 1),
                                    int(bwd_tick[sv, mb]), (sv, mb)))
        cnt, assign = _color_intervals(act_iv)
        act_slots = max(act_slots, cnt)
        act_assign.update(assign)
        if grad_iv:
            cnt, assign = _color_intervals(grad_iv)
            grad_slots = max(grad_slots, cnt)
            grad_assign.update(assign)

    f_slot = np.full((num_ticks, n), -1, np.int32)
    b_slot = np.full((num_ticks, n), -1, np.int32)
    recv_slot = np.full((num_ticks, n), -1, np.int32)
    b_gslot = np.full((num_ticks, n), -1, np.int32)
    grecv_slot = np.full((num_ticks, n), -1, np.int32)
    for sv in range(s_virt):
        d = sv % n
        for mb in range(m):
            slot = act_assign[(sv, mb)]
            f_slot[fwd_tick[sv, mb], d] = slot
            b_slot[bwd_tick[sv, mb], d] = slot
            if sv > 0:
                recv_slot[fwd_tick[sv - 1, mb] + 1, d] = slot
            if sv < s_virt - 1:
                gs = grad_assign[(sv, mb)]
                b_gslot[bwd_tick[sv, mb], d] = gs
                grecv_slot[bwd_tick[sv + 1, mb] + 1, d] = gs

    return InterleavedSchedule(
        num_ticks=num_ticks, devices=n, chunks=v, microbatches=m,
        act_slots=act_slots, grad_slots=grad_slots,
        f_mb=f_mb, f_cidx=f_cidx, f_slot=f_slot,
        b_mb=b_mb, b_cidx=b_cidx, b_slot=b_slot,
        recv_slot=recv_slot, b_gslot=b_gslot, grecv_slot=grecv_slot,
    )


def device_major_perm(n: int, v: int, chunk_rows: int = 1):
    """Stage-axis permutation into device-major chunk order: row group
    ``(d, c)`` holds the ``chunk_rows`` consecutive rows of virtual
    stage ``d + c·n``, so ``P('pp')`` sharding hands device ``d``
    exactly its ``v`` chunks."""
    return [
        (d + c * n) * chunk_rows + j
        for d in range(n) for c in range(v) for j in range(chunk_rows)
    ]


def to_device_major(stage_major: np.ndarray, n: int, v: int,
                    chunk_rows: int = 1) -> np.ndarray:
    """Reorder a ``[n·v·chunk_rows, …]`` stage-major param array into
    device-major chunk order (see :func:`device_major_perm`)."""
    return stage_major[np.asarray(device_major_perm(n, v, chunk_rows))]


def from_device_major(dev_major: np.ndarray, n: int, v: int,
                      chunk_rows: int = 1) -> np.ndarray:
    """Inverse of :func:`to_device_major`."""
    perm = np.asarray(device_major_perm(n, v, chunk_rows))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return np.asarray(dev_major)[inv]


def _sched_tables(s: InterleavedSchedule) -> Dict[str, np.ndarray]:
    """The schedule's per-tick tables by name (host int32 arrays)."""
    return {
        k: np.asarray(getattr(s, k))
        for k in ("f_mb", "f_cidx", "f_slot", "b_mb", "b_cidx", "b_slot",
                  "recv_slot", "b_gslot", "grecv_slot")
    }


def interleaved_grads_local(block_fn: Callable, loss_grad_fn: Callable,
                            params_local: Params, x_mb: torch.Tensor,
                            target_mb: torch.Tensor,
                            sched: InterleavedSchedule, line,
                            chunk_rows: int = 1,
                            pp_overlap: str = "none",
                            pp_chunks: int = 1):
    """Run the interleaved schedule on this rank's pp ``line`` — the
    reference's legacy executor, tick for tick: every tick runs the
    backward body (the chunk's forward rematerialized from the stashed
    input, its gradient taken with ``torch.autograd.grad``) and the
    forward body, each masked by its table entry (``torch.where``: an off
    op leaves an accumulator's bits as they are), then ships the
    activation over the forward ring and dx over the backward ring.

    ``params_local`` leaves: the rank's ``[v·chunk_rows, …]`` rows in
    device-major chunk order; ``block_fn(chunk, x)`` applies one virtual
    stage from its ``[chunk_rows, …]`` rows. ``pp_overlap="wave"`` with
    ``pp_chunks`` > 1 ships both directions as token-chunk waves
    (:func:`~tpu_p2p_torch.parallel.collectives.chunked_ppermute_compute`;
    the same bytes and values). → ``(loss summed over the line,
    {leaf: float32 gradient})``. The reference's ``vma_axes`` /
    ``dparam_vma`` type its carries for ``shard_map`` and have no torch
    counterpart."""
    from tpu_p2p_torch.models.schedule import _line_sum
    from tpu_p2p_torch.obs.ledger import ScanBody
    from tpu_p2p_torch.parallel.collectives import (
        axis_ppermute,
        chunked_ppermute_compute,
    )

    n, my = line.size, line.index
    v, m = sched.chunks, sched.microbatches
    fwd_edges = [(i, (i + 1) % n) for i in range(n)]
    bwd_edges = [((i + 1) % n, i) for i in range(n)]
    wave = pp_overlap == "wave" and pp_chunks > 1
    tb = _sched_tables(sched)
    dev = x_mb.device
    zero_mb = torch.zeros(x_mb.shape[1:], dtype=x_mb.dtype, device=dev)
    zero_g = torch.zeros(x_mb.shape[1:], dtype=torch.float32, device=dev)
    x_stash = [zero_mb] * sched.act_slots
    g_stash = [zero_g] * sched.grad_slots
    dparams = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params_local.items()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    flag = {True: torch.tensor(True, device=dev),
            False: torch.tensor(False, device=dev)}

    def pick(name: str, t: int) -> int:
        return int(tb[name][t, my])

    def clip(i: int, hi: int) -> int:
        return min(max(int(i), 0), hi)

    def chunk_of(cidx: int):
        start = clip(cidx, v - 1) * chunk_rows
        return {k: p[start:start + chunk_rows]
                for k, p in params_local.items()}, start

    def ship(y, edges, label):
        if n == 1:
            return y
        if wave:
            return chunked_ppermute_compute(
                lambda c, _i: c, y, line, edges, chunk_dim=1,
                chunks=pp_chunks, label=label)
        return axis_ppermute(y, line, edges, label=label)

    y_recv, g_recv = zero_mb, zero_g
    body = ScanBody()  # the tick scan: each ship records once
    for t in range(sched.num_ticks):
        rs, gs = pick("recv_slot", t), pick("grecv_slot", t)
        if rs >= 0:
            x_stash[clip(rs, sched.act_slots - 1)] = y_recv
        if gs >= 0:
            g_stash[clip(gs, sched.grad_slots - 1)] = g_recv

        # Backward: the chunk's forward rematerialized, then its grads.
        b_mb, b_cidx = pick("b_mb", t), pick("b_cidx", t)
        b_on = flag[b_mb >= 0]
        x_saved = x_stash[clip(pick("b_slot", t), sched.act_slots - 1)]
        chunk_b, b_start = chunk_of(b_cidx)
        leaves = {k: c.detach().requires_grad_(True)
                  for k, c in chunk_b.items()}
        xs = x_saved.detach().requires_grad_(True)
        tgt = target_mb[clip(b_mb, m - 1)]
        g_mid = g_stash[clip(pick("b_gslot", t), sched.grad_slots - 1)]
        # The last virtual stage is chunk v-1 on device n-1.
        is_last = my == n - 1 and b_cidx == v - 1
        with torch.enable_grad():
            y_re = block_fn(leaves, xs)
            loss_mb, g_loss = loss_grad_fn(y_re.detach(), tgt)
            g_in = g_loss if is_last else g_mid
            grads = torch.autograd.grad(
                y_re, [xs, *leaves.values()],
                grad_outputs=g_in.to(y_re.dtype), allow_unused=True)
        for k, g in zip(leaves, grads[1:]):
            if g is None:
                continue
            acc = dparams[k]
            cur = acc[b_start:b_start + chunk_rows]
            acc[b_start:b_start + chunk_rows] = torch.where(
                b_on, cur + g.float(), cur)
        loss_acc = loss_acc + torch.where(
            flag[b_mb >= 0 and is_last], loss_mb.float(),
            torch.zeros_like(loss_acc))
        dx = grads[0] if grads[0] is not None else zero_mb
        dx = torch.where(b_on, dx.float(), zero_g)

        # Forward.
        f_mb, f_cidx = pick("f_mb", t), pick("f_cidx", t)
        f_on = f_mb >= 0
        f_slot = clip(pick("f_slot", t), sched.act_slots - 1)
        # Virtual stage 0 (chunk 0 on device 0) reads the feed.
        x_in = x_mb[clip(f_mb, m - 1)] if my == 0 and f_cidx == 0 \
            else x_stash[f_slot]
        x_stash[f_slot] = torch.where(flag[f_on], x_in, x_stash[f_slot])
        with torch.no_grad():
            y_f = block_fn(chunk_of(f_cidx)[0], x_in)
        y_f = torch.where(flag[f_on], y_f, zero_mb)

        with body.site("fwd"):
            y_recv = ship(y_f, fwd_edges, "pp_fwd_ship")
        with body.site("bwd"):
            g_recv = ship(dx, bwd_edges, "pp_bwd_ship")
    return _line_sum(loss_acc, line, "pp_loss_replicate"), dparams


def _pp_size(mesh) -> int:
    if mesh is None or "pp" not in mesh.axis_names:
        raise ValueError("mesh needs a 'pp' axis for pipeline parallelism")
    return mesh.line("pp").size


def make_interleaved_train_step(mesh, cfg: PipelineConfig, chunks: int,
                                block_fn: Callable = mlp_block,
                                lr: float = 1e-2,
                                loss_grad_fn: Callable = _mse_loss_grad,
                                pp_overlap: str = "none",
                                pp_chunks: int = 1):
    """One SGD step under the interleaved 1F1B schedule: ``cfg.stages``
    must equal ``pp size · chunks``; params use the device-major layout
    (:func:`place_interleaved_params`). The GPipe step's loss
    normalization and update. Routed through the tick IR
    (``compile_interleaved → lower() → tick_grads_local``)."""
    from tpu_p2p_torch.models.schedule import (
        compile_interleaved,
        make_tick_train_step,
    )

    n = _pp_size(mesh)
    if cfg.stages != n * chunks:
        raise ValueError(
            f"stages ({cfg.stages}) must equal pp size ({n}) x chunks "
            f"({chunks})"
        )
    return make_tick_train_step(
        mesh, cfg, compile_interleaved(cfg.microbatches, n, chunks),
        block_fn=block_fn, lr=lr, loss_grad_fn=loss_grad_fn,
        pp_overlap=pp_overlap, pp_chunks=pp_chunks)


def make_interleaved_train_step_reference(
        mesh, cfg: PipelineConfig, chunks: int,
        block_fn: Callable = mlp_block, lr: float = 1e-2,
        loss_grad_fn: Callable = _mse_loss_grad, pp_overlap: str = "none",
        pp_chunks: int = 1):
    """Parity fixture: the legacy hand-rolled interleaved 1F1B step
    (:func:`interleaved_grads_local`), the reference's
    ``make_interleaved_train_step_reference``, with
    :func:`make_interleaved_train_step`'s checks, normalization and
    update. Production code goes through the tick IR."""
    from tpu_p2p_torch.models.flagship_steps import _sgd_update
    from tpu_p2p_torch.models.pipeline import _to_microbatches
    from tpu_p2p_torch.obs.ledger import program

    n = _pp_size(mesh)
    if cfg.stages != n * chunks:
        raise ValueError(
            f"stages ({cfg.stages}) must equal pp size ({n}) x chunks "
            f"({chunks})"
        )
    line = mesh.line("pp")
    sched = build_interleaved_schedule(cfg.microbatches, n, chunks)

    def step(params, x, target):
        loss_sum, grads = interleaved_grads_local(
            block_fn, loss_grad_fn, params,
            _to_microbatches(x, cfg.microbatches),
            _to_microbatches(target, cfg.microbatches), sched, line,
            pp_overlap=pp_overlap, pp_chunks=pp_chunks)
        denom = float(np.prod(tuple(x.shape)))
        return _sgd_update(params, grads, lr, denom), loss_sum / denom

    return program(step)


def place_interleaved_params(params, mesh, chunks: int,
                             device=None) -> Params:
    """This rank's rows of stage-major params in device-major chunk
    order (the stage dim split over ``pp``), on ``device`` (default: the
    mesh's). ``params``: tensors (permuted on their own device) or numpy
    arrays."""
    n = _pp_size(mesh)
    specs = pp_param_specs(mesh)
    dev = device if device is not None else mesh.device
    out = {}
    for k, v in params.items():
        if isinstance(v, torch.Tensor):
            perm = torch.as_tensor(device_major_perm(n, chunks),
                                   device=v.device)
            dm = v[perm]
        else:
            dm = torch.from_numpy(np.ascontiguousarray(
                to_device_major(np.asarray(v), n, chunks)))
        out[k] = local_shard(dm, mesh, specs[k]).contiguous().to(dev)
    return out


def unplace_interleaved_params(params: Params, mesh, chunks: int
                               ) -> Dict[str, np.ndarray]:
    """Back to stage-major host arrays (for oracle comparison): each
    leaf's rows gathered over pp (collective over the pp line), then out
    of the device-major order."""
    from tpu_p2p_torch.models.flagship_params import gather_leaf

    n = _pp_size(mesh)
    specs = pp_param_specs(mesh)
    return {
        k: from_device_major(
            gather_leaf(v, mesh, specs[k]).detach().cpu().numpy(), n,
            chunks)
        for k, v in params.items()
    }
