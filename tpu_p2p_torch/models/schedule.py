"""The tick-schedule IR and its one executor — the port of
``tpu_p2p/models/schedule.py``.

- **The IR.** A :class:`TickProgram` is an ordered list of
  :class:`Tick`\\ s, each ``{compute: (kind, device, chunk, microbatch)
  ops, hops: (payload, edge set)}``: a host-side description, no
  tensors. Op kinds: ``fwd``, ``bwd`` (the fused input+weight backward),
  ``bwd_input`` (dx only, the pipeline's critical path) and
  ``bwd_weight`` (dW only, the bubble filler): the zero-bubble split of
  Qi et al. (arXiv:2401.10241).
- **Compilers.** :func:`compile_gpipe`, :func:`compile_1f1b`,
  :func:`compile_interleaved` (the interleaved greedy builder of
  :mod:`~tpu_p2p_torch.models.pipeline_interleaved`) and
  :func:`compile_zb` (ZB-H1: plain 1F1B with the backward split, the
  ``bwd_weight`` ticks in the warmup/drain holes, per-stage dW in
  microbatch order). :func:`lower` turns a program into per-tick integer
  tables with interval-colored stash slots, under ``tick_lowering=
  "masked"`` or ``"switch"``. This half is pure Python and its output
  equals the reference's (programs, tables, :func:`bubble_fraction`,
  :func:`per_rank_idle`, :func:`price_program`).
- **One executor, in torch.** :func:`make_tick_train_step` runs any
  program on this rank's pp line (a process mesh; one process a rank):
  forward-only programs (GPipe) through :func:`tick_forward_local`,
  whose masks are tensor ops and whose backward is autograd's; programs
  with backward ticks through :func:`tick_grads_local`, which
  rematerializes each stage forward from the stashed input at the
  backward tick and runs ``torch.autograd.grad`` on that tick's graph.
  The weight products' gradients go through the ZB split's store
  (:mod:`~tpu_p2p_torch.models.zb_split`): made inline at a ``bwd``
  tick, deferred from ``bwd_input`` to ``bwd_weight`` in a split
  program, so zb is bitwise the fused step.
- **The one ship site.** Every stage hop goes through :func:`_ship`,
  :func:`~tpu_p2p_torch.parallel.collectives.chunked_ppermute_compute`
  with the identity compute: ``pp_overlap="wave"`` (``pp_chunks`` token
  chunks) and ``transport="pallas_dma"`` (the peer-push kernels) are
  choices of that one call.
- **Lowerings.** ``"masked"``: every rank runs every tick's bodies and
  masks the results (``torch.where``; a masked zero leaves an
  accumulator's bits as they are). ``"switch"``: each rank dispatches on
  its ``op_code`` row in Python, so an idle rank skips the compute; the
  stash receives and both hops stay outside the dispatch, so every rank
  joins every tick's hop. The branch bodies are the masked bodies
  without the masks, so the two lowerings are bitwise equal.

- **The flight-recorder hook.** ``tick_times`` (None by default: no
  stamp, nothing changes) is a :class:`~tpu_p2p_torch.obs.tickprof.
  TickRecorder`: each rank stamps a seed (tick ``-1``) before its ticks,
  then each tick twice, after its compute (phase 0) and after its hops
  (phase 1), where the reference's ``_tick_stamp`` / ``_tick_seed``
  stamp. The loop runs eagerly, so a host clock read would mark when a
  tick was issued, not when it ran: on a card the recorder records a
  CUDA event on the rank's stream at each stamp and turns them into
  times after the step's own synchronization; on the CPU (gloo, whose
  collectives block) it reads the host clock at the same points.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_p2p_torch.config import TICK_LOWERINGS
from tpu_p2p_torch.obs import ledger as _ledger

Edge = Tuple[int, int]

# Canonical kind order of the compact switch op table: index 0 is
# always "noop"; a program's table then carries, in this order, only
# the kinds it actually issues — so a zb program dispatches over
# (noop, fwd, bwd_input, bwd_weight) and a fused program over
# (noop, fwd, bwd), and the dispatch never meets a branch the program
# cannot take.
_SWITCH_KIND_ORDER = ("fwd", "bwd", "bwd_input", "bwd_weight")

# Analytic op costs in forward-units: the fused backward computes both
# dx and dW against a rematerialized forward (~2x the forward's
# FLOPs). Under the true ZB-H1 split (tpu_p2p/models/zb_split.py) the
# fused backward trace is PARTITIONED, not re-run: ``bwd_input``
# carries the remat + dx chain (~1 forward-unit) and ``bwd_weight``
# replays only the dW GEMM contractions against the stashed boundary —
# roughly one GEMM per layer where the forward pays one GEMM plus the
# activation chain, hence below 1.0. Bubble fractions derived from
# these are schedule properties, not measurements.
OP_COST = {
    "fwd": 1.0,
    "bwd": 2.0,
    "bwd_input": 1.0,
    "bwd_weight": 0.5,
}

OP_KINDS = tuple(OP_COST)


@dataclass(frozen=True)
class TickOp:
    """One compute op: ``device`` runs ``kind`` for local chunk
    ``chunk`` (virtual stage ``device + chunk * devices``) of
    microbatch ``microbatch``."""

    kind: str
    device: int
    chunk: int
    microbatch: int


@dataclass(frozen=True)
class TickHop:
    """One collective hop issued this tick: ``payload`` names what
    rides the wire (``activation`` fwd ships, ``gradient`` bwd
    ships); ``edges`` is the ``ppermute`` edge set."""

    payload: str
    edges: Tuple[Edge, ...]


@dataclass(frozen=True)
class Tick:
    compute: Tuple[TickOp, ...]
    hops: Tuple[TickHop, ...] = ()


@dataclass(frozen=True)
class TickProgram:
    """An ordered tick schedule over ``devices`` pp ranks, each
    holding ``chunks`` local virtual-stage chunks, processing
    ``microbatches`` microbatches."""

    name: str
    devices: int
    chunks: int
    microbatches: int
    ticks: Tuple[Tick, ...]

    @property
    def num_ticks(self) -> int:
        return len(self.ticks)

    @property
    def has_backward(self) -> bool:
        return any(op.kind != "fwd" for t in self.ticks
                   for op in t.compute)

    @property
    def has_split_backward(self) -> bool:
        return any(op.kind in ("bwd_input", "bwd_weight")
                   for t in self.ticks for op in t.compute)


# ------------------------------------------------------------ analysis


def bubble_fraction(program: TickProgram) -> float:
    """Idle share of the program under :data:`OP_COST`: each tick is a
    device-synchronous barrier costing the most expensive op issued in
    it, so ``1 - busy/(devices * span)`` is the fraction of
    device-ticks spent waiting — the pipeline bubble. GPipe's forward
    program yields the classic ``(S-1)/(M+S-1)``; the zero-bubble
    split beats fused 1F1B because ``bwd_weight`` ticks fill
    warmup/drain holes and the gradient wave crosses stages at
    ``bwd_input`` (1 unit) speed instead of fused-``bwd`` (2 unit)
    speed."""
    n = program.devices
    span = 0.0
    busy = [0.0] * n
    for tick in program.ticks:
        span += max((OP_COST[op.kind] for op in tick.compute),
                    default=1.0)
        for op in tick.compute:
            busy[op.device] += OP_COST[op.kind]
    if span <= 0:
        return 0.0
    return 1.0 - sum(busy) / (n * span)


def per_rank_idle(program: TickProgram) -> List[dict]:
    """Per-rank idle accounting under :data:`OP_COST` — the rank-level
    decomposition of :func:`bubble_fraction`: for each device, its
    busy/idle cost split, its own bubble fraction, and its explicit
    ``idle_spans`` — maximal ``[start_tick, end_tick)`` runs of ticks
    where the rank issues no compute op. Under the masked lowering
    those spans are where-masked full bodies (the rank still pays
    them); under the switch lowering they are genuinely idle."""
    n = program.devices
    tick_cost = [max((OP_COST[op.kind] for op in t.compute),
                     default=1.0) for t in program.ticks]
    span = sum(tick_cost)
    out: List[dict] = []
    for d in range(n):
        busy = 0.0
        spans: List[List[int]] = []
        for t, tick in enumerate(program.ticks):
            ops = [op for op in tick.compute if op.device == d]
            if ops:
                busy += sum(OP_COST[op.kind] for op in ops)
            elif spans and spans[-1][1] == t:
                spans[-1][1] = t + 1
            else:
                spans.append([t, t + 1])
        idle = max(span - busy, 0.0)
        out.append({
            "device": d,
            "busy_cost": busy,
            "idle_cost": idle,
            "bubble_frac": (idle / span) if span > 0 else 0.0,
            "idle_spans": [tuple(s) for s in spans],
        })
    return out


def price_program(program: TickProgram, payload_bytes: int,
                  topology=None) -> dict:
    """Analytic transport bill of one program execution, priced with
    the collective ledger's busbw conventions
    (:func:`tpu_p2p_torch.obs.ledger.wire_bytes` — per directed link for the
    permute family): per-tick rows plus totals. ``gradient``
    hops carry float32 cotangents; callers pass the per-payload byte
    count they care about (the executors ship one microbatch shard per
    hop). ``per_rank`` prices each rank's idle ticks explicitly
    (:func:`per_rank_idle`) — the bubble decomposed to the device
    whose wall clock it is, which is what the cost-proportional
    switch lowering turns from an accounting fiction into genuinely
    idle time.

    ``topology`` (a :class:`tpu_p2p_torch.topo.model.Topology`)
    upgrades the bill to per-link pricing: each hop's predicted wall
    time is the payload over
    its slowest effective link — rows gain ``hop_s`` /
    ``bottleneck_edge`` / ``bottleneck_gbps``, the totals
    ``hop_s_total`` and ``bottleneck_gbps_min``. With ``topology=None``
    the bill is the uniform one."""
    rows: List[dict] = []
    total_wire = 0
    total_hop_s = 0.0
    min_gbps = None
    for i, tick in enumerate(program.ticks):
        for hop in tick.hops:
            wire = _ledger.wire_bytes("ppermute", program.devices,
                                      payload_bytes)
            row = {
                "tick": i,
                "payload": hop.payload,
                "edges": hop.edges,
                "wire_bytes": wire,
            }
            if topology is not None and hop.edges:
                # REPORTING view (penalty off): the bill predicts
                # what the wire would do, not the avoidance bias the
                # optimizers steer by (Topology.ship_time_s).
                hop_s = topology.ship_time_s(payload_bytes, hop.edges,
                                             effective=False)
                bneck = topology.bottleneck_edge(hop.edges,
                                                 effective=False)
                gbps = topology.link_gbps(*bneck)
                row.update({
                    "hop_s": hop_s,
                    "bottleneck_edge": bneck,
                    "bottleneck_gbps": gbps,
                })
                total_hop_s += hop_s
                min_gbps = gbps if min_gbps is None \
                    else min(min_gbps, gbps)
            rows.append(row)
            total_wire += wire
    bill = {
        "name": program.name,
        "ticks": program.num_ticks,
        "hops": len(rows),
        "wire_bytes_total": total_wire,
        "bubble_frac": bubble_fraction(program),
        "per_rank": per_rank_idle(program),
        "rows": rows,
    }
    if topology is not None:
        bill["hop_s_total"] = total_hop_s
        bill["bottleneck_gbps_min"] = min_gbps
        bill["topology_source"] = topology.source
    return bill


# ----------------------------------------------------------- compilers


def _ring_edges(n: int) -> Tuple[Edge, ...]:
    return tuple((i, (i + 1) % n) for i in range(n))


def _ring_edges_rev(n: int) -> Tuple[Edge, ...]:
    return tuple(((i + 1) % n, i) for i in range(n))


def _chain_edges(n: int) -> Tuple[Edge, ...]:
    return tuple((i, i + 1) for i in range(n - 1))


def compile_gpipe(microbatches: int, devices: int) -> TickProgram:
    """The GPipe forward schedule as an IR program: tick ``t`` runs
    stage ``s``'s forward of microbatch ``t - s`` (bubble ticks
    elsewhere), activations hopping the no-wraparound neighbor edges.
    The backward is autograd's mirror — the executor differentiates
    through the ticks, exactly the
    :func:`tpu_p2p_torch.models.pipeline.pipeline_apply_local` contract."""
    m, n = int(microbatches), int(devices)
    if m < 1 or n < 1:
        raise ValueError(f"need microbatches >= 1, devices >= 1; "
                         f"got {m}, {n}")
    hops = (TickHop("activation", _chain_edges(n)),) if n > 1 else ()
    ticks = []
    for t in range(m + n - 1):
        ops = tuple(
            TickOp("fwd", s, 0, t - s)
            for s in range(n) if 0 <= t - s < m
        )
        ticks.append(Tick(compute=ops, hops=hops))
    return TickProgram(name="gpipe", devices=n, chunks=1,
                       microbatches=m, ticks=tuple(ticks))


def compile_interleaved(microbatches: int, devices: int,
                        chunks: int) -> TickProgram:
    """The interleaved (Megatron-style) 1F1B schedule as an IR
    program, emitted from the SAME greedy builder the legacy executor
    runs (:func:`tpu_p2p_torch.models.pipeline_interleaved.
    build_interleaved_schedule`) — so the compiled program's tick
    tables are byte-identical to the legacy schedule and the executed
    step is bitwise the legacy step."""
    from tpu_p2p_torch.models.pipeline_interleaved import (
        build_interleaved_schedule,
    )

    m, n, v = int(microbatches), int(devices), int(chunks)
    sched = build_interleaved_schedule(m, n, v)
    hops: Tuple[TickHop, ...] = ()
    if n > 1:
        hops = (TickHop("activation", _ring_edges(n)),
                TickHop("gradient", _ring_edges_rev(n)))
    ticks = []
    for t in range(sched.num_ticks):
        ops = []
        for d in range(n):
            if sched.f_mb[t, d] >= 0:
                ops.append(TickOp("fwd", d, int(sched.f_cidx[t, d]),
                                  int(sched.f_mb[t, d])))
            if sched.b_mb[t, d] >= 0:
                ops.append(TickOp("bwd", d, int(sched.b_cidx[t, d]),
                                  int(sched.b_mb[t, d])))
        ticks.append(Tick(compute=tuple(ops), hops=hops))
    return TickProgram(name="interleaved" if v > 1 else "1f1b",
                       devices=n, chunks=v, microbatches=m,
                       ticks=tuple(ticks))


def compile_1f1b(microbatches: int, devices: int) -> TickProgram:
    """Plain 1F1B = the ``chunks=1`` degeneration of the interleaved
    schedule — the same identity the legacy executor uses
    (:func:`~tpu_p2p_torch.models.pipeline_1f1b.
    make_pipeline_train_step_1f1b` delegates to the interleaved step
    with ``chunks=1``), so IR-vs-legacy parity is definitional."""
    return compile_interleaved(microbatches, devices, 1)


def compile_zb(microbatches: int, devices: int) -> TickProgram:
    """ZB-H1-style zero-bubble 1F1B: the fused backward splits into
    ``bwd_input`` (dx — the inter-stage critical path) and
    ``bwd_weight`` (dW — no consumer downstream, so it fills bubbles).

    Greedy per-device policy, one op per device per tick like the
    legacy builders: warm up with ``min(M, S - s)`` forwards, then
    cycle F → Bi → W (a ``bwd_weight`` issues right after its
    ``bwd_input`` when nothing on the critical path is ready —
    keeping the activation stash 1F1B-shaped); in the drain, the
    ``bwd_input`` wave crosses one stage per tick (half the fused
    backward's latency) and the opened holes fill with the deferred
    ``bwd_weight`` ticks — which is where the bubble shrinks.

    Bitwise contract: per stage, ``bwd_weight`` ops issue strictly in
    microbatch order (FIFO over completed ``bwd_input``\\ s), so the
    dW accumulation sequence — and therefore the step — is bitwise
    the fused 1F1B executor's. ``devices == 1`` has no inter-stage
    critical path to shorten (and no bubble to fill), so the compiler
    degrades to the fused schedule — the same size-1 degrade contract
    as every overlap knob.
    """
    m, n = int(microbatches), int(devices)
    if m < 1 or n < 1:
        raise ValueError(f"need microbatches >= 1, devices >= 1; "
                         f"got {m}, {n}")
    if n == 1:
        prog = compile_1f1b(m, 1)
        return TickProgram(name="zb", devices=1, chunks=1,
                           microbatches=m, ticks=prog.ticks)
    s = n
    fwd_tick = np.full((s, m), -1, np.int64)
    bi_tick = np.full((s, m), -1, np.int64)
    next_f = [0] * s
    next_bi = [0] * s
    next_w = [0] * s
    last_kind = [""] * s
    warmup = [min(m, s - st) for st in range(s)]
    ops_at: Dict[int, List[TickOp]] = {}

    t = 0
    guard = 8 * (m + s) + 16
    while any(next_w[st] < m for st in range(s)):
        if t > guard:
            raise RuntimeError(
                f"zb schedule did not converge (M={m}, S={s})"
            )
        for st in range(s):
            def f_ready():
                mb = next_f[st]
                return mb < m and (
                    st == 0 or 0 <= fwd_tick[st - 1, mb] < t
                )

            def b_ready():
                mb = next_bi[st]
                if mb >= m:
                    return False
                if st < s - 1:
                    return 0 <= bi_tick[st + 1, mb] < t
                return 0 <= fwd_tick[st, mb] < t

            def w_avail():
                return next_w[st] < next_bi[st]

            # Preference order: warmup forwards first (the 1F1B fill);
            # after a Bi, its W (memory stays 1F1B-shaped) unless the
            # critical path idles; after a W, feed the pipe (F); after
            # an F, drain (Bi). Unready preferences fall through, and
            # W — always "ready" once its Bi ran — is the filler.
            if next_f[st] < warmup[st]:
                prefs = ("F", "B", "W")
            elif last_kind[st] == "B":
                prefs = ("W", "F", "B")
            elif last_kind[st] == "W":
                prefs = ("F", "B", "W")
            else:
                prefs = ("B", "W", "F")
            for k in prefs:
                if k == "F" and f_ready():
                    mb = next_f[st]
                    fwd_tick[st, mb] = t
                    next_f[st] += 1
                    last_kind[st] = "F"
                    ops_at.setdefault(t, []).append(
                        TickOp("fwd", st, 0, mb))
                    break
                if k == "B" and b_ready():
                    mb = next_bi[st]
                    bi_tick[st, mb] = t
                    next_bi[st] += 1
                    last_kind[st] = "B"
                    ops_at.setdefault(t, []).append(
                        TickOp("bwd_input", st, 0, mb))
                    break
                if k == "W" and w_avail():
                    mb = next_w[st]
                    next_w[st] += 1
                    last_kind[st] = "W"
                    ops_at.setdefault(t, []).append(
                        TickOp("bwd_weight", st, 0, mb))
                    break
        t += 1

    hops = (TickHop("activation", _ring_edges(n)),
            TickHop("gradient", _ring_edges_rev(n)))
    ticks = tuple(
        Tick(compute=tuple(ops_at.get(i, ())), hops=hops)
        for i in range(t)
    )
    return TickProgram(name="zb", devices=n, chunks=1,
                       microbatches=m, ticks=ticks)


# ------------------------------------------------------------ lowering


@dataclass(frozen=True)
class LoweredProgram:
    """Executable form of a :class:`TickProgram`: per-tick int32
    tables ``[T, devices]`` (−1 = no op) plus interval-colored stash
    slot counts — the exact table family the legacy interleaved
    executor runs, extended with ``w_*`` tables for split-backward
    programs. Forward-only programs carry just the feed/record
    tables.

    ``lowering`` names how the executor runs the tables:
    ``"masked"`` = every rank runs every tick body, idle work masked;
    ``"switch"`` = per-rank tick timelines — ``tables["op_code"]``
    indexes ``op_table`` (a compact per-program kind tuple,
    ``op_table[0] == "noop"`` always) and each rank dispatches its tick
    on it. Both lowerings execute
    the same ops on the same operands in the same order, so the step
    is bitwise identical; only what idle ranks pay differs."""

    program: TickProgram
    forward_only: bool
    split: bool
    act_slots: int
    grad_slots: int
    fwd_edges: Tuple[Edge, ...]
    bwd_edges: Tuple[Edge, ...]
    tables: Dict[str, np.ndarray]
    lowering: str = "masked"
    op_table: Tuple[str, ...] = ("noop",)
    # Split programs only: slot count of the boundary stash — the
    # weight-gradient records (tpu_p2p_torch/models/zb_split.py) parked
    # between a microbatch's bwd_input and bwd_weight ticks,
    # interval-colored like the activation/gradient stashes.
    bnd_slots: int = 0


def _op_ticks(program: TickProgram):
    """→ per-virtual-stage op tick tables ``[s_virt, m]`` (−1 where
    the program never issues the op)."""
    n, v, m = program.devices, program.chunks, program.microbatches
    s_virt = n * v
    fwd = np.full((s_virt, m), -1, np.int64)
    bwd = np.full((s_virt, m), -1, np.int64)   # bwd or bwd_input
    wgt = np.full((s_virt, m), -1, np.int64)   # bwd_weight
    for t, tick in enumerate(program.ticks):
        for op in tick.compute:
            sv = op.device + op.chunk * n
            tbl = {"fwd": fwd, "bwd": bwd, "bwd_input": bwd,
                   "bwd_weight": wgt}[op.kind]
            if tbl[sv, op.microbatch] >= 0:
                raise ValueError(
                    f"{program.name}: duplicate {op.kind} for virtual "
                    f"stage {sv} microbatch {op.microbatch}"
                )
            tbl[sv, op.microbatch] = t
    return fwd, bwd, wgt


def _switch_tables(program: TickProgram):
    """→ ``(op_table, op_code [T, devices])`` for the switch lowering:
    the compact per-program kind tuple (``noop`` first, then the
    kinds the program issues in :data:`_SWITCH_KIND_ORDER`) and the
    per-rank tick timeline indexing it. The one-op-per-device-per-tick
    discipline every compiler keeps is what makes a single branch
    index per (tick, rank) sufficient — a program violating it cannot
    lower to switch and fails loudly here."""
    kinds = {op.kind for t in program.ticks for op in t.compute}
    op_table = ("noop",) + tuple(k for k in _SWITCH_KIND_ORDER
                                 if k in kinds)
    code_of = {k: i for i, k in enumerate(op_table)}
    op_code = np.zeros((program.num_ticks, program.devices), np.int32)
    for t, tick in enumerate(program.ticks):
        for op in tick.compute:
            if op_code[t, op.device] != 0:
                raise ValueError(
                    f"{program.name}: device {op.device} has more "
                    f"than one compute op at tick {t} — the switch "
                    "lowering dispatches one branch per rank per tick"
                )
            op_code[t, op.device] = code_of[op.kind]
    return op_table, op_code


def lower(program: TickProgram,
          tick_lowering: str = "masked") -> LoweredProgram:
    """Lower an IR program to executor tables.

    Stash slots are interval-colored per device with the SAME
    deterministic coloring (and the same interval construction order)
    as the legacy builder
    (:func:`~tpu_p2p_torch.models.pipeline_1f1b._color_intervals`), so a
    program compiled from the legacy schedule lowers to the legacy
    slot assignment exactly — the bitwise IR-vs-executor contract.
    Split programs keep the fused activation/gradient lifetimes (both
    stashes release at the ``bwd_input`` tick, which consumes them); what the deferred ``bwd_weight`` tick reads instead is the
    boundary stash (``b_bnd`` write slot at the Bi tick, ``w_bnd``
    read slot at the W tick), interval-colored over each microbatch's
    Bi→W span and holding the weight-gradient records of the split
    backward (:mod:`tpu_p2p_torch.models.zb_split`).

    ``tick_lowering="switch"`` additionally emits the per-rank
    ``op_code`` timeline over the program's compact ``op_table`` (see
    :class:`LoweredProgram`); ``"masked"`` keeps the legacy tables."""
    from tpu_p2p_torch.models.pipeline_1f1b import _color_intervals

    if tick_lowering not in TICK_LOWERINGS:
        raise ValueError(
            f"unknown tick_lowering {tick_lowering!r}; expected one "
            f"of {TICK_LOWERINGS}"
        )
    n, v, m = program.devices, program.chunks, program.microbatches
    s_virt = n * v
    T = program.num_ticks
    fwd_edges = next((h.edges for t in program.ticks for h in t.hops
                      if h.payload == "activation"), ())
    bwd_edges = next((h.edges for t in program.ticks for h in t.hops
                      if h.payload == "gradient"), ())
    fwd_tick, bwd_tick, w_tick = _op_ticks(program)

    op_table: Tuple[str, ...] = ("noop",)
    op_code = None
    if tick_lowering == "switch":
        op_table, op_code = _switch_tables(program)

    if not program.has_backward:
        if (fwd_tick < 0).any():
            raise ValueError(f"{program.name}: forward ops missing")
        if tick_lowering == "switch" and v != 1:
            raise ValueError(
                f"{program.name}: the switch lowering of forward-only "
                "programs supports chunks=1 only (no chunked "
                "forward-only compiler exists)"
            )
        feed_mb = np.full((T,), -1, np.int32)
        out_mb = np.full((T,), -1, np.int32)
        for mb in range(m):
            feed_mb[fwd_tick[0, mb]] = mb
            out_mb[fwd_tick[s_virt - 1, mb]] = mb
        tables = {"feed_mb": feed_mb, "out_mb": out_mb}
        if op_code is not None:
            tables["op_code"] = op_code
        return LoweredProgram(
            program=program, forward_only=True, split=False,
            act_slots=0, grad_slots=0,
            fwd_edges=tuple(fwd_edges), bwd_edges=(),
            tables=tables, lowering=tick_lowering, op_table=op_table,
        )

    split = program.has_split_backward
    if (fwd_tick < 0).any() or (bwd_tick < 0).any():
        raise ValueError(f"{program.name}: fwd/bwd ops missing")
    if split and (w_tick < 0).any():
        raise ValueError(f"{program.name}: bwd_weight ops missing")

    # Interval coloring, per device, in the legacy builder's exact
    # construction order (chunk-major then microbatch). Activation and
    # gradient lifetimes are fused-shaped even for split programs —
    # the bwd_input tick drains both; only the boundary
    # stash (below) spans Bi→W.
    act_slots, grad_slots, bnd_slots = 0, 1, 0
    act_assign: Dict = {}
    grad_assign: Dict = {}
    bnd_assign: Dict = {}
    for d in range(n):
        act_iv: List[Tuple[int, int, object]] = []
        grad_iv: List[Tuple[int, int, object]] = []
        bnd_iv: List[Tuple[int, int, object]] = []
        for c in range(v):
            sv = d + c * n
            for mb in range(m):
                w = (fwd_tick[sv, mb] if sv == 0
                     else fwd_tick[sv - 1, mb] + 1)
                act_iv.append((int(w), int(bwd_tick[sv, mb]),
                               (sv, mb)))
                if sv < s_virt - 1:
                    grad_iv.append((int(bwd_tick[sv + 1, mb] + 1),
                                    int(bwd_tick[sv, mb]), (sv, mb)))
                if split:
                    bnd_iv.append((int(bwd_tick[sv, mb]),
                                   int(w_tick[sv, mb]), (sv, mb)))
        cnt, assign = _color_intervals(act_iv)
        act_slots = max(act_slots, cnt)
        act_assign.update(assign)
        if grad_iv:
            cnt, assign = _color_intervals(grad_iv)
            grad_slots = max(grad_slots, cnt)
            grad_assign.update(assign)
        if bnd_iv:
            cnt, assign = _color_intervals(bnd_iv)
            bnd_slots = max(bnd_slots, cnt)
            bnd_assign.update(assign)

    tables = {
        k: np.full((T, n), -1, np.int32)
        for k in ("f_mb", "f_cidx", "f_slot", "b_mb", "b_cidx",
                  "b_slot", "recv_slot", "b_gslot", "grecv_slot",
                  "w_mb", "w_cidx", "b_bnd", "w_bnd")
    }
    for sv in range(s_virt):
        d, c = sv % n, sv // n
        for mb in range(m):
            slot = act_assign[(sv, mb)]
            tables["f_mb"][fwd_tick[sv, mb], d] = mb
            tables["f_cidx"][fwd_tick[sv, mb], d] = c
            tables["f_slot"][fwd_tick[sv, mb], d] = slot
            tables["b_mb"][bwd_tick[sv, mb], d] = mb
            tables["b_cidx"][bwd_tick[sv, mb], d] = c
            tables["b_slot"][bwd_tick[sv, mb], d] = slot
            if sv > 0:
                tables["recv_slot"][fwd_tick[sv - 1, mb] + 1, d] = slot
            if sv < s_virt - 1:
                gs = grad_assign[(sv, mb)]
                tables["b_gslot"][bwd_tick[sv, mb], d] = gs
                tables["grecv_slot"][bwd_tick[sv + 1, mb] + 1, d] = gs
            if split:
                bs = bnd_assign[(sv, mb)]
                tables["b_bnd"][bwd_tick[sv, mb], d] = bs
                tables["w_mb"][w_tick[sv, mb], d] = mb
                tables["w_cidx"][w_tick[sv, mb], d] = c
                tables["w_bnd"][w_tick[sv, mb], d] = bs
    # Per-tick hop elision: a tick with no fwd op anywhere has nothing
    # riding the activation hop (every receive-table entry points at a
    # tick FOLLOWING a real op, so an elided hop's payload is never
    # read) — likewise the gradient hop on ticks with no bwd/bwd_input
    # op. Whole-tick properties, identical on every rank, so the
    # executor can skip the collective without a rank-divergent
    # branch. This is where the split schedule stops paying for its
    # longer tick timeline: zb's W-rich drain ticks ship nothing.
    ship_y = np.zeros((T,), np.int32)
    ship_g = np.zeros((T,), np.int32)
    for t, tick_ in enumerate(program.ticks):
        for op in tick_.compute:
            if op.kind == "fwd":
                ship_y[t] = 1
            elif op.kind in ("bwd", "bwd_input"):
                ship_g[t] = 1
    tables["ship_y"] = ship_y
    tables["ship_g"] = ship_g
    if op_code is not None:
        tables["op_code"] = op_code
    return LoweredProgram(
        program=program, forward_only=False, split=split,
        act_slots=act_slots, grad_slots=grad_slots,
        fwd_edges=tuple(fwd_edges), bwd_edges=tuple(bwd_edges),
        tables=tables, lowering=tick_lowering, op_table=op_table,
        bnd_slots=bnd_slots,
    )


# ------------------------------------------------------------ executor


def _tick_stamp(tick_times, my: int, tick: int, phase: int,
                dep: torch.Tensor) -> None:
    """One flight-recorder boundary stamp of rank ``my`` (the reference's
    ``_tick_stamp``): nothing when ``tick_times`` is None. ``dep`` is the
    tensor the bracketed work produced; its device decides the clock (a
    CUDA event on the rank's stream, or the host clock)."""
    if tick_times is not None:
        tick_times.record(my, tick, phase, dep)


def _tick_seed(tick_times, my: int, x_mb: torch.Tensor) -> None:
    """The seed stamp before the ticks: tick ``-1``, phase 1 — bounds
    tick 0's duration and delimits step rounds in the recorded stream."""
    _tick_stamp(tick_times, my, -1, 1, x_mb)


def _ship(y: torch.Tensor, line, edges, wave: bool, pp_chunks: int,
          transport: str, label: str = "pp_stage_ship") -> torch.Tensor:
    """The one stage-hop ship site: every hop goes through
    :func:`chunked_ppermute_compute` with the identity compute, so the
    wave (``pp_chunks`` token chunks along dim 1) and the peer-push
    transport are choices of this call; ``chunks=1`` over ``"xla"`` is
    the one-shot library hop."""
    from tpu_p2p_torch.parallel.collectives import chunked_ppermute_compute

    return chunked_ppermute_compute(
        lambda c, _i: c, y, line, edges, chunk_dim=1,
        chunks=(pp_chunks if wave else 1), transport=transport,
        label=label)


class _HostSum(torch.autograd.Function):
    """The sum over the line of ranks that share a card: the host group's
    all-reduce on a host copy (gloo never runs on card tensors, and those
    ranks have no NCCL group); the backward is the identity, as
    :func:`~tpu_p2p_torch.parallel.collectives.psum_join`'s."""

    @staticmethod
    def forward(ctx, x, line):
        import torch.distributed as dist

        y = x.detach().cpu()
        dist.all_reduce(y, group=line.host_group)
        return y.to(x.device)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _line_sum(x: torch.Tensor, line, label: str) -> torch.Tensor:
    """The replicating sum over the pp line (the loss, GPipe's recorded
    outputs): :func:`psum_join`, or :class:`_HostSum` on ranks that share
    a card, so the executor runs there over the peer-push transport.
    Ledger-recorded under ``label`` either way."""
    from tpu_p2p_torch.parallel.collectives import _record, psum_join

    if (line.size > 1 and x.is_cuda and not line.in_process
            and line.device_group is None):
        with _record("all_reduce", line, x, label=label):
            return _HostSum.apply(x, line)
    return psum_join(x, line, label=label)


class _Idle(torch.autograd.Function):
    """A rank's idle tick of a forward-only program under the switch
    lowering: zeros shaped like the tick's input, with no compute. The
    output stays in the autograd graph (through ``anchor``, a param
    leaf), so the rank's hop of that tick has a backward, which every
    rank must run in the same order (a hop's backward is a send and a
    receive with the neighbours)."""

    @staticmethod
    def forward(ctx, x, anchor):
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), None


def tick_forward_local(block_fn: Callable, params_local, x_mb: torch.Tensor,
                       lowered: LoweredProgram, line,
                       pp_overlap: str = "none", pp_chunks: int = 1,
                       transport: str = "xla",
                       tick_times=None) -> torch.Tensor:
    """Run a forward-only program on this rank's pp ``line``: ``x_mb
    [M, mb, ...]``, replicated over the line → the outputs, replicated.

    The tick arithmetic of :func:`~tpu_p2p_torch.models.pipeline.
    pipeline_apply_local` (feed gate, block, last-stage record, the
    replicating join), with the feed and record indices read from the
    lowered tables, so the values are bitwise that loop's. The masks are
    tensor ops and autograd owns the backward. Under the switch lowering
    an idle rank's tick is :class:`_Idle` instead of the block: its
    output is zeros, as the masked block's is on the zeros of a bubble,
    so values and gradients are the masked run's. The last tick's hop
    feeds no one and is not shipped. ``tick_times``: the flight
    recorder (module docstring)."""
    from tpu_p2p_torch.parallel.collectives import psum_conjugate

    n, my = line.size, line.index
    wave = pp_overlap == "wave" and pp_chunks > 1 and n > 1
    switch = lowered.lowering == "switch"
    tables = lowered.tables
    feed_mb, out_mb = tables["feed_mb"], tables["out_mb"]
    T = len(feed_mb)
    x_mb = psum_conjugate(x_mb, line)
    first = torch.tensor(my == 0, device=x_mb.device)
    last = torch.tensor(my == n - 1, device=x_mb.device)
    zero = torch.zeros_like(x_mb[0])
    anchor = next((p for p in params_local.values() if p.requires_grad),
                  zero)
    prev_in = zero
    outs: List[Optional[torch.Tensor]] = [None] * x_mb.shape[0]
    body = _ledger.ScanBody()  # the tick scan: its ship records once
    _tick_seed(tick_times, my, x_mb)
    for t in range(T):
        f = int(feed_mb[t])
        x_in = torch.where(first, x_mb[f] if f >= 0 else zero, prev_in)
        if switch and int(tables["op_code"][t, my]) == 0:
            y = _Idle.apply(x_in, anchor)
        else:
            y = block_fn(params_local, x_in)
        rec = int(out_mb[t])
        if rec >= 0:
            outs[rec] = torch.where(last, y, zero)
        _tick_stamp(tick_times, my, t, 0, y)
        if n > 1 and t < T - 1:
            with body.site("ship"):
                prev_in = _ship(y, line, lowered.fwd_edges, wave,
                                pp_chunks, transport)
        _tick_stamp(tick_times, my, t, 1, prev_in)
    return _line_sum(torch.stack(outs), line, "pp_output_replicate")


def _clip(i: int, hi: int) -> int:
    return min(max(int(i), 0), hi)


def tick_grads_local(block_fn: Callable, loss_grad_fn: Callable,
                     params_local: Dict[str, torch.Tensor],
                     x_mb: torch.Tensor, target_mb: torch.Tensor,
                     lowered: LoweredProgram, line, chunk_rows: int = 1,
                     pp_overlap: str = "none", pp_chunks: int = 1,
                     transport: str = "xla", tick_times=None):
    """Run a program with backward ticks on this rank's pp ``line`` →
    ``(loss summed over the line, {leaf: float32 gradient})``, the
    gradients this rank's rows' own (no reduction over any other axis).

    ``params_local`` leaves hold this rank's ``[v·chunk_rows, ...]``
    rows in device-major chunk order; ``block_fn(chunk, x)`` applies one
    virtual stage from its ``[chunk_rows, ...]`` rows. Per tick:

    - the arrivals of the last tick's hops go into their stash slots
      (``recv_slot``, ``grecv_slot``);
    - ``bwd`` / ``bwd_input``: the stage forward is rematerialized from
      the stashed input under ``torch.enable_grad()``, the loss gradient
      taken at the last virtual stage, and ``torch.autograd.grad`` run on
      that tick's graph for dx and the leaves the store does not cover;
      the store's records are accumulated at once (``bwd``) or parked in
      the boundary slot ``b_bnd`` (``bwd_input``);
    - ``bwd_weight``: the records of slot ``w_bnd`` replayed and
      accumulated;
    - ``fwd``: the stage forward under ``no_grad``, its input stashed;
    - the hops: the activation over the forward edges and dx over the
      backward edges, each elided on a tick whose ``ship_y`` /
      ``ship_g`` says nothing rides it (the same on every rank).

    Each stage's float32 accumulators take its gradients in microbatch
    order under both lowerings and both backward forms. The reference's
    ``vma_axes`` / ``dparam_vma`` type its carries for ``shard_map`` and
    have no torch counterpart. ``tick_times``: the flight recorder
    (module docstring)."""
    from tpu_p2p_torch.models.zb_split import WeightGradStore, leaf_grads, \
        scope

    prog = lowered.program
    n, my = line.size, line.index
    v, m = prog.chunks, prog.microbatches
    wave = pp_overlap == "wave" and pp_chunks > 1 and n > 1
    split, switch = lowered.split, lowered.lowering == "switch"
    tb = lowered.tables
    dev = x_mb.device
    zero_mb = torch.zeros(x_mb.shape[1:], dtype=x_mb.dtype, device=dev)
    zero_g = torch.zeros(x_mb.shape[1:], dtype=torch.float32, device=dev)
    x_stash = [zero_mb] * lowered.act_slots
    g_stash = [zero_g] * lowered.grad_slots
    bnd_stash: List[Optional[list]] = [None] * lowered.bnd_slots
    dparams = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params_local.items()}
    dtypes = {k: p.dtype for k, p in params_local.items()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    store = WeightGradStore()
    flag = {True: torch.tensor(True, device=dev),
            False: torch.tensor(False, device=dev)}

    def pick(name: str, t: int) -> int:
        return int(tb[name][t, my])

    def chunk_of(cidx: int):
        start = _clip(cidx, v - 1) * chunk_rows
        return {k: p[start:start + chunk_rows]
                for k, p in params_local.items()}, start

    def accum(acc: torch.Tensor, lo: int, rows: int, dc: torch.Tensor,
              on: bool) -> None:
        """The one gradient accumulate: rows ``lo:lo+rows`` of ``acc``
        plus ``dc`` in float32; masked, a rank whose op is off keeps the
        rows' bits (``torch.where``, not an added zero)."""
        cur = acc[lo:lo + rows]
        new = cur + dc.float().reshape(cur.shape)
        acc[lo:lo + rows] = new if switch else \
            torch.where(flag[on], new, cur)

    def accum_records(records, start: int, on: bool) -> None:
        for (k, row), dw in leaf_grads(records, dtypes).items():
            accum(dparams[k], start + row, 1, dw, on)

    def backward(t: int, mode: str):
        """The ``bwd`` (mode ``"fused"``: the store's records replayed at
        once) or ``bwd_input`` (``"split"``: parked in the boundary slot)
        body → dx in float32."""
        nonlocal loss_acc
        b_mb, b_cidx = pick("b_mb", t), pick("b_cidx", t)
        on = b_mb >= 0
        x_saved = x_stash[_clip(pick("b_slot", t), lowered.act_slots - 1)]
        chunk, start = chunk_of(b_cidx)
        tgt = target_mb[_clip(b_mb, m - 1)]
        g_mid = g_stash[_clip(pick("b_gslot", t), lowered.grad_slots - 1)]
        is_last = my == n - 1 and b_cidx == v - 1
        leaves = {k: c.detach().requires_grad_(True)
                  for k, c in chunk.items()}
        xs = x_saved.detach().requires_grad_(True)
        with torch.enable_grad(), scope(store):
            y_re = block_fn(leaves, xs)
            loss_mb, g_loss = loss_grad_fn(y_re.detach(), tgt)
            g_in = g_loss if is_last else g_mid
            grads = torch.autograd.grad(
                y_re, [xs, *leaves.values()],
                grad_outputs=g_in.to(y_re.dtype), allow_unused=True)
        records = store.take()
        dx = grads[0] if grads[0] is not None else zero_mb
        for k, g in zip(leaves, grads[1:]):
            if g is not None:
                accum(dparams[k], start, chunk_rows, g, on)
        if mode == "fused":
            accum_records(records, start, on)
        elif on:
            bnd_stash[_clip(pick("b_bnd", t), lowered.bnd_slots - 1)] = \
                records
        loss_acc = torch.where(flag[on and is_last],
                               loss_acc + loss_mb.float(), loss_acc)
        dx = dx.float()
        return dx if switch else torch.where(flag[on], dx, zero_g)

    def backward_weight(t: int) -> None:
        """The ``bwd_weight`` body: the records parked at this
        microbatch's ``bwd_input`` tick, replayed."""
        on = pick("w_mb", t) >= 0
        records = bnd_stash[_clip(pick("w_bnd", t), lowered.bnd_slots - 1)]
        if records:
            accum_records(records, _clip(pick("w_cidx", t), v - 1)
                          * chunk_rows, on)

    def forward(t: int) -> torch.Tensor:
        f_mb, f_cidx = pick("f_mb", t), pick("f_cidx", t)
        on = f_mb >= 0
        f_slot = _clip(pick("f_slot", t), lowered.act_slots - 1)
        x_in = x_mb[_clip(f_mb, m - 1)] if my == 0 and f_cidx == 0 \
            else x_stash[f_slot]
        if on:
            x_stash[f_slot] = x_in
        with torch.no_grad():
            y_f = block_fn(chunk_of(f_cidx)[0], x_in)
        return y_f if switch else torch.where(flag[on], y_f, zero_mb)

    y_recv, g_recv = zero_mb, zero_g
    body = _ledger.ScanBody()  # the tick scan: each ship records once
    _tick_seed(tick_times, my, x_mb)
    for t in range(prog.num_ticks):
        rs, gs = pick("recv_slot", t), pick("grecv_slot", t)
        if rs >= 0:
            x_stash[rs] = y_recv
        if gs >= 0:
            g_stash[gs] = g_recv
        y_f, dx = zero_mb, zero_g
        if switch:
            kind = lowered.op_table[int(tb["op_code"][t, my])]
            if kind == "fwd":
                y_f = forward(t)
            elif kind in ("bwd", "bwd_input"):
                dx = backward(t, "fused" if kind == "bwd" else "split")
            elif kind == "bwd_weight":
                backward_weight(t)
        else:
            dx = backward(t, "split" if split else "fused")
            if split:
                backward_weight(t)
            y_f = forward(t)
        _tick_stamp(tick_times, my, t, 0, y_f)
        if n > 1:
            y_recv, g_recv = y_f, dx
            if tb["ship_y"][t]:
                with body.site("fwd"):
                    y_recv = _ship(y_f, line, lowered.fwd_edges, wave,
                                   pp_chunks, transport, "pp_fwd_ship")
            if tb["ship_g"][t]:
                with body.site("bwd"):
                    g_recv = _ship(dx, line, lowered.bwd_edges, wave,
                                   pp_chunks, transport, "pp_bwd_ship")
        else:
            y_recv, g_recv = y_f, dx
        _tick_stamp(tick_times, my, t, 1, g_recv)
    return _line_sum(loss_acc, line, "pp_loss_replicate"), dparams


def make_tick_train_step(mesh, cfg, program: TickProgram,
                         block_fn: Optional[Callable] = None,
                         lr: float = 1e-2,
                         loss_grad_fn: Optional[Callable] = None,
                         pp_overlap: str = "none", pp_chunks: int = 1,
                         transport: str = "xla",
                         tick_lowering: str = "masked",
                         tick_times=None):
    """One SGD step for any tick program: ``(params, x, target) →
    (params, loss / x.numel())`` of this rank's rows, ``x`` and
    ``target`` the whole ``[B, ...]`` batch on every rank.

    ``cfg`` is a :class:`~tpu_p2p_torch.models.pipeline.PipelineConfig`;
    ``cfg.stages`` must equal ``program.devices * program.chunks`` and
    the mesh's ``pp`` axis ``program.devices`` (the reference's checks
    and messages). Forward-only programs differentiate through the ticks
    (the GPipe step's normalization and update); programs with backward
    ticks run :func:`tick_grads_local` (params for ``chunks > 1`` in the
    device-major layout, :func:`~tpu_p2p_torch.models.
    pipeline_interleaved.place_interleaved_params`). ``pp_overlap`` /
    ``pp_chunks`` / ``transport`` go to the one ship site;
    ``tick_lowering`` picks the lowering; ``tick_times`` (a
    :class:`~tpu_p2p_torch.obs.tickprof.TickRecorder`) records each
    rank's tick stamps."""
    from tpu_p2p_torch.models.flagship_steps import _sgd_update
    from tpu_p2p_torch.models.pipeline import _to_microbatches, mlp_block
    from tpu_p2p_torch.models.pipeline_1f1b import _mse_loss_grad

    block_fn = block_fn or mlp_block
    loss_grad_fn = loss_grad_fn or _mse_loss_grad
    if mesh is None or "pp" not in mesh.axis_names:
        raise ValueError("mesh needs a 'pp' axis for pipeline "
                         "parallelism")
    line = mesh.line("pp")
    if line.size != program.devices:
        raise ValueError(
            f"program compiled for {program.devices} devices; pp axis "
            f"has {line.size}"
        )
    if cfg.stages != program.devices * program.chunks:
        raise ValueError(
            f"cfg.stages ({cfg.stages}) != program devices x chunks "
            f"({program.devices} x {program.chunks})"
        )
    if cfg.microbatches != program.microbatches:
        raise ValueError(
            f"cfg.microbatches ({cfg.microbatches}) != program "
            f"microbatches ({program.microbatches})"
        )
    lowered = lower(program, tick_lowering=tick_lowering)
    m = cfg.microbatches

    def step(params, x, target):
        denom = float(np.prod(tuple(x.shape)))
        if lowered.forward_only:
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in params.items()}
            with torch.enable_grad():
                y = tick_forward_local(
                    block_fn, leaves, _to_microbatches(x, m), lowered,
                    line, pp_overlap=pp_overlap, pp_chunks=pp_chunks,
                    transport=transport, tick_times=tick_times)
                loss = torch.sum(
                    (y.float() - _to_microbatches(target, m).float()) ** 2)
                grads = dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))))
            loss = loss.detach()
        else:
            loss, grads = tick_grads_local(
                block_fn, loss_grad_fn, params, _to_microbatches(x, m),
                _to_microbatches(target, m), lowered, line,
                pp_overlap=pp_overlap, pp_chunks=pp_chunks,
                transport=transport, tick_times=tick_times)
        return _sgd_update(params, grads, lr, denom), loss / denom

    return _ledger.program(step)
