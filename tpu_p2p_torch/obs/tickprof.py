"""Tick-level flight recorder: measured per-(rank, tick) timelines
joined to the tick IR — the port of ``tpu_p2p/obs/tickprof.py``.

The schedule IR (:mod:`tpu_p2p_torch.models.schedule`) prices its
programs analytically — :func:`~tpu_p2p_torch.models.schedule.
per_rank_idle` says which rank SHOULD wait when; the recorder measures
each tick:

- **Boundary stamps.** :class:`TickRecorder` plugs into the executor's
  ``tick_times`` hook (off by default; nothing changes when off): each
  rank stamps a seed (tick ``-1``, which bounds tick 0 and delimits step
  rounds) and each tick twice — phase 0 after its compute, phase 1 after
  its hops. The executor runs eagerly, so a host clock read marks when a
  tick was *issued*, not when it ran. On a card each stamp is a CUDA
  event recorded on the rank's stream, turned into a time after the
  step's own synchronization (never a sync a tick: that would change
  what is measured), anchored at the seed's host clock read, taken on an
  idle stream (the previous step synchronized). So on a card busy =
  the tick's compute on the card, hop-wait = the hop's transfer and the
  wait for the peer, both on the card's clock. On the CPU (gloo, whose
  collectives block the host) the stamps are host ``perf_counter``
  reads at the same points, as the reference's are.
- **Spans and the measured bubble.** Per rank, tick ``t``'s busy time is
  ``stamp(t,0) - stamp(t-1,1)`` and its wait time ``stamp(t,1) -
  stamp(t,0)``: idle ranks block in the hop's rendezvous, so the
  analytic bubble shows up as hop-phase wait. ``sum(wait)/sum(busy +
  wait)`` is the measured per-rank bubble fraction, beside the analytic
  ``per_rank_idle`` fractions (the smoke grades that the ORDERINGS
  agree — levels differ because constant overhead pads every tick).
- **Per-tick-kind decomposition.** Global tick wall durations (max over
  ranks) regress against the IR's cost model — intercept + analytic tick
  cost (:data:`~tpu_p2p_torch.models.schedule.OP_COST` units) +
  EFFECTIVE hop count (post-elision, :func:`effective_hops`) — so the
  fit's intercept is the per-tick constant overhead in ms, next to
  per-kind mean tick costs (fwd / bwd / bwd_input / bwd_weight).
- **Device-trace join.** :func:`join_device_trace` reads the hop events
  of one profiled step (:func:`~tpu_p2p_torch.utils.profiling.
  labelled_collective_intervals`): each carries the ledger label of the
  ship site that issued it (``pp_fwd_ship``, ``pp_bwd_ship``,
  ``pp_stage_ship``), and the k-th event of a site lands on that site's
  k-th shipping tick, in issue order per step; a trace whose launches
  carry no label joins by issue order over the step's whole hop
  sequence — never a cyclic match over a pool shared with other
  collectives. Where there is no device track (the CPU) the report says
  so.

``python -m tpu_p2p_torch obs trace`` (:func:`trace_main`) runs the
recorder on a pure-pp world, renders the measured-vs-analytic bubble
table and the decomposition, exports the Chrome trace
(:mod:`tpu_p2p_torch.obs.trace`) and exits nonzero unless the ordering
matches, the export validates and the constant-overhead estimate is
positive.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_p2p_torch.config import TICK_LOWERINGS, TRACE_SCHEDULES

__all__ = ["TickRecorder", "TickSpan", "rounds_from_stamps",
           "spans_from_round", "measured_per_rank",
           "tick_wall_durations", "kind_decomposition",
           "effective_hops", "ship_slots", "ship_sequence",
           "tick_kind_map", "join_device_trace", "ordering_agreement",
           "idle_tick_agreement", "run_flight_recorder",
           "render_report", "trace_main"]

# The closing words of the report's constant-overhead line: the
# reference report's wording, which tests/golden/cli_obs_trace_8dev.txt
# pins.
_RESIDUAL_NOTE = ("the zb-vs-fused residual is ticks x this constant "
                  "(ROADMAP PR 17)")


class TickRecorder:
    """Collects ``(rank, tick, phase, seconds)`` stamps; the object the
    executor's ``tick_times`` hook calls back into (module docstring).

    :meth:`record` takes the tensor the bracketed work produced: a CUDA
    tensor's stamp is an event on its device's current stream, resolved
    to seconds by :meth:`resolve` once the stream has synchronized; any
    other stamp is a host ``perf_counter`` read at once. ``clock`` says
    which: ``"cuda_event"`` or ``"host"``."""

    def __init__(self) -> None:
        self.stamps: List[Tuple[int, int, int, float]] = []
        self._pending: list = []  # (rank, tick, phase, event, host_s)
        self.clock = "host"

    def record(self, rank, tick, phase, dep=None) -> None:
        import torch

        if isinstance(dep, torch.Tensor) and dep.is_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dep.device))
            host = time.perf_counter() if int(tick) == -1 else None
            self._pending.append((int(rank), int(tick), int(phase), ev,
                                  host))
            self.clock = "cuda_event"
            return
        self.stamps.append((int(rank), int(tick), int(phase),
                            time.perf_counter()))

    def resolve(self) -> None:
        """Turn the recorded events into seconds on the host clock: each
        event at its step's seed read plus its elapsed time after the
        seed event on the card. Call after the stream synchronized."""
        seed = None
        for rank, tick, phase, ev, host in self._pending:
            if tick == -1:
                seed = (ev, host)
                t = host
            elif seed is None:
                continue  # an event before any seed: no anchor
            else:
                t = seed[1] + seed[0].elapsed_time(ev) / 1e3
            self.stamps.append((rank, tick, phase, t))
        self._pending = []

    def clear(self) -> None:
        """Drop recorded stamps (call after warmup steps)."""
        self.stamps = []
        self._pending = []

    def __len__(self) -> int:
        return len(self.stamps) + len(self._pending)


@dataclass(frozen=True)
class TickSpan:
    """One rank's measured tick: ``[start, compute_end)`` is busy
    compute, ``[compute_end, end)`` is the hop span (ship + rendezvous
    wait — where the bubble shows)."""

    rank: int
    tick: int
    start: float
    compute_end: float
    end: float

    @property
    def busy_s(self) -> float:
        return self.compute_end - self.start

    @property
    def wait_s(self) -> float:
        return self.end - self.compute_end


def rounds_from_stamps(stamps) -> List[Dict[Tuple[int, int, int],
                                            float]]:
    """Split a recorder's stream into per-step rounds keyed
    ``(rank, tick, phase) -> t``. Each rank's stream is segmented at
    its seed stamps (tick ``-1`` — one per executed step); round
    ``r`` merges every rank's ``r``-th segment. Ranks interleave
    arbitrarily in the global stream; per-rank order is what the
    callback's data dependence guarantees."""
    per_rank: Dict[int, List[List[Tuple[int, int, float]]]] = {}
    for rank, tick, phase, t in stamps:
        segs = per_rank.setdefault(int(rank), [])
        if int(tick) == -1:
            segs.append([])
        if not segs:
            continue  # stamp before any seed (partial prior round)
        segs[-1].append((int(tick), int(phase), t))
    n_rounds = min((len(s) for s in per_rank.values()), default=0)
    rounds: List[Dict[Tuple[int, int, int], float]] = []
    for r in range(n_rounds):
        merged: Dict[Tuple[int, int, int], float] = {}
        for rank, segs in per_rank.items():
            for tick, phase, t in segs[r]:
                merged[(rank, tick, phase)] = t
        rounds.append(merged)
    return rounds


def spans_from_round(round_map: Dict[Tuple[int, int, int], float],
                     num_ticks: int) -> List[TickSpan]:
    """One round's stamps → per-(rank, tick) spans. Ticks missing
    either boundary are skipped (never invented)."""
    ranks = sorted({k[0] for k in round_map})
    out: List[TickSpan] = []
    for rank in ranks:
        for t in range(num_ticks):
            start = round_map.get((rank, t - 1, 1))
            mid = round_map.get((rank, t, 0))
            end = round_map.get((rank, t, 1))
            if start is None or mid is None or end is None:
                continue
            out.append(TickSpan(rank=rank, tick=t, start=start,
                                compute_end=mid, end=end))
    return out


def measured_per_rank(rounds_spans: Sequence[Sequence[TickSpan]]
                      ) -> List[dict]:
    """Aggregate spans over rounds → the measured twin of
    :func:`tpu_p2p_torch.models.schedule.per_rank_idle`: per device, total
    busy/wait seconds and ``bubble_frac = wait/(busy+wait)``."""
    busy: Dict[int, float] = {}
    wait: Dict[int, float] = {}
    for spans in rounds_spans:
        for s in spans:
            busy[s.rank] = busy.get(s.rank, 0.0) + s.busy_s
            wait[s.rank] = wait.get(s.rank, 0.0) + s.wait_s
    out = []
    for rank in sorted(busy):
        total = busy[rank] + wait[rank]
        out.append({
            "device": rank,
            "busy_s": busy[rank],
            "wait_s": wait[rank],
            "bubble_frac": (wait[rank] / total) if total > 0 else 0.0,
        })
    return out


def tick_wall_durations(rounds: Sequence[Dict[Tuple[int, int, int],
                                              float]],
                        num_ticks: int) -> np.ndarray:
    """Mean global wall duration per tick over rounds: tick ``t``
    spans from the latest rank's previous phase-1 stamp to the
    latest rank's own phase-1 stamp (monotonic by the per-rank stamp
    order, so durations are non-negative)."""
    acc = np.zeros(num_ticks)
    cnt = np.zeros(num_ticks)
    for rm in rounds:
        ranks = sorted({k[0] for k in rm})
        for t in range(num_ticks):
            prev = [rm.get((r, t - 1, 1)) for r in ranks]
            cur = [rm.get((r, t, 1)) for r in ranks]
            prev = [p for p in prev if p is not None]
            cur = [c for c in cur if c is not None]
            if not prev or not cur:
                continue
            acc[t] += max(cur) - max(prev)
            cnt[t] += 1
    with np.errstate(invalid="ignore"):
        mean = np.where(cnt > 0, acc / np.maximum(cnt, 1), np.nan)
    return mean


def tick_kind_map(program) -> Dict[Tuple[int, int], str]:
    """``(tick, rank) -> op kind`` for every compute op the program
    issues (the span labels the export renders). A rank issuing two
    ops in one tick keeps the costlier kind's label."""
    from tpu_p2p_torch.models.schedule import OP_COST

    out: Dict[Tuple[int, int], str] = {}
    for t, tick in enumerate(program.ticks):
        for op in tick.compute:
            prev = out.get((t, op.device))
            if prev is None or OP_COST[op.kind] > OP_COST[prev]:
                out[(t, op.device)] = op.kind
    return out


def effective_hops(tick) -> int:
    """Hops that actually SHIP this tick — the executor's per-tick
    elision rule replicated on the IR: ``lower()`` skips the
    activation hop on ticks where no rank runs a ``fwd`` op and the
    gradient hop where no rank runs ``bwd``/``bwd_input`` (the
    ship_y/ship_g tables of :mod:`tpu_p2p_torch.models.schedule` —
    zb's W-rich drain ticks ship nothing). The IR itself carries one static hop tuple
    on every tick, so this — not ``len(tick.hops)`` — is what the
    measured wall time paid for. A payload this rule does not know
    is counted as shipped (conservative for future hop kinds)."""
    kinds = {op.kind for op in tick.compute}
    ships = {"activation": "fwd" in kinds,
             "gradient": bool(kinds & {"bwd", "bwd_input"})}
    return sum(1 for h in tick.hops if ships.get(h.payload, True))


def kind_decomposition(durations_s: np.ndarray, program) -> dict:
    """Per-tick-kind cost decomposition of measured tick wall times.

    Group means: each tick's dominant kind (costliest op issued that
    tick under :data:`~tpu_p2p_torch.models.schedule.OP_COST`; ``noop``
    when nothing computes) → mean measured ms. Fit: least squares of
    ``duration ~ c0 + ms_per_cost_unit * analytic_cost +
    ms_per_hop * effective_hops`` — the intercept ``c0`` is the
    per-tick CONSTANT overhead (the tick's Python turn + dispatch +
    stash bookkeeping) the zb-vs-fused gap is attributed to (zb runs
    ~M·S more ticks; each pays ``c0``). The hop column counts
    post-elision shipping (:func:`effective_hops`): the raw IR hop tuple
    is identical on every tick, so it would be a constant the intercept
    absorbs; on a zb program effective counts run 0/1/2 and the two
    coefficients separate. ``hop_design_varies`` reports
    whether the fitted design had that variation — when False (a
    schedule whose every tick ships the same count, e.g. pure GPipe
    forward ramps) ``ms_per_hop`` is NOT identifiable and only the
    intercept+cost split is meaningful. When the fit cannot produce
    a positive intercept (degenerate design at tiny tick counts)
    the minimum observed tick duration — itself a hard lower bound
    on per-tick overhead — is reported instead, and
    ``intercept_from_fit`` says which one you are reading."""
    from tpu_p2p_torch.models.schedule import OP_COST

    ok = np.isfinite(durations_s)
    ticks = [i for i in range(len(durations_s)) if ok[i]
             and i < program.num_ticks]
    kinds = []
    cost = []
    hops = []
    for i in ticks:
        tick = program.ticks[i]
        ks = [op.kind for op in tick.compute]
        kinds.append(max(ks, key=lambda k: OP_COST[k]) if ks
                     else "noop")
        cost.append(max((OP_COST[k] for k in ks), default=0.0))
        hops.append(effective_hops(tick))
    by_kind: Dict[str, List[float]] = {}
    for i, k in zip(ticks, kinds):
        by_kind.setdefault(k, []).append(float(durations_s[i]) * 1e3)
    per_kind_ms = {k: {"mean_ms": float(np.mean(v)), "ticks": len(v)}
                   for k, v in sorted(by_kind.items())}
    out = {
        "per_kind_ms": per_kind_ms,
        "constant_overhead_ms": None,
        "ms_per_cost_unit": None,
        "ms_per_hop": None,
        "intercept_from_fit": False,
        "hop_design_varies": len(set(hops)) > 1,
        "ticks_fit": len(ticks),
    }
    if not ticks:
        return out
    y = np.array([float(durations_s[i]) * 1e3 for i in ticks])
    a = np.column_stack([np.ones(len(ticks)), np.array(cost),
                         np.array(hops)])
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    c0, c_cost, c_hop = (float(coef[0]), float(coef[1]),
                         float(coef[2]))
    if c0 > 0:
        out["constant_overhead_ms"] = c0
        out["intercept_from_fit"] = True
    else:
        # The minimum observed tick IS per-tick overhead plus the
        # cheapest tick's work — a conservative nonzero floor.
        out["constant_overhead_ms"] = float(np.min(y))
    out["ms_per_cost_unit"] = c_cost
    out["ms_per_hop"] = c_hop
    return out


# The executor's ship sites (ledger labels) → the hop payload each ships.
_SHIP_SITES = ("pp_stage_ship", "pp_fwd_ship", "pp_bwd_ship")


def ship_slots(program) -> Dict[str, List[int]]:
    """The ticks on which each of the executor's ship sites issues its
    hop, in tick order → ``{ledger label: [tick, ...]}``: a forward-only
    program (GPipe) ships its stage hop on every tick but the last, whose
    hop feeds no one; a program with backward ticks ships the activation
    hop (``pp_fwd_ship``) on the ticks where a rank runs ``fwd`` and the
    gradient hop (``pp_bwd_ship``) where one runs ``bwd`` /
    ``bwd_input`` (``lower()``'s ``ship_y`` / ``ship_g``). A program of
    one device ships nothing."""
    if program.devices < 2:
        return {}
    kinds = [{op.kind for op in tick.compute} for tick in program.ticks]
    if not any(k & {"bwd", "bwd_input", "bwd_weight"} for k in kinds):
        return {"pp_stage_ship": list(range(program.num_ticks - 1))}
    return {"pp_fwd_ship": [t for t, k in enumerate(kinds) if "fwd" in k],
            "pp_bwd_ship": [t for t, k in enumerate(kinds)
                            if k & {"bwd", "bwd_input"}]}


def ship_sequence(program) -> List[Tuple[int, str]]:
    """Every hop of one step in issue order → ``[(tick, site), ...]``:
    tick by tick, the activation hop before the gradient hop, as the
    executor issues them."""
    slots = ship_slots(program)
    return [(t, site) for t in range(program.num_ticks)
            for site in _SHIP_SITES if t in slots.get(site, ())]


def _site(labels) -> Optional[str]:
    """The ledger label (an issue range name's fourth field) of the
    innermost of ``labels`` that is one of the executor's ship sites,
    else of the innermost label; None without labels."""
    if isinstance(labels, str):
        labels = (labels,)
    sites = [str(lab).split("|")[3] for lab in labels or ()
             if len(str(lab).split("|")) > 3]
    ships = [s for s in sites if s in _SHIP_SITES]
    return (ships or sites or [None])[-1]


def join_device_trace(program, intervals) -> Tuple[List[dict],
                                                   List[tuple]]:
    """Match one rank's device-trace hop events to the program's shipping
    ticks. ``intervals``: :func:`~tpu_p2p_torch.utils.profiling.
    labelled_collective_intervals` rows ``(name, t0, t1, label)`` (None
    on platforms with no device track).

    A hop event (library send/recv or peer-push kind) whose label names
    one of the executor's ship sites lands, in time order, on that site's
    next shipping tick (:func:`ship_slots`); hop events without a label
    (a trace whose launches carry no issue marker) land in issue order on
    the step's whole hop sequence (:func:`ship_sequence`), and only when
    they number a whole multiple of it. Either way the match restarts
    each executed step, so a window of several steps replays the same
    ticks. Returns ``(joined, unattributed)``: joined rows carry the
    tick, the event, its span, its site, its kind and ``how`` (``"label"``
    or ``"order"``); every other event (other kinds, hops left over, a
    site with no shipping tick) is returned raw so the export can render
    it, never guessed onto a tick."""
    from tpu_p2p_torch.obs.ledger import kind_of_event

    if not intervals:
        return [], list(intervals or [])
    slots = ship_slots(program)
    seq = ship_sequence(program)
    seen: Dict[str, int] = {}
    joined: List[dict] = []
    other: List[tuple] = []
    bare: List[tuple] = []
    for iv in sorted(intervals, key=lambda e: e[1]):
        name, t0, t1 = iv[:3]
        kind = kind_of_event(name)
        if kind not in ("ppermute", "dma"):
            other.append((name, t0, t1))
            continue
        site = _site(iv[3] if len(iv) > 3 else None)
        ticks = slots.get(site)
        if site is None:
            bare.append((name, t0, t1, kind))
        elif ticks:
            k = seen.get(site, 0)
            seen[site] = k + 1
            joined.append({"tick": ticks[k % len(ticks)], "event": name,
                           "t0": t0, "t1": t1, "site": site,
                           "kind": kind, "how": "label"})
        else:
            other.append((name, t0, t1))
    if bare and seq and len(bare) % len(seq) == 0:
        for k, (name, t0, t1, kind) in enumerate(bare):
            tick, site = seq[k % len(seq)]
            joined.append({"tick": tick, "event": name, "t0": t0,
                           "t1": t1, "site": site, "kind": kind,
                           "how": "order"})
    else:
        other.extend(e[:3] for e in bare)
    joined.sort(key=lambda j: j["t0"])
    return joined, other


def ordering_agreement(analytic: Sequence[dict],
                       measured: Sequence[dict],
                       eps: float = 0.05) -> dict:
    """Pairwise ordering check, measured vs analytic per-rank bubble:
    for every rank pair whose ANALYTIC bubble fractions differ by at
    least ``eps`` (pairs the cost model claims are distinguishable),
    the measured fractions must order the same way. Ties and
    sub-``eps`` pairs are not graded — constant overhead compresses
    levels, and noise must not flunk ranks the model itself calls
    equal."""
    a = {r["device"]: r["bubble_frac"] for r in analytic}
    m = {r["device"]: r["bubble_frac"] for r in measured}
    ranks = sorted(set(a) & set(m))
    checked = agree = 0
    disagreements = []
    for i, ri in enumerate(ranks):
        for rj in ranks[i + 1:]:
            da = a[ri] - a[rj]
            if abs(da) < eps:
                continue
            checked += 1
            dm = m[ri] - m[rj]
            if da * dm > 0:
                agree += 1
            else:
                disagreements.append((ri, rj))
    return {"checked": checked, "agree": agree,
            "ok": agree == checked,
            "disagreements": disagreements, "eps": eps}


def idle_tick_agreement(analytic: Sequence[dict],
                        rounds_spans: Sequence[Sequence[TickSpan]]
                        ) -> dict:
    """The within-rank bubble ordering: every compiled schedule gives
    each rank the SAME total work (per-rank bubble fractions are
    uniform by construction), so the analytic claim with per-rank
    content is WHERE the idle sits — ``per_rank_idle``'s
    ``idle_spans``. Grades, per rank, that the mean measured compute
    time over analytically-idle ticks is LOWER than over active
    ticks: under the switch lowering idle ticks pay only the branch
    select + stash bookkeeping, so this is exactly the
    cost-proportional-execution claim made measurable (it is
    EXPECTED to fail under the masked lowering, where idle ticks run
    the full masked body).

    Two noise defences, both forced by timeshared hosts where a rank's
    busy segment absorbs scheduler skew:

    * per (rank, tick) the statistic is the MIN over rounds — the
      true cost is a lower envelope, and scheduling noise is purely
      additive, so min-over-rounds converges on it;
    * a rank is only GRADED when its active ticks cost at least
      ``FLOOR_FACTOR`` x the global per-tick timer floor (the
      cheapest cell anywhere).  Below that, the model's compute sits
      beneath the host-callback floor and idle vs active is
      unmeasurable — those ranks are listed in ``ungraded`` with the
      reason, never silently passed or failed.

    The grade itself is a TWO-THIRDS QUORUM over the graded ranks
    (``ok`` when at most one third of them fail), not unanimity:
    scheduler noise on a timeshared box is LOCAL — it inflates one or
    two ranks' busy segments across every round, defeating
    min-over-rounds for just those ranks — while a genuine
    cost-proportionality regression (a masked-like lowering where idle
    ticks run the full body) is GLOBAL and flunks every graded rank.
    Failing ranks are always listed in ``failures`` even when the
    quorum passes."""
    busy: Dict[Tuple[int, int], List[float]] = {}
    for spans in rounds_spans:
        for s in spans:
            busy.setdefault((s.rank, s.tick), []).append(s.busy_s)
    if not busy:
        return {"ranks_checked": 0, "ranks_ok": 0, "ok": True,
                "failures": [], "ungraded": [], "floor_ms": 0.0,
                "ungraded_reason": "no tick spans recorded",
                "detail": {}}
    FLOOR_FACTOR = 2.0
    cell_ms = {k: float(np.min(v)) * 1e3 for k, v in busy.items()}
    floor_ms = min(cell_ms.values())
    ranks_checked = ranks_ok = 0
    failures = []
    ungraded = []
    detail = {}
    for r in analytic:
        rank = r["device"]
        idle = {t for a, b in r["idle_spans"] for t in range(a, b)}
        ticks = sorted({t for (rk, t) in cell_ms if rk == rank})
        idle_ms = [cell_ms[(rank, t)] for t in ticks if t in idle]
        act_ms = [cell_ms[(rank, t)] for t in ticks if t not in idle]
        if not idle_ms or not act_ms:
            continue
        mi, ma = float(np.mean(idle_ms)), float(np.mean(act_ms))
        graded = ma >= FLOOR_FACTOR * floor_ms
        detail[rank] = {"idle_tick_ms": mi, "active_tick_ms": ma,
                        "graded": graded}
        if not graded:
            ungraded.append(rank)
            continue
        ranks_checked += 1
        if mi < ma:
            ranks_ok += 1
        else:
            failures.append(rank)
    out = {"ranks_checked": ranks_checked, "ranks_ok": ranks_ok,
           "ok": len(failures) * 3 <= ranks_checked,
           "failures": failures, "ungraded": ungraded,
           "floor_ms": floor_ms, "detail": detail}
    if ranks_checked == 0:
        out["ungraded_reason"] = (
            "active-tick cost sits beneath %.1fx the host-timer floor "
            "(%.3f ms) — compute too small to separate idle from "
            "active ticks; raise --d-model/--d-ff to grade this check"
            % (FLOOR_FACTOR, floor_ms))
    return out


# ------------------------------------------------------------- runner


def _compile(schedule: str, microbatches: int, devices: int):
    from tpu_p2p_torch.models import schedule as SCH

    if schedule == "zb":
        return SCH.compile_zb(microbatches, devices)
    if schedule == "1f1b":
        return SCH.compile_1f1b(microbatches, devices)
    if schedule == "gpipe":
        return SCH.compile_gpipe(microbatches, devices)
    raise ValueError(f"unknown schedule {schedule!r}; expected one "
                     f"of {TRACE_SCHEDULES}")


def _device_join(prog, step, rt, device_trace: bool) -> dict:
    """One step profiled on every rank (each its own window, the step
    between two barriers of the mesh inside it), its hop
    events joined to the shipping ticks (:func:`join_device_trace`) →
    the first rank's view of every rank's join."""
    import tempfile

    from tpu_p2p_torch.obs import ledger as L
    from tpu_p2p_torch.utils.profiling import (
        labelled_collective_intervals,
        profile_window,
    )

    if not device_trace:
        return {"device_track": False, "joined": [], "unattributed": [],
                "reason": "device trace not sampled"}
    with tempfile.TemporaryDirectory(prefix="tickprof_") as td:
        with L.recording():  # the issue labels of the step's hops
            path = profile_window(step, td, host=True,
                                  barrier=rt.mesh.barrier)
        intervals = labelled_collective_intervals(path)
    mine = None
    if intervals is not None:
        joined, other = join_device_trace(prog, intervals)
        mine = ([dict(j, rank=rt.mesh.index) for j in joined], other)
    every = rt.gather(mine)
    if all(m is None for m in every):
        return {"device_track": False, "joined": [], "unattributed": [],
                "reason": "no device track in trace (platform records "
                          "host events only)"}
    joined = [j for m in every if m for j in m[0]]
    per_rank = {r: len(m[0]) for r, m in enumerate(every) if m}
    return {"device_track": True,
            "joined": sorted(joined, key=lambda j: j["t0"]),
            "unattributed": [e for m in every if m for e in m[1]],
            "events_per_rank": per_rank,
            "hop_slots": sum(len(v) for v in ship_slots(prog).values()),
            "reason": None}


def run_flight_recorder(rt, *, schedule: str = "zb",
                        tick_lowering: str = "switch",
                        microbatches: int = 4, steps: int = 3,
                        d_model: int = 32, d_ff: int = 64,
                        seed: int = 0, device_trace: bool = True
                        ) -> Optional[dict]:
    """Run the recorder end to end on the world of runtime ``rt`` (every
    rank calls it; the pp line is the whole world, a rank a stage):
    compile ``schedule`` at M=``microbatches`` S=world, run one warmup
    step (its stamps are cleared; ranks that share a card first run one
    more over host-staged hops), then ``steps`` measured steps, each
    followed by the rank's synchronization, and reduce every rank's
    stamps (gathered to the first rank) to the measured-vs-analytic
    report. ``device_trace=True`` also profiles one more step on every
    rank and joins its hop events to the shipping ticks (explicitly n/a
    without a device track, as on the CPU). The stage hops go over the
    peer-push transport where the ranks share a card (which has no
    NCCL), else over the library's. → the report on the first rank,
    None on the others."""
    import torch

    from tpu_p2p_torch.models import schedule as SCH
    from tpu_p2p_torch.models.pipeline import (
        PipelineConfig,
        init_pipeline_params,
        place_pipeline_params,
    )
    from tpu_p2p_torch.parallel import collectives as C

    n = rt.world
    mesh = rt.axis_mesh((n,), ("pp",))
    dev = mesh.device
    shared = dev.type == "cuda" and mesh.device_group is None and n > 1
    transport = "pallas_dma" if shared else "xla"
    prog = _compile(schedule, microbatches, n)
    cfg = PipelineConfig(d_model=d_model, d_ff=d_ff, stages=n,
                         microbatches=microbatches)
    params = place_pipeline_params(init_pipeline_params(cfg, seed=seed),
                                   mesh)
    rng = np.random.default_rng(seed + 1)
    b, t = 2 * microbatches, 8
    x = torch.from_numpy(np.asarray(rng.standard_normal((b, t, d_model)),
                                    np.float32)).to(dev)
    target = torch.from_numpy(np.asarray(
        rng.standard_normal((b, t, d_model)), np.float32)).to(dev)
    rec = TickRecorder()
    step_fn = SCH.make_tick_train_step(
        mesh, cfg, prog, tick_lowering=tick_lowering, tick_times=rec,
        transport=transport)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if shared:
        # A peer-push hop spins a bounded time for its peer, and a rank's
        # first step also makes its cuBLAS handles and loads its kernels
        # while the other ranks' spinning kernels hold the card: the stage
        # compute warms first over host-staged hops, which wait on the
        # host (its updated params are dropped).
        warm = SCH.make_tick_train_step(mesh, cfg, prog,
                                        tick_lowering=tick_lowering,
                                        transport="xla")
        with C.host_staged(True):
            warm({k: v.clone() for k, v in params.items()}, x, target)
        sync()
    # The ranks enter the first step together: drawing the stage params
    # takes each rank a different while.
    rt.barrier()
    params, loss = step_fn(params, x, target)  # warmup: kernels, groups
    sync()
    rec.clear()
    for _ in range(max(steps, 1)):
        params, loss = step_fn(params, x, target)
        sync()
    rec.resolve()
    clock = rec.clock
    stamps = [s for part in rt.gather(rec.stamps) for s in part]
    dj = _device_join(prog, lambda: step_fn(params, x, target), rt,
                      device_trace)
    if rt.rank != 0:
        return None
    rounds = rounds_from_stamps(stamps)
    rounds_spans = [spans_from_round(r, prog.num_ticks)
                    for r in rounds]
    measured = measured_per_rank(rounds_spans)
    analytic = SCH.per_rank_idle(prog)
    durations = tick_wall_durations(rounds, prog.num_ticks)
    report = {
        "schedule": schedule,
        "lowering": tick_lowering,
        "devices": n,
        "microbatches": microbatches,
        "num_ticks": prog.num_ticks,
        "steps_measured": len(rounds),
        "analytic": analytic,
        "measured": measured,
        "ordering": ordering_agreement(analytic, measured),
        "idle_ordering": idle_tick_agreement(analytic, rounds_spans),
        "decomposition": kind_decomposition(durations, prog),
        "loss": float(loss),
        "stamp_clock": clock,
        "transport": transport,
    }
    kind_of = tick_kind_map(prog)
    report["spans"] = [{
        "rank": s.rank, "tick": s.tick, "start": s.start,
        "compute_end": s.compute_end, "end": s.end,
        "kind": kind_of.get((s.tick, s.rank), "idle"),
    } for s in (rounds_spans[-1] if rounds_spans else [])]
    report["device_join"] = dj
    return report


# ------------------------------------------------------------ the CLI


def render_report(report: dict, stream=None) -> None:
    """The ``obs trace`` table: measured-vs-analytic bubble per rank,
    the ordering verdict, and the per-tick-kind decomposition."""
    out = stream if stream is not None else sys.stdout
    out.write(
        f"# tick flight recorder: {report['schedule']} program @ "
        f"M={report['microbatches']} S={report['devices']} "
        f"({report['lowering']} lowering), "
        f"{report['steps_measured']} measured step(s), "
        f"{report['num_ticks']} ticks\n")
    if report.get("stamp_clock") == "cuda_event":
        out.write("# stamps: CUDA events on each rank's stream — busy ms "
                  "is the ticks' compute on the card, hop-wait ms the "
                  "hops' transfer and peer wait, both on the card's "
                  "clock\n")
    a = {r["device"]: r for r in report["analytic"]}
    out.write("# rank | analytic bubble | measured bubble | busy ms "
              "| hop-wait ms\n")
    for r in report["measured"]:
        ar = a.get(r["device"], {})
        out.write(
            f"# {r['device']:>4} | {ar.get('bubble_frac', 0.0):>15.2f}"
            f" | {r['bubble_frac']:>15.2f} | {r['busy_s'] * 1e3:>7.1f}"
            f" | {r['wait_s'] * 1e3:>11.1f}\n")
    o = report["ordering"]
    out.write(
        f"# ordering: measured agrees with analytic on {o['agree']} "
        f"of {o['checked']} graded rank pairs "
        f"(analytic gap >= {o['eps']})"
        + ("\n" if o["ok"] else
           f" — DISAGREES on {o['disagreements']}\n"))
    io = report["idle_ordering"]
    out.write(
        f"# idle placement: {io['ranks_ok']} of "
        f"{io['ranks_checked']} graded rank(s) measure their "
        "analytically-idle ticks cheaper than their active ticks"
        + ("" if not io["failures"] else
           f" — ranks {io['failures']} do not"
           + (" (within the 2/3 quorum)" if io["ok"] else ""))
        + (f"; {len(io['ungraded'])} rank(s) ungraded (beneath "
           f"timer floor {io['floor_ms']:.3f} ms)"
           if io.get("ungraded") else "")
        + "\n")
    if io.get("ungraded_reason"):
        out.write(f"#   idle placement not graded: "
                  f"{io['ungraded_reason']}\n")
    d = report["decomposition"]
    for kind, row in d["per_kind_ms"].items():
        out.write(f"#   {kind:<10} ticks mean "
                  f"{row['mean_ms']:.3f} ms over {row['ticks']} "
                  "tick(s)\n")
    src = ("fit intercept" if d["intercept_from_fit"]
           else "min-tick floor")
    if d["constant_overhead_ms"] is not None:
        out.write(
            f"# constant overhead: {d['constant_overhead_ms']:.3f} "
            f"ms/tick ({src}); marginal "
            f"{d['ms_per_cost_unit']:.3f} ms per cost unit, "
            f"{d['ms_per_hop']:.3f} ms per effective hop"
            + ("" if d.get("hop_design_varies")
               else " (COLLINEAR: every tick ships the same count;"
                    " per-hop not identifiable)")
            + f" — {_RESIDUAL_NOTE}\n")
    dj = report["device_join"]
    if dj["device_track"]:
        out.write(f"# device-trace join: {len(dj['joined'])} hop "
                  f"event(s) onto shipping ticks, "
                  f"{len(dj['unattributed'])} unattributed\n")
    else:
        out.write(f"# device-trace join: n/a ({dj['reason']})\n")
    out.flush()


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_p2p_torch obs trace",
        description="Tick flight recorder: measured per-(rank, tick) "
                    "spans vs the analytic schedule bubble, per-tick "
                    "cost decomposition, Chrome-trace export.",
    )
    p.add_argument("--schedule", default="zb", choices=TRACE_SCHEDULES)
    p.add_argument("--tick-lowering", default="switch",
                   choices=TICK_LOWERINGS)
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--steps", type=int, default=3,
                   help="measured steps (after one cleared warmup)")
    p.add_argument("--d-model", type=int, default=256,
                   help="model width; the default is big enough that "
                        "per-tick compute clears the host-timer "
                        "floor, so the idle-placement check grades")
    p.add_argument("--d-ff", type=int, default=1024)
    p.add_argument("--out", default=None, metavar="PATH",
                   help="Chrome-trace JSON path (default: a temp "
                        "file, validated then removed)")
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="spawn N CPU ranks (gloo)")
    p.add_argument("--device", default=None,
                   help="each rank's device (default: a card a rank; "
                        "cuda:0 puts every rank of a launched world on "
                        "one card)")
    return p


def _grade(args, report: dict) -> int:
    """The first rank's render, export and verdict → the exit code."""
    render_report(report)
    from tpu_p2p_torch.obs.trace import (
        validate_chrome_trace,
        write_chrome_trace,
    )

    keep = args.out is not None
    if keep:
        out_path = args.out
    else:
        import tempfile

        fd = tempfile.NamedTemporaryFile(
            suffix=".trace.json", prefix="tickprof_", delete=False)
        out_path = fd.name
        fd.close()
    dj = report["device_join"]
    link_events = [{"name": j["event"], "t0": j["t0"], "t1": j["t1"],
                    "tick": j["tick"], "kind": j["kind"],
                    "label": j["site"]}
                   for j in dj["joined"]]
    obj = write_chrome_trace(
        out_path, tick_spans=report["spans"], link_events=link_events,
        unattributed=dj["unattributed"],
        meta={"schedule": report["schedule"],
              "lowering": report["lowering"],
              "devices": report["devices"]})
    problems = validate_chrome_trace(obj)
    n_events = len(obj["traceEvents"])
    rc = 0
    if problems:
        print(f"FAIL: export schema: {problems[:3]}")
        rc = 1
    if not report["ordering"]["ok"]:
        print("FAIL: measured per-rank bubble ordering "
              "disagrees with the analytic per_rank_idle "
              f"ordering on {report['ordering']['disagreements']}")
        rc = 1
    if (args.tick_lowering == "switch"
            and not report["idle_ordering"]["ok"]):
        # The masked lowering is exempt by design: its idle ticks run
        # the full masked body, so idle placement is only measurable
        # under the cost-proportional switch dispatch.
        print("FAIL: analytically-idle ticks do not measure "
              "cheaper than active ticks on ranks "
              f"{report['idle_ordering']['failures']} (beyond "
              "the 2/3 quorum) — the switch lowering's "
              "cost-proportional claim")
        rc = 1
    c0 = report["decomposition"]["constant_overhead_ms"]
    if not c0 or c0 <= 0:
        print("FAIL: per-tick constant-overhead estimate is not "
              "positive — the decomposition found no residual")
        rc = 1
    if keep:
        print(f"# wrote chrome trace {out_path} ({n_events} events, "
              + ("validated" if not problems else "INVALID") + ")")
    else:
        os.unlink(out_path)
        print(f"# chrome trace export: {n_events} events, "
              + ("validated" if not problems else "INVALID")
              + " (pass --out PATH to keep)")
    print("# trace smoke: " + ("PASS" if rc == 0 else "FAIL"),
          flush=True)
    return rc


def trace_main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m tpu_p2p_torch obs trace`` — the graded smoke: exit
    nonzero unless the measured per-rank bubble ordering matches the
    analytic ordering, the export schema-validates, and the
    constant-overhead estimate is positive. ``--cpu-mesh N`` spawns the
    world; the first rank prints, every rank exits with its verdict."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _build_parser().parse_args(argv)
    if args.cpu_mesh and "RANK" not in os.environ:
        from tpu_p2p_torch.parallel.launch import spawn

        return max(spawn(args.cpu_mesh, ["-m", "tpu_p2p_torch", "obs",
                                         "trace", *argv]))
    from tpu_p2p_torch.utils.errors import fail_fast

    try:
        from tpu_p2p_torch.parallel.runtime import make_runtime

        rt = make_runtime(device="cpu" if args.cpu_mesh else args.device)
        report = run_flight_recorder(
            rt, schedule=args.schedule, tick_lowering=args.tick_lowering,
            microbatches=args.microbatches, steps=args.steps,
            d_model=args.d_model, d_ff=args.d_ff)
        rc = _grade(args, report) if report is not None else 0
        rc = rt.broadcast(rc, 0)
        rt.close()
        return rc
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 — the one fail-fast exit
        return fail_fast(e)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(trace_main())
