"""Device-clock timing — the port's copy of the timing half of
``tpu_p2p/utils/profiling.py``.

The reference reads a chain's device time off XLA's device track: the
top-level program spans of a ``jax.profiler`` trace. A chain here is not
one program but ``k`` eagerly issued calls, so its span on the card
includes every gap where the card waited for the host to issue the next
call: CUDA events around the chain measure the host's issue rate
wherever the host is the slower of the two (small messages, NCCL's
launch cost). What the card itself spent is its busy time: the union of
the intervals of the kernels, copies and fills that the chain's calls
put on the card, as CUPTI stamps them on the card's clock. This module
captures the two chains under ``torch.profiler`` (each run inside a
``record_function`` range), maps every device event to the range whose
launch produced it (the runtime call's ``correlation`` id), and takes
the slope of the busy time between the two chain lengths: the same
constant-cost cancellation as the host differential, on the card's
clock.

- :func:`chain_busy_times` / :func:`differential_from_kernels` — the
  trace reading (the reference's ``differential_from_trace`` :617);
- :func:`capture_device_slope` — the capture;
- :class:`TimingValidation` / :func:`validate_differential` — the
  ``--validate-timing`` cross-check (reference :701, :745);
- :class:`HeadlineMeasurement` / :func:`measure_headline` — ``--mode
  device`` (reference :866, :947), with the reference's re-measure and
  capture choice kept as they are; its multi-rank decisions go through
  the mesh's host group (gloo), never a device collective.

Where no device track exists (a CPU world) the published value is the
host slope, labelled ``host_differential`` and unjudged, as in the
reference. On a card a failed device read is an error: the note says
why, the verdict is False, and the host slope is not published in its
place.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from tpu_p2p_torch.utils import timing as timing_mod
from tpu_p2p_torch.utils.errors import TransferTimeout

# On the H100 host, torch.profiler loses device events near the edges of
# a recorded window, and more the older the process: a few minutes in,
# every kernel of a 60 ms window can go missing, while a host pause of
# half a second on either side keeps them (PERF.md § 7). A recorded
# window on a card starts and ends with one.
WINDOW_PAD_S = 0.5

CHAIN_TAG = "tp_p2p_chain"   # record_function name prefix of a chain run
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _union_seconds(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of ``[start, end)`` spans (microseconds in,
    seconds out)."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


def chain_busy_times(events: list, tag: str = CHAIN_TAG
                     ) -> Dict[str, Tuple[float, int]]:
    """For each ``record_function`` range named ``tag...`` in a Chrome
    trace's ``traceEvents``: (seconds the card was busy with what the
    range launched, number of device events). A device event belongs to
    the range whose host thread issued its runtime call inside the
    range."""
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith(tag)]
    owner = {}
    for e in events:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        for r in ranges:
            if (r["pid"], r["tid"]) == (e["pid"], e["tid"]) and \
                    r["ts"] <= e["ts"] <= r["ts"] + r["dur"]:
                owner[corr] = r["name"]
                break
    spans = defaultdict(list)
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            name = owner.get(e.get("args", {}).get("correlation"))
            if name is not None:
                spans[name].append((e["ts"], e["ts"] + e["dur"]))
    return {r["name"]: (_union_seconds(spans[r["name"]]),
                        len(spans[r["name"]])) for r in ranges}


def has_device_track(events: list) -> bool:
    """Whether the trace holds any event on the card's timeline."""
    return any(e.get("cat") in DEVICE_CATS for e in events)


def differential_from_kernels(events: list, n_short: int, n_long: int,
                              runs: int) -> float:
    """Device per-op slope from a trace of ``runs`` alternating (short,
    long) chain runs named ``{CHAIN_TAG}:{n}:{j}``: mean(busy_long -
    busy_short) / (n_long - n_short), over the runs of each length that
    hold its most device events (the tracer can lose a run's events;
    every run of one length launches the same work). Raises ValueError
    when a run is missing, no run of a length holds device work, or the
    long chain puts no more on the card than the short one (its calls
    launch no device work)."""
    busy = chain_busy_times(events)
    per = {}
    for n in (n_short, n_long):
        got = [busy.get(f"{CHAIN_TAG}:{n}:{j}") for j in range(runs)]
        if any(g is None for g in got) or not max(c for _, c in got):
            raise ValueError(
                f"the trace holds no device work for the {runs} runs of "
                f"the {n}-op chain (of {len(busy)} chain ranges)")
        most = max(c for _, c in got)
        per[n] = ([t for t, c in got if c == most], most)
    if per[n_long][1] <= per[n_short][1]:
        raise ValueError(
            f"the {n_long}-op chain put no more on the card than the "
            f"{n_short}-op chain: its calls launch no device work (a "
            "collective over one rank moves nothing)")
    mean = {n: sum(ts) / len(ts) for n, (ts, _) in per.items()}
    return (mean[n_long] - mean[n_short]) / (n_long - n_short)


def on_card(x) -> bool:
    """Whether ``x`` is a tensor on a CUDA device."""
    return isinstance(x, torch.Tensor) and x.is_cuda


def capture_device_slope(f_short: Callable, f_long: Callable, x,
                         n_short: int, n_long: int, runs: int,
                         timeout_s: Optional[float] = None,
                         barrier: Optional[Callable[[], None]] = None
                         ) -> Tuple[Optional[float], Optional[str]]:
    """``runs`` alternating (short, long) chain runs under
    ``torch.profiler``, each fenced, and each started after ``barrier``
    (the mesh's: a collective's kernel spins on the card until its peers
    launch theirs, so a rank still entering the profiler would show up
    as busy time of the others) → (device slope or None, note). The same
    runs go once first as the profiler's warm-up cycle, which is not
    recorded: the tracer can lose the first events after it starts. On a
    card the recorded runs sit between two pauses of ``WINDOW_PAD_S``. The
    note is None only where no device track can exist (a CPU world):
    there the verdict is unjudged. Raises :class:`TransferTimeout` when
    a fence outlives ``timeout_s``."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    card = on_card(x)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card
                                     else [])
    with tempfile.TemporaryDirectory(prefix="tp_p2p_dev_") as td:
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            for cycle in ("warm-up", "recorded"):
                pad = card and cycle == "recorded"
                if pad:
                    time.sleep(WINDOW_PAD_S)
                for j in range(runs):
                    for n, f in ((n_short, f_short), (n_long, f_long)):
                        if barrier is not None:
                            barrier()
                        with record_function(f"{CHAIN_TAG}:{n}:{j}"):
                            out = f(x)
                        timing_mod.run_fenced(out, timeout_s)
                if pad:
                    time.sleep(WINDOW_PAD_S)
                prof.step()
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    try:
        return differential_from_kernels(events, n_short, n_long,
                                         runs), None
    except ValueError as e:
        if card or has_device_track(events):
            return None, str(e)
        return None, None


def _slope_verdict(host_per_op_s, device_per_op_s, ratio, tol,
                   note) -> Optional[bool]:
    """Shared host-vs-device slope verdict (reference :672), behind both
    :class:`TimingValidation.ok` and :class:`HeadlineMeasurement.ok`:

    - no device slope: False when ``note`` says why (a failure where a
      track exists), else unjudged (None — a CPU world);
    - degenerate device slope → False;
    - degenerate host slope next to a healthy device slope → unjudged;
    - else the ratio band.
    """
    if device_per_op_s is None:
        return False if note else None
    if not device_per_op_s > 0:
        return False
    if not host_per_op_s > 0:  # NaN or nonpositive diagnostic
        return None
    return (1.0 / tol) <= ratio <= tol


@dataclass
class TimingValidation:
    host_per_op_s: float
    device_per_op_s: Optional[float]  # None: no device track
    ratio: Optional[float]
    tol: float
    n_short: int
    n_long: int
    note: Optional[str] = None  # why a present track gave no slope

    @property
    def ok(self) -> Optional[bool]:
        """See :func:`_slope_verdict`."""
        return _slope_verdict(self.host_per_op_s, self.device_per_op_s,
                              self.ratio, self.tol, self.note)

    def describe(self) -> str:
        if self.device_per_op_s is None:
            if self.note:
                return ("timing-validation[MISMATCH]: device track "
                        f"present but slope not extractable — {self.note}")
            return ("timing-validation: no device track in trace "
                    "(platform records host events only) — not judged")
        ratio = f"{self.ratio:.3f}" if self.ratio is not None else "n/a"
        if self.ok is None:
            return (
                "timing-validation[UNJUDGED]: host differential "
                f"degenerate ({self.host_per_op_s * 1e6:.3f} us/op — "
                "relay clock cannot resolve this per-op time); "
                f"device-trace {self.device_per_op_s * 1e6:.3f} us/op "
                "stands"
            )
        verdict = "OK" if self.ok else "MISMATCH"
        return (
            f"timing-validation[{verdict}]: host-differential "
            f"{self.host_per_op_s * 1e6:.3f} us/op vs device-trace "
            f"{self.device_per_op_s * 1e6:.3f} us/op "
            f"(ratio {ratio}, tol {self.tol}x, "
            f"chains {self.n_short}/{self.n_long})"
        )


def _chain_lengths(iters: int) -> Tuple[int, int]:
    short = max(1, iters // 8)
    return short, max(iters, short + 1)


def validate_differential(
    make_chain: Callable[[int], Callable],
    x,
    iters: int,
    *,
    tol: float = 2.0,
    repeats: int = 3,
    runs: int = 2,
    timing=None,
    timeout_s: Optional[float] = None,
    barrier: Optional[Callable[[], None]] = None,
) -> TimingValidation:
    """Host differential and device slope of the same two chains,
    compared (reference :745): ``timing.measure_differential`` over
    ``make_chain``, then ``runs`` alternating runs of both chains under
    the profiler."""
    timing = timing or timing_mod
    s = timing.measure_differential(make_chain, x, iters, repeats=repeats,
                                    timeout_s=timeout_s, barrier=barrier)
    short, n_long = _chain_lengths(iters)
    f_short, f_long = make_chain(short), make_chain(n_long)
    timing_mod.run_fenced(f_short(x), timeout_s)
    timing_mod.run_fenced(f_long(x), timeout_s)
    dev, note = capture_device_slope(f_short, f_long, x, short, n_long,
                                     runs, timeout_s, barrier)
    host = s.mean_region
    ratio = (dev / host) if (dev is not None and host > 0) else None
    return TimingValidation(
        host_per_op_s=host, device_per_op_s=dev, ratio=ratio, tol=tol,
        n_short=short, n_long=n_long, note=note,
    )


@dataclass
class HeadlineMeasurement:
    """A differential measurement whose published value is the device
    slope wherever a device track exists, the host slope demoted to the
    diagnostic (reference :866)."""

    per_op_s: Optional[float]  # the number to publish, or None
    source: str  # "device_trace" | "host_differential" | "none"
    host_per_op_s: float
    device_per_op_s: Optional[float]
    ratio: Optional[float]  # device / host
    tol: float
    n_short: int
    n_long: int
    remeasured: bool = False  # True: first capture disagreed, re-ran
    note: Optional[str] = None
    timed_out: bool = False
    host_samples: Optional[object] = None  # the timing.Samples behind host

    @property
    def ok(self) -> Optional[bool]:
        """See :func:`_slope_verdict`."""
        return _slope_verdict(self.host_per_op_s, self.device_per_op_s,
                              self.ratio, self.tol, self.note)

    def as_samples(self):
        """The :class:`timing.Samples` shape the workloads consume: one
        sample, the published per-op time, with ``source`` (and, when a
        device read failed, ``note``) riding along for cell records."""
        s = timing_mod.Samples()
        s.timed_out = self.timed_out
        if self.per_op_s is not None:
            s.iter_seconds = [self.per_op_s]
            s.region_seconds = self.per_op_s
        s.source = self.source
        s.note = self.note
        return s

    def validation_fields(self) -> dict:
        """JSON-ready ``timing_validation`` dict from the same run as the
        headline."""
        h = self.host_per_op_s
        return {
            "ok": self.ok,
            "host_us_per_op": round(h * 1e6, 4) if h == h else None,
            "device_us_per_op": (
                round(self.device_per_op_s * 1e6, 4)
                if self.device_per_op_s is not None else None
            ),
            "ratio": round(self.ratio, 3) if self.ratio is not None else None,
            "headline_source": self.source,
            "remeasured": self.remeasured,
        }


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _any_rank(flag: bool, group) -> bool:
    """True on every rank of ``group`` when ``flag`` is true on any."""
    if _group_size(group) <= 1:
        return flag
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def _from_first(flag: bool, group) -> bool:
    """The first member's ``flag`` on every rank of ``group``."""
    if _group_size(group) <= 1:
        return flag
    first = dist.get_rank(group) == 0
    t = torch.tensor([int(bool(flag)) if first else 0], dtype=torch.int32)
    dist.all_reduce(t, group=group)
    return bool(t.item())


def measure_headline(
    make_chain: Callable[[int], Callable],
    x,
    iters: int,
    *,
    repeats: int = 3,
    runs: int = 2,
    retol: float = 1.3,
    tol: float = 2.0,
    timing=None,
    timeout_s: Optional[float] = None,
    barrier: Optional[Callable[[], None]] = None,
    group=None,
) -> HeadlineMeasurement:
    """Differential measurement publishing the device slope (reference
    :947).

    1. Build the short and long chains once.
    2. Host differential via ``timing.measure_differential`` — the
       diagnostic.
    3. ``runs`` alternating (short, long) runs under the profiler: the
       device slope (:func:`capture_device_slope`).
    4. Where both exist and disagree beyond ``retol``, the whole
       measurement runs once more: mutually consistent captures are
       averaged, else the capture its own host pair vouches for wins,
       else the smaller. The decision is the first member of ``group``'s
       (the mesh's host group), so every rank takes the same branch: the
       chains are collectives, and a split decision would deadlock them.

    The published ``per_op_s`` is the device slope where one exists. On
    a CPU world (no device track) it is the host slope, ``source
    "host_differential"``. On a card a missing or degenerate device
    slope publishes nothing (``source "none"``, the note says why).
    """
    timing = timing or timing_mod
    short, n_long = _chain_lengths(iters)
    f_short, f_long = make_chain(short), make_chain(n_long)
    pre = {short: f_short, n_long: f_long}
    card = on_card(x)

    def host_slope():
        return timing.measure_differential(
            lambda k: pre[k], x, n_long, repeats=repeats,
            timeout_s=timeout_s, barrier=barrier,
        )

    def device_slope():
        try:
            return capture_device_slope(f_short, f_long, x, short, n_long,
                                        runs, timeout_s, barrier)
        except TransferTimeout:
            raise
        except (RuntimeError, OSError, json.JSONDecodeError) as e:
            return None, f"trace capture failed: {e!r}"

    def timed_out(s):
        return HeadlineMeasurement(
            per_op_s=None, source="none", host_per_op_s=float("nan"),
            device_per_op_s=None, ratio=None, tol=tol, n_short=short,
            n_long=n_long, timed_out=True, host_samples=s,
        )

    s = host_slope()
    if _any_rank(s.timed_out, group):
        return timed_out(s)
    host = s.mean_region
    dev_timed_out = False
    try:
        dev, note = device_slope()
    except TransferTimeout:
        dev, note, dev_timed_out = None, None, True
    if _any_rank(dev_timed_out, group):
        return timed_out(s)
    remeasured = False
    want_remeasure = _from_first(
        dev is not None and host > 0
        and not ((1.0 / retol) <= dev / host <= retol), group)
    if want_remeasure:
        s2 = host_slope()
        try:
            dev2, note2 = device_slope()
        except TransferTimeout:
            dev2, note2 = None, "re-measure capture timed out"
        remeasured = True
        if dev2 is not None:
            host2 = s2.mean_region if not s2.timed_out else float("nan")
            pair2_ok = (
                host2 == host2 and host2 > 0
                and (1.0 / retol) <= dev2 / host2 <= retol
            )
            captures_consistent = (
                dev is not None and dev > 0
                and (1.0 / retol) <= dev2 / dev <= retol
            )
            if dev is None:
                dev = dev2
            elif captures_consistent:
                dev = (dev + dev2) / 2.0
            elif pair2_ok:
                dev = dev2
            else:
                dev = min(dev, dev2)
        if dev2 is not None or note2 is not None:
            note = note2
        if not s2.timed_out and s2.mean_region == s2.mean_region:
            host = s2.mean_region
            s = s2  # host_samples must match the reported host slope
    ratio = (dev / host) if (dev is not None and host > 0) else None
    if dev is not None and dev > 0:
        per_op, source = dev, "device_trace"
    elif card:
        per_op, source = None, "none"
        note = note or (f"device slope {dev!r} s/op is not positive"
                        if dev is not None else
                        "no device slope on a card")
    elif host == host and host > 0:
        per_op, source = host, "host_differential"
    else:
        per_op, source = None, "none"
    return HeadlineMeasurement(
        per_op_s=per_op, source=source, host_per_op_s=host,
        device_per_op_s=dev, ratio=ratio, tol=tol, n_short=short,
        n_long=n_long, remeasured=remeasured, note=note, host_samples=s,
    )


# ------------------------------------------------ device-track readers
#
# The reference reads an XLA trace directory (``tpu_p2p/utils/
# profiling.py:415-560``). Here a trace is one ``torch.profiler`` window
# exported as a Chrome trace: Kineto's device events (kernels, copies and
# fills, each with its card, its stream and its µs stamps). Each reader
# takes the JSON file's path or its ``traceEvents`` list, keeps the
# lowest card's events (a process profiles its own card), and returns
# None when the window holds no device event (a CPU world), as the
# reference does for a platform without a device track.


@dataclass(frozen=True)
class DeviceEvent:
    """One event on a card's timeline (seconds on the trace's clock)."""

    name: str
    t0: float
    t1: float
    stream: int
    cat: str
    correlation: Optional[int] = None  # the launching runtime call's id


def _trace_events(trace) -> list:
    if isinstance(trace, (list, tuple)):
        return list(trace)
    with open(trace) as fh:
        return json.load(fh).get("traceEvents", [])


def device_events(trace) -> Optional[List[DeviceEvent]]:
    """The lowest card's device events of ``trace``, by start, or None
    when it holds none."""
    evs = [e for e in _trace_events(trace)
           if e.get("cat") in DEVICE_CATS and e.get("ph", "X") == "X"]
    if not evs:
        return None

    def card(e):
        args = e.get("args", {})
        return int(args.get("device", e.get("pid", 0)) or 0)

    first = min(card(e) for e in evs)
    out = [DeviceEvent(str(e.get("name", "")), e["ts"] / 1e6,
                       (e["ts"] + e.get("dur", 0)) / 1e6,
                       int(e.get("args", {}).get("stream", e.get("tid", 0))
                           or 0), e["cat"],
                       e.get("args", {}).get("correlation"))
           for e in evs if card(e) == first]
    out.sort(key=lambda d: d.t0)
    return out


def _is_collective(name: str) -> bool:
    from tpu_p2p_torch.obs.ledger import kind_of_event

    return kind_of_event(name) is not None or "nccl" in name.lower()


def _union(spans) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _intersect_len(a, b) -> float:
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _within(window, t0: float, t1: float) -> bool:
    return window is None or (window[0] <= t0 and t1 <= window[1])


def device_collective_intervals(trace, window=None):
    """The window's collective device events → ``[(name, t0, t1), ...]``
    by start, in seconds: NCCL's kernels and the peer-push kernels
    (the obs ledger's join input, reference :415). ``window``: a ``(t0,
    t1)`` containment filter. None without a device track; an empty list
    for a device track with no collective."""
    evs = device_events(trace)
    if evs is None:
        return None
    return [(e.name, e.t0, e.t1) for e in evs
            if _is_collective(e.name) and _within(window, e.t0, e.t1)]


def labelled_collective_intervals(trace, window=None):
    """:func:`device_collective_intervals` with each event's ledger labels
    → ``[(name, t0, t1, labels), ...]``: the names of the
    :data:`~tpu_p2p_torch.obs.ledger.ISSUE_TAG` ranges that enclose the
    event's launch on its host thread, innermost last (the runtime or
    driver call's ``correlation`` id ties the device event to its
    launch), ``()`` where none does. None without a device track."""
    from tpu_p2p_torch.obs.ledger import ISSUE_TAG

    events = _trace_events(trace)
    evs = device_events(events)
    if evs is None:
        return None
    ranges: Dict[tuple, List[Tuple[float, float, str]]] = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and \
                str(e.get("name", "")).startswith(ISSUE_TAG):
            ranges[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], e["ts"] + e.get("dur", 0), str(e["name"])))
    owner = {}
    for e in events:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        rs = ranges.get((e.get("pid"), e.get("tid")))
        if not rs:
            continue
        inside = sorted((r for r in rs if r[0] <= e["ts"] <= r[1]),
                        key=lambda r: r[0])
        if inside:
            owner[e.get("args", {}).get("correlation")] = tuple(
                r[2] for r in inside)
    return [(e.name, e.t0, e.t1, owner.get(e.correlation, ()))
            for e in evs
            if _is_collective(e.name) and _within(window, e.t0, e.t1)]


def device_busy_fraction(trace, window=None):
    """Share of the window the card spent executing (reference :449):
    the union of its device events over the span (``window``, else
    first start to last end) → ``{"busy_s", "span_s", "frac"}``, or None
    without a device track."""
    evs = device_events(trace)
    if evs is None:
        return None
    rows = [(e.t0, e.t1) for e in evs if _within(window, e.t0, e.t1)]
    if window is not None:
        span = window[1] - window[0]
    else:
        span = (max(r[1] for r in rows) - min(r[0] for r in rows)
                if rows else 0.0)
    busy = sum(b - a for a, b in _union(rows))
    return {"busy_s": busy, "span_s": span,
            "frac": (busy / span) if span > 0 else None}


def gather_overlap_fraction(trace, names: tuple = ("allgather",),
                            window=None) -> Optional[dict]:
    """Share of the collective time whose event name holds one of
    ``names`` that runs under concurrent compute (reference :480, the
    FSDP prefetch metric): ``|gather ∩ compute| / |gather|`` over the
    unions of those events and of every non-collective device event →
    ``{"frac", "gather_s", "hidden_s", "compute_s"}`` (``frac`` None
    when no such collective ran), or None without a device track."""
    evs = device_events(trace)
    if evs is None:
        return None
    inside = [e for e in evs if _within(window, e.t0, e.t1)]
    gu = _union((e.t0, e.t1) for e in inside
                if any(s in e.name.lower() for s in names))
    cu = _union((e.t0, e.t1) for e in inside
                if not _is_collective(e.name))
    gather_s = sum(b - a for a, b in gu)
    hidden_s = _intersect_len(gu, cu)
    return {"frac": (hidden_s / gather_s) if gather_s > 0 else None,
            "gather_s": gather_s, "hidden_s": hidden_s,
            "compute_s": sum(b - a for a, b in cu)}


def tp_overlap_fraction(trace, window=None) -> Optional[dict]:
    """:func:`gather_overlap_fraction` over NCCL's send/recv kernels, the
    ``tp_overlap="ring"`` hops (reference :546)."""
    return gather_overlap_fraction(trace, names=("sendrecv",),
                                   window=window)


def profile_window(fn: Callable[[], object], directory: str,
                   pad_s: float = WINDOW_PAD_S,
                   name: str = "window.json", *, host: bool = False) -> str:
    """Run ``fn`` once under ``torch.profiler``, drained, and export the
    window as a Chrome trace → its path. On a card the card's activity
    is traced, and the host's only with ``host`` (the ledger's issue
    labels and the launches that tie each device event to one, which the
    labelled join reads; the host tracer's cost would change every other
    reading of the window); there the window opens and closes with a
    host pause of ``pad_s`` (``WINDOW_PAD_S``: the tracer loses events
    near a window's edges). Without a card, the host's."""
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available() and torch.cuda.is_initialized()
    acts = ([ProfilerActivity.CPU] if host or not card else []) + (
        [ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        if card:
            time.sleep(pad_s)
        fn()
        if card:
            torch.cuda.synchronize()
            time.sleep(pad_s)
    path = os.path.join(directory, name)
    prof.export_chrome_trace(path)
    return path
