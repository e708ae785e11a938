"""Step timeline: span-based host-side step telemetry — the port of
``tpu_p2p/obs/timeline.py``.

A :class:`StepTimeline` wraps the training loop's phases in named spans
and emits one JSONL record a step through the trainer's ``emit`` path
(behind ``--obs-jsonl``)::

    {"obs": "step", "step": 7, "step_ms": 12.3,
     "spans": {"data": 0.4, "step": 11.6, "checkpoint": 0.3}}

Span kinds are an open set; the trainer emits what its loop can
honestly separate — ``data`` (the host batch), ``step`` (issue and the
card's execution, drained: forward, backward and update are one call
here, and a host split of them would be fiction), ``eval``,
``checkpoint``. The device-side split of a step lives in the profiled
window instead (the ledger's per-kind collective time).

The stream's record vocabulary is open the same way: the trainer emits
``{"obs": "step" | "device_window" | "summary"}`` (plus the health
engine's ``"health"`` / ``"heal"`` and the checkpoint's ``"ckpt"``),
the serving engine ``{"obs": "request" | "serve_summary" |
"serve_ledger"}``; consumers skip kinds they do not know.

Device correlation: :func:`device_window_record` turns one profiled
step (a ``torch.profiler`` window exported as a Chrome trace) into a
``{"obs": "device_window"}`` record carrying the device-busy fraction,
the FSDP gather and tp overlap fractions and, with a ledger, the join's
per-kind achieved bandwidth; the trainer also folds the fractions into
that step's row. One window a run, not every step. Without a device
track (a CPU world) every device field is an explicit null.
"""

from __future__ import annotations

import math
import statistics
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

__all__ = ["SPAN_KINDS", "StepTimeline", "device_window_record",
           "pick_window_step"]

# Documented span vocabulary (open set: emitters may add kinds, but
# these names are the schema consumers can rely on).
SPAN_KINDS = ("data", "gather", "forward", "backward", "optimizer",
              "step", "eval", "checkpoint")


def pick_window_step(start_step: int, steps: int,
                     window_step: Optional[int] = None) -> int:
    """Which step gets the one profiled window.

    The default is the SECOND executed step (the first carries the
    kernels' builds and the allocator's warm-up), the first when the run
    is a single step. ``window_step`` overrides: an absolute step index,
    clamped into the executed range ``[start_step, steps)`` so a stale
    value from a resumed run still samples something.
    """
    last = max(start_step, steps - 1)
    if window_step is not None:
        return min(max(int(window_step), start_step), last)
    return start_step + 1 if steps - start_step > 1 else start_step


class StepTimeline:
    """Accumulates named host-side spans a step; emits JSONL rows.

    ``emit``: callable taking one JSON-ready dict. Spans within one step
    accumulate (two ``data`` spans sum into one entry); ``end_step``
    emits the row and resets. ``step_ms`` is wall time from the step's
    first span start to the ``end_step`` call.
    """

    def __init__(self, emit: Callable[[dict], None],
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._emit = emit
        self._clock = clock
        self._spans: Dict[str, float] = {}
        self._t0: Optional[float] = None
        self.step_ms_history: List[float] = []

    @contextmanager
    def span(self, name: str):
        t0 = self._clock()
        if self._t0 is None:
            self._t0 = t0
        try:
            yield
        finally:
            self._spans[name] = (self._spans.get(name, 0.0)
                                 + self._clock() - t0)

    def end_step(self, step: int, extra: Optional[dict] = None) -> dict:
        """Emit this step's row and reset the span accumulator."""
        now = self._clock()
        step_ms = (now - self._t0) * 1e3 if self._t0 is not None else 0.0
        rec = {
            "obs": "step",
            "step": int(step),
            "step_ms": round(step_ms, 3),
            "spans": {k: round(v * 1e3, 3)
                      for k, v in sorted(self._spans.items())},
        }
        if extra:
            rec.update(extra)
        self._spans = {}
        self._t0 = None
        self.step_ms_history.append(step_ms)
        self._emit(rec)
        return rec

    def _steady_history(self) -> List[float]:
        """Step times with the first step dropped when more than two
        steps ran: the sample both percentiles quote."""
        h = self.step_ms_history
        return h[1:] if len(h) > 2 else h

    def p50_step_ms(self) -> Optional[float]:
        h = self._steady_history()
        if not h:
            return None
        return round(float(statistics.median(h)), 3)

    def p99_step_ms(self) -> Optional[float]:
        """Nearest-rank p99 of the same sample (the worst step for fewer
        than 100 samples)."""
        h = self._steady_history()
        if not h:
            return None
        h = sorted(h)
        idx = max(0, math.ceil(0.99 * len(h)) - 1)
        return round(float(h[idx]), 3)

    def summary_record(self) -> dict:
        return {
            "obs": "summary",
            "steps": len(self.step_ms_history),
            "obs_step_ms_p50": self.p50_step_ms(),
            "obs_step_ms_p99": self.p99_step_ms(),
        }


def device_window_record(trace, *, step: Optional[int] = None,
                         ledger=None) -> dict:
    """One profiled step → a JSONL-ready record (``trace``: the window's
    Chrome-trace path or event list).

    The card's busy fraction over the window
    (:func:`tpu_p2p_torch.utils.profiling.device_busy_fraction`), the
    FSDP gather and tp send/recv overlap fractions and — with a
    :class:`~tpu_p2p_torch.obs.ledger.CollectiveLedger` — the join's
    per-kind achieved bandwidth. Every device field is null without a
    device track, and ``device_track`` says so.
    """
    from tpu_p2p_torch.utils.profiling import (
        _trace_events,
        device_busy_fraction,
        gather_overlap_fraction,
        tp_overlap_fraction,
    )

    events = _trace_events(trace)
    busy = device_busy_fraction(events)
    rec: dict = {
        "obs": "device_window",
        "step": step,
        "device_track": busy is not None,
        "device_busy_frac": None,
        "device_span_ms": None,
        "gather_overlap_frac": None,
        "tp_overlap_frac": None,
    }
    if busy is not None:
        rec["device_busy_frac"] = (
            round(busy["frac"], 4) if busy["frac"] is not None else None
        )
        rec["device_span_ms"] = round(busy["span_s"] * 1e3, 3)
        ov = gather_overlap_fraction(events)
        if ov is not None and ov["frac"] is not None:
            rec["gather_overlap_frac"] = round(ov["frac"], 4)
        tv = tp_overlap_fraction(events)
        if tv is not None and tv["frac"] is not None:
            rec["tp_overlap_frac"] = round(tv["frac"], 4)
    if ledger is not None:
        from tpu_p2p_torch.obs.ledger import join_trace

        join = join_trace(ledger, events)
        rec["collectives"] = {
            kind: {
                "events": d["events"],
                "wire_bytes": d["wire_bytes"],
                "seconds": round(d["seconds"], 6),
                "achieved_gbps": (round(d["achieved_gbps"], 3)
                                  if d["achieved_gbps"] is not None
                                  else None),
            }
            for kind, d in sorted(join.per_kind().items())
        }
        rec["ledger_issues"] = len(ledger)
        rec["unmatched_collective_events"] = sum(
            int(d["events"]) for d in join.unmatched.values()
        )
    return rec
