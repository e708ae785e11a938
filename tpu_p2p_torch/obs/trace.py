"""Chrome-trace/Perfetto export of the observability streams — the
port's copy of ``tpu_p2p/obs/trace.py``, host code whose output equals
the reference's on equal input (bar ``otherData.exporter``, which names
this module).

One exporter for every timeline, written as the Trace Event Format JSON
(``chrome://tracing`` / https://ui.perfetto.dev both load it): a
schedule's per-(rank, tick) spans, per-link collective events already
carrying device timestamps, the trainer's ``--obs-jsonl`` step timeline
(data/step/eval/checkpoint spans), and serve request lifecycles from
``{"obs": "request"}`` records (enqueue → prefill → migrate →
first-token → decode, one track per engine slot lane, disagg migration
waits visible). KV-reuse events — ``{"obs": "serve_reuse"}`` records
of the prefix cache and the speculative decoder — ride the same lanes
as instants: a ``prefix_hit`` at admission, a ``spec_accept`` or
``spec_reject`` per mixed verify step. ``serve --trace PATH`` writes
the serve track (:mod:`tpu_p2p_torch.serve.engine`).

Track layout:

- pid 1 ``tick schedule``: one thread per pp rank; each tick renders
  as a compute span (named by its op kind) followed by a ``hop`` span
  (the ship + any rendezvous wait) — host boundary clock.
- pid 2 ``links``: async begin/end pairs per joined collective event,
  device-trace clock, args carry wire bytes and the ledger edge.
- pid 3 ``train``: the step timeline re-laid sequentially from each
  row's ``step_ms`` (the stream records durations, not absolute
  times); ckpt/health/device-window records ride as instants.
- pid 4 ``serve``: request lifecycles on greedily-assigned slot
  lanes; the time axis is the SCHEDULER STEP (1 step = 1 "ms"),
  because request records are step-indexed by design.
- pid 5 ``unattributed``: device-trace intervals a ledger join could
  not attribute — dropped time stays visible, never silent.

Clocks are per-pid: each track family is normalized to its own epoch;
cross-pid alignment is NOT claimed. The validator
(:func:`validate_chrome_trace`) pins the schema contract: required
keys per phase, per-track monotonic timestamps, declared pid/tid
metadata for every emitting track.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PID_TICKS", "PID_LINKS", "PID_TRAIN", "PID_SERVE",
           "PID_UNATTR", "write_chrome_trace", "validate_chrome_trace",
           "load_obs_records", "serve_lanes", "SPAN_KINDS", "EXPORTER"]

EXPORTER = "tpu_p2p_torch.obs.trace"  # otherData.exporter

PID_TICKS = 1
PID_LINKS = 2
PID_TRAIN = 3
PID_SERVE = 4
PID_UNATTR = 5

_PROCESS_NAMES = {
    PID_TICKS: "tick schedule (host boundary clock)",
    PID_LINKS: "links (device trace clock)",
    PID_TRAIN: "train step timeline (re-laid from step_ms)",
    PID_SERVE: "serve requests (scheduler steps, 1 step = 1 ms)",
    PID_UNATTR: "unattributed device time",
}

# The documented span vocabulary of a step timeline row (the
# reference's ``tpu_p2p/obs/timeline.py`` ``SPAN_KINDS``): an open set,
# laid out in this order, extra kinds after them alphabetically.
SPAN_KINDS = ("data", "gather", "forward", "backward", "optimizer",
              "step", "eval", "checkpoint")

# Serve track time base: request records are step-indexed (the
# scheduler step IS their clock), rendered at 1 step = 1000 us so
# Perfetto's ms ruler reads directly in steps.
_US_PER_STEP = 1000.0


def _meta(pid: int, name: str, tid: int = 0,
          kind: str = "process_name") -> dict:
    return {"name": kind, "ph": "M", "pid": pid, "tid": tid, "ts": 0,
            "args": {"name": name}}


def _span(pid: int, tid: int, name: str, ts_us: float, dur_us: float,
          cat: str, args: Optional[dict] = None) -> dict:
    ev = {"name": name, "cat": cat, "ph": "X", "pid": pid, "tid": tid,
          "ts": round(float(ts_us), 3),
          "dur": round(max(float(dur_us), 0.0), 3)}
    if args:
        ev["args"] = args
    return ev


def _instant(pid: int, tid: int, name: str, ts_us: float, cat: str,
             args: Optional[dict] = None) -> dict:
    ev = {"name": name, "cat": cat, "ph": "i", "s": "t", "pid": pid,
          "tid": tid, "ts": round(float(ts_us), 3)}
    if args:
        ev["args"] = args
    return ev


def load_obs_records(path: str) -> List[dict]:
    """Parse an ``--obs-jsonl`` stream; skips non-JSON lines and
    records without an ``obs`` kind (open-vocabulary contract —
    consumers skip what they do not know, timeline.py docstring)."""
    out: List[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("obs"):
                out.append(rec)
    return out


# ------------------------------------------------------------- tracks


def _tick_events(tick_spans: Sequence[dict]) -> List[dict]:
    """Flight-recorder spans → two X events per (rank, tick): the
    compute span named by the tick's IR op kind, then the ``hop``
    span (ship dispatch + rendezvous wait — where another rank's
    bubble physically manifests)."""
    evs: List[dict] = []
    if not tick_spans:
        return evs
    t0 = min(float(s["start"]) for s in tick_spans)
    ranks = sorted({int(s["rank"]) for s in tick_spans})
    for r in ranks:
        evs.append(_meta(PID_TICKS, f"rank {r}", tid=r,
                         kind="thread_name"))
    for s in tick_spans:
        rank, tick = int(s["rank"]), int(s["tick"])
        kind = s.get("kind", "tick")
        start = (float(s["start"]) - t0) * 1e6
        mid = (float(s["compute_end"]) - t0) * 1e6
        end = (float(s["end"]) - t0) * 1e6
        args = {"tick": tick, "rank": rank, "kind": kind}
        evs.append(_span(PID_TICKS, rank, f"{kind} t{tick}", start,
                         mid - start, "tick", args))
        evs.append(_span(PID_TICKS, rank, f"hop t{tick}", mid,
                         end - mid, "hop", args))
    return evs


def _link_events(link_events: Sequence[dict]) -> List[dict]:
    """Ledger-joined collective events → async begin/end pairs (the
    Trace Event Format's flow-style rendering for overlapping
    transfers), device-trace clock."""
    evs: List[dict] = []
    if not link_events:
        return evs
    t0 = min(float(e["t0"]) for e in link_events)
    evs.append(_meta(PID_LINKS, "collectives", tid=0,
                     kind="thread_name"))
    for i, e in enumerate(sorted(link_events,
                                 key=lambda e: float(e["t0"]))):
        name = str(e.get("name") or e.get("event") or "collective")
        args = {k: e[k] for k in ("kind", "edge", "wire_bytes", "tick",
                                  "label") if e.get(k) is not None}
        base = {"name": name, "cat": "link", "id": i, "pid": PID_LINKS,
                "tid": 0}
        if args:
            base["args"] = args
        b = dict(base)
        b.update(ph="b", ts=round((float(e["t0"]) - t0) * 1e6, 3))
        en = dict(base)
        en.update(ph="e", ts=round((float(e["t1"]) - t0) * 1e6, 3))
        evs.extend((b, en))
    return evs


def _unattributed_events(unattributed: Sequence[Tuple[str, float,
                                                      float]],
                         epoch: Optional[float] = None) -> List[dict]:
    """``TraceJoin.unmatched_intervals`` → X spans on their own track
    so dropped device time is visible, not silent."""
    evs: List[dict] = []
    if not unattributed:
        return evs
    t0 = epoch if epoch is not None else min(float(t)
                                             for _, t, _ in unattributed)
    evs.append(_meta(PID_UNATTR, "unmatched device events", tid=0,
                     kind="thread_name"))
    for name, a, b in sorted(unattributed, key=lambda e: float(e[1])):
        evs.append(_span(PID_UNATTR, 0, str(name), (float(a) - t0) * 1e6,
                         (float(b) - float(a)) * 1e6, "unattributed"))
    return evs


# Span layout order within one step row (SPAN_KINDS order, then any
# extra kinds the emitter added, alphabetically — open-set contract).
def _ordered_spans(spans: Dict[str, float]) -> List[Tuple[str, float]]:
    known = [(k, spans[k]) for k in SPAN_KINDS if k in spans]
    extra = sorted((k, v) for k, v in spans.items()
                   if k not in SPAN_KINDS)
    return known + extra


def _train_events(records: Sequence[dict]) -> List[dict]:
    """Step-timeline rows → sequential spans. The stream records
    DURATIONS (``step_ms`` + per-phase spans), not absolute times, so
    the track re-lays steps back to back: correct widths and
    per-phase shares, synthetic gaps-free placement."""
    evs: List[dict] = []
    steps = [r for r in records if r.get("obs") == "step"]
    others = [r for r in records
              if r.get("obs") in ("ckpt", "health", "heal",
                                  "device_window", "summary")]
    if not steps and not others:
        return evs
    evs.append(_meta(PID_TRAIN, "steps", tid=0, kind="thread_name"))
    evs.append(_meta(PID_TRAIN, "phases", tid=1, kind="thread_name"))
    evs.append(_meta(PID_TRAIN, "events", tid=2, kind="thread_name"))
    cursor = 0.0
    step_ts: Dict[int, float] = {}
    for r in steps:
        dur = float(r.get("step_ms") or 0.0) * 1e3
        step_no = int(r.get("step") or 0)
        step_ts[step_no] = cursor
        args = {k: r[k] for k in ("step", "step_ms", "device_busy_frac")
                if r.get(k) is not None}
        evs.append(_span(PID_TRAIN, 0, f"step {step_no}", cursor, dur,
                         "step", args))
        sub = cursor
        for kind, ms in _ordered_spans(r.get("spans") or {}):
            evs.append(_span(PID_TRAIN, 1, kind, sub,
                             float(ms) * 1e3, "phase"))
            sub += float(ms) * 1e3
        cursor += dur
    last = cursor
    for r in others:
        step_no = r.get("step")
        ts = step_ts.get(int(step_no), last) if step_no is not None \
            else last
        name = r["obs"] if r["obs"] != "ckpt" \
            else f"ckpt {r.get('event', '?')}"
        args = {k: v for k, v in r.items()
                if isinstance(v, (int, float, str, bool))
                and k != "obs"}
        evs.append(_instant(PID_TRAIN, 2, name, ts, "event", args))
    return evs


def serve_lanes(requests: Sequence[dict]) -> Dict[int, int]:
    """Greedy slot-lane assignment: request records carry no slot id,
    so the export assigns each request the lowest-index lane whose
    previous occupant finished at or before this request's enqueue
    step — at most ``slots`` concurrent lanes by construction, one
    track per effective slot. Returns ``{request id: lane}``."""
    lanes: List[int] = []  # last occupied step per lane
    out: Dict[int, int] = {}

    def _end(r) -> int:
        for k in ("finish_step", "shed_step", "first_token_step",
                  "enqueue_step"):
            if r.get(k) is not None:
                return int(r[k])
        return 0

    for r in sorted(requests,
                    key=lambda r: (int(r.get("enqueue_step") or 0),
                                   int(r.get("id") or 0))):
        start = int(r.get("enqueue_step") or 0)
        end = max(_end(r), start)
        for i, busy_until in enumerate(lanes):
            if busy_until <= start:
                lanes[i] = end
                out[int(r.get("id") or 0)] = i
                break
        else:
            lanes.append(end)
            out[int(r.get("id") or 0)] = len(lanes) - 1
    return out


def _serve_events(records: Sequence[dict]) -> List[dict]:
    """Request lifecycle spans on slot lanes, step-indexed time:
    queue → prefill → (disagg migrate wait) → decode, with
    first-token and shed instants. A span is emitted only when both
    its endpoints exist in the record (shed requests stop where their
    lifecycle stopped). ``serve_reuse`` records (prefix hits,
    per-step speculative accept/reject verdicts) render as instants
    on the lane their request occupies — reuse activity reads in
    place on the lifecycle it changed, not on a side track."""
    reqs = [r for r in records if r.get("obs") == "request"]
    reuse = [r for r in records if r.get("obs") == "serve_reuse"]
    evs: List[dict] = []
    if not reqs:
        return evs
    lane_of = serve_lanes(reqs)
    for lane in sorted(set(lane_of.values())):
        evs.append(_meta(PID_SERVE, f"slot lane {lane}", tid=lane,
                         kind="thread_name"))

    def ts(step) -> float:
        return float(step) * _US_PER_STEP

    for r in reqs:
        rid = int(r.get("id") or 0)
        lane = lane_of[rid]
        args = {k: r[k] for k in ("id", "prompt_tokens",
                                  "output_tokens", "outcome", "pool",
                                  "preemptions", "migrations",
                                  "migrate_wait_steps", "decode_shard")
                if r.get(k) is not None}
        enq = r.get("enqueue_step")
        pre = r.get("prefill_start_step")
        pre_done = r.get("prefill_done_step")
        mig = r.get("migrate_step")
        ftok = r.get("first_token_step")
        fin = r.get("finish_step")
        phases = [("queue", enq, pre if pre is not None else
                   r.get("shed_step")),
                  ("prefill", pre,
                   pre_done if pre_done is not None else ftok),
                  ("migrate_wait", pre_done, mig),
                  ("decode", ftok, fin)]
        for name, a, b in phases:
            if a is None or b is None:
                continue
            evs.append(_span(PID_SERVE, lane, f"{name} r{rid}", ts(a),
                             ts(b) - ts(a), name, args))
        if ftok is not None:
            evs.append(_instant(PID_SERVE, lane, f"first_token r{rid}",
                                ts(ftok), "first_token"))
        if r.get("shed_step") is not None:
            evs.append(_instant(PID_SERVE, lane,
                                f"{r.get('outcome', 'shed')} r{rid}",
                                ts(r["shed_step"]), "shed", args))
    # Reuse instants anchor to the owning request's lane; a reuse
    # record whose request never produced a lifecycle row (not in
    # this stream slice) has no lane and is skipped, not misplaced.
    for r in reuse:
        rid = int(r.get("rid") or 0)
        lane = lane_of.get(rid)
        if lane is None:
            continue
        kind = str(r.get("kind") or "reuse")
        args = {k: r[k] for k in ("rid", "pages", "tokens",
                                  "drafted", "accepted")
                if r.get(k) is not None}
        evs.append(_instant(PID_SERVE, lane, f"{kind} r{rid}",
                            ts(r.get("step") or 0), kind, args))
    return evs


# ------------------------------------------------------------- writer


def write_chrome_trace(path: str, *,
                       tick_spans: Sequence[dict] = (),
                       link_events: Sequence[dict] = (),
                       unattributed: Sequence[Tuple[str, float,
                                                    float]] = (),
                       obs_records: Sequence[dict] = (),
                       meta: Optional[dict] = None) -> dict:
    """Write one Chrome-trace JSON combining whichever sections the
    caller has (every section optional; empty sections emit no
    track). Returns the written object. Timestamps are normalized
    per pid (module docstring: clocks are per-track families)."""
    events: List[dict] = []
    by_pid: Dict[int, List[dict]] = {
        PID_TICKS: _tick_events(tick_spans),
        PID_LINKS: _link_events(link_events),
        PID_TRAIN: _train_events(obs_records),
        PID_SERVE: _serve_events(obs_records),
        PID_UNATTR: _unattributed_events(unattributed),
    }
    for pid in sorted(by_pid):
        evs = by_pid[pid]
        if not evs:
            continue
        events.append(_meta(pid, _PROCESS_NAMES[pid]))
        # Stable per-track order: metadata first, then ts order —
        # the monotonicity the validator (and the tests) pin.
        evs.sort(key=lambda e: (e["tid"], e["ph"] != "M",
                                e.get("ts", 0)))
        events.extend(evs)
    obj = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": dict(meta or {}, exporter=EXPORTER),
    }
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return obj


# ---------------------------------------------------------- validator

_REQUIRED = ("name", "ph", "pid", "tid", "ts")


def validate_chrome_trace(trace) -> List[str]:
    """Schema-validate one export; returns a list of problems (empty
    = valid). ``trace`` is a path or the loaded object. Pins the
    contract the tests grade: required keys per event, numeric
    non-negative timestamps, per-(pid, tid) monotonic ``ts`` in file
    order, ``dur >= 0`` on complete events, a ``process_name``
    metadata row for every emitting pid, and balanced async
    begin/end pairs."""
    problems: List[str] = []
    if isinstance(trace, str):
        try:
            with open(trace) as fh:
                trace = json.load(fh)
        except (OSError, ValueError) as e:
            return [f"unreadable trace: {e}"]
    events = trace.get("traceEvents") if isinstance(trace, dict) \
        else None
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    if not events:
        return ["traceEvents is empty"]
    named: Dict[int, int] = {}
    used_pids: set = set()
    last_ts: Dict[Tuple[int, int], float] = {}
    async_open: Dict[Tuple[str, int], int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            problems.append(f"event {i}: missing {missing}")
            continue
        if not isinstance(ev["pid"], int) or not isinstance(ev["tid"],
                                                            int):
            problems.append(f"event {i}: pid/tid not ints")
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0 or ts != ts:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        ph = ev["ph"]
        if ph == "M":
            if ev["name"] == "process_name":
                named[ev["pid"]] = named.get(ev["pid"], 0) + 1
            continue
        used_pids.add(ev["pid"])
        key = (ev["pid"], ev["tid"])
        if ts < last_ts.get(key, 0.0):
            problems.append(
                f"event {i} ({ev['name']}): ts {ts} not monotonic on "
                f"track pid={ev['pid']} tid={ev['tid']}")
        last_ts[key] = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X event bad dur {dur!r}")
        elif ph == "b":
            k = (ev.get("cat", ""), ev.get("id"))
            async_open[k] = async_open.get(k, 0) + 1
        elif ph == "e":
            k = (ev.get("cat", ""), ev.get("id"))
            if async_open.get(k, 0) <= 0:
                problems.append(f"event {i}: async end without begin "
                                f"(id={ev.get('id')})")
            else:
                async_open[k] -= 1
    for pid in sorted(used_pids):
        if named.get(pid, 0) != 1:
            problems.append(
                f"pid {pid}: expected exactly one process_name "
                f"metadata row, saw {named.get(pid, 0)}")
    for (cat, aid), n in async_open.items():
        if n:
            problems.append(f"async id {aid} ({cat}): {n} unclosed "
                            "begin event(s)")
    return problems
