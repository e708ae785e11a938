"""Collective ledger: an issue-time registry and its join against the
card's trace — the port of ``tpu_p2p/obs/ledger.py``.

The reference program prints achieved bandwidth because it *is* the
workload; a training step's collectives are issued by library code and
measured by nobody. The ledger closes that gap in two halves.

**Recording.** :mod:`tpu_p2p_torch.parallel.collectives` and
:mod:`tpu_p2p_torch.parallel.fsdp` call :func:`record_issue` where they
issue a collective: kind, mesh axis, participants, the local operand's
bytes (shape × itemsize, never data), the edges of a permute and a
repetition ``count``. With no ledger active :func:`record_issue` is one
truthiness check.

The reference records when JAX *traces* a program, once per compile,
and the port keeps that rule although it runs eagerly, so the two
ledgers of one workload hold the same entries:

- a built callable is a **program** (:func:`program`): its first call
  records, every later call runs :func:`muted` (the reference's warm,
  already-compiled program records nothing; a program first called
  before recording began never records);
- a ``k``-hop chain records once with ``count=k``;
- a Python loop that stands for the reference's ``lax.scan`` (the tick
  loops of the pipelines) records each ship site once: a
  :class:`ScanBody` mutes a site after its first pass;
- an autograd backward does not record (the reference's transposes are
  not ledger-recorded wrappers);
- the rank threads of a :class:`~tpu_p2p_torch.parallel.runtime.
  LocalMesh` run one per-rank body: only rank 0's thread records, as
  ``shard_map`` traces its body once.

**Joining.** :func:`join_trace` matches ledger entries against the
device events of one ``torch.profiler`` window on this rank's card
(:func:`tpu_p2p_torch.utils.profiling.device_collective_intervals`).
Per kind, entries are expanded by ``count`` in issue order and events
matched cyclically in time order: event ``i`` joins entry ``i mod
len(entries)`` — robust to a window holding several executions of a
program and to a recorded-once loop that runs many times. A kind whose
event count is not a whole multiple of its entries is flagged
``ragged`` and joined anyway. NCCL's all-to-all is grouped send/recv:
``all_to_all_single`` launches the same ``SendRecv`` kernels a permute
does, so the two kinds share one event pool, matched against the
``ppermute`` and ``all_to_all`` entries together, in issue order.

That cyclic rule cannot place the events of a site that issues more
often than it records (a recorded-once tick loop ships every tick, beside
the MoE's all-to-alls in one pool). So every issue site, muted or not,
also labels its launches while a profiler runs (:func:`issue`): a
``record_function`` range named by the entry's signature
(:data:`ISSUE_TAG`, :meth:`CollectiveIssue.signature`) around them. A
device event whose launch lies inside such ranges on its host thread
carries their labels (:func:`~tpu_p2p_torch.utils.profiling.
labelled_collective_intervals`; the launch's correlation id ties the
two), and the join matches it within the entries of the innermost label
of its own pool; only unlabelled events (a launch outside every issue
range, as an autograd backward's, or a trace without labels) fall back
to the cyclic pool.

Each process sees only its own card's track: every rank joins its own
events, and the link matrix is gathered to rank 0 (each rank gives the
row of the links it sends on). Ranks that share a card have no NCCL:
their library collectives run on the host group, leave no device event
and are reported as host-only.

Achieved bandwidth is busbw-style (:func:`wire_bytes`); unmeasured links
print ``--``, never ``0.00``.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CollectiveIssue",
    "CollectiveLedger",
    "ISSUE_TAG",
    "TraceJoin",
    "KINDS",
    "active",
    "recording",
    "record_issue",
    "issue",
    "muted",
    "program",
    "ScanBody",
    "wire_bytes",
    "tensor_bytes",
    "kind_of_event",
    "join_trace",
    "capture_workloads",
    "live_capture",
    "print_report",
]

# Ledger kinds → a substring of the device event names they land as, in
# order (the first match wins). ``kv_migrate`` is a workload kind whose
# bytes move over a permute transport (see _match_kind); ``dma`` is the
# hand-written peer-push kernels, first so a peer-push hop never files
# under a library kind; the rest are NCCL's kernels (lower-cased
# ``ncclDevKernel_SendRecv``, ``..._AllGather_...`` and so on).
KINDS = (
    ("kv_migrate", "kv_migrate"),
    ("dma", "dma_permute_kernel"),
    ("dma", "dma_ship_"),
    ("ppermute", "sendrecv"),
    ("all_gather", "allgather"),
    ("reduce_scatter", "reducescatter"),
    ("all_to_all", "alltoall"),
    ("all_reduce", "allreduce"),
)
_KIND_NAMES = ("kv_migrate", "dma", "ppermute", "all_gather",
               "reduce_scatter", "all_to_all", "all_reduce")
_KV_MIGRATE = "kv_migrate"
# The ``record_function`` name prefix of an issue's label on the
# profiler's host track (module docstring).
ISSUE_TAG = "tp_p2p_issue"
# NCCL runs an all-to-all as grouped send/recv: one event pool for both.
_SENDRECV_POOL = ("ppermute", "all_to_all")


def _match_kind(issue: "CollectiveIssue") -> str:
    """The device-event pool an entry's events land in: the transport a
    ``kv_migrate`` entry names in its label (``kv_migrate:pallas_dma`` →
    the peer-push kernels, else the library's send/recv), and NCCL's
    send/recv pool for an all-to-all."""
    kind = issue.kind
    if kind == _KV_MIGRATE:
        kind = "dma" if "pallas" in issue.label else "ppermute"
    return "ppermute" if kind in _SENDRECV_POOL else kind


def non_dma_kinds():
    """Every kind but the peer-push transport: the library side of the
    head-to-head split, one definition for the printed matrix and the
    ``MULTICHIP`` artifact."""
    return tuple(k for k in _KIND_NAMES if k != "dma")


def kind_of_event(name: str) -> Optional[str]:
    """One device event name → a ledger kind (None outside the
    vocabulary)."""
    low = name.lower()
    for kind, sub in KINDS:
        if sub in low:
            return kind
    return None


def wire_bytes(kind: str, axis_size: int, payload_bytes: int) -> int:
    """Bytes crossing links per participant, busbw convention.

    ``payload_bytes`` is the local bytes of the collective's input
    operand (a shard for all-gather, the full local buffer for the
    reductions, the per-link buffer for ppermute).
    """
    n = int(axis_size)
    if kind in ("ppermute", "dma", "kv_migrate"):
        # Per directed link: a peer-push hop ships the same bytes over
        # the same edge as its library twin, so the two transports
        # price identically. kv_migrate is a ppermute-family ship (the
        # serving KV-page migration) and prices the same way.
        return int(payload_bytes)
    if kind == "all_gather":
        return (n - 1) * int(payload_bytes)
    if kind == "reduce_scatter":
        return (n - 1) * int(payload_bytes) // max(n, 1)
    if kind == "all_to_all":
        return (n - 1) * int(payload_bytes) // max(n, 1)
    if kind == "all_reduce":
        return 2 * (n - 1) * int(payload_bytes) // max(n, 1)
    raise ValueError(f"unknown collective kind {kind!r}")


def tensor_bytes(x) -> int:
    """Payload bytes of a tensor from its shape and dtype alone."""
    return int(x.numel()) * int(x.element_size())


@dataclass(frozen=True)
class CollectiveIssue:
    """One recorded collective (possibly a chained repetition)."""

    kind: str
    axis: str
    participants: Tuple[int, ...]  # axis-local rank ids
    payload_bytes: int  # local input-operand bytes
    wire_bytes: int  # bytes crossing links per participant (busbw)
    count: int = 1  # chained repetitions
    edges: Optional[Tuple[Tuple[int, int], ...]] = None  # permutes only
    label: str = ""

    @property
    def signature(self) -> str:
        """The issue's label on the profiler's host track: equal for
        every issue of one site (the recorded one and its muted
        repeats), different for sites that differ in kind, label, edges
        or bytes."""
        edges = ",".join(f"{s}>{d}" for s, d in self.edges or ())
        return (f"{ISSUE_TAG}|{self.kind}|{self.axis}|{self.label}|"
                f"{edges}|{self.payload_bytes}")


class CollectiveLedger:
    """Append-only registry of :class:`CollectiveIssue` entries."""

    def __init__(self) -> None:
        self.issues: List[CollectiveIssue] = []

    def clear(self) -> None:
        self.issues.clear()

    def __len__(self) -> int:
        return len(self.issues)

    def expanded(self) -> List[CollectiveIssue]:
        """Issues flattened by ``count``, in issue order — the unit the
        join matches device events against."""
        out: List[CollectiveIssue] = []
        for it in self.issues:
            out.extend([it] * it.count)
        return out

    def totals(self) -> Dict[Tuple[str, str], Dict[str, int]]:
        """→ ``{(kind, axis): {"issues", "payload_bytes",
        "wire_bytes"}}``; byte totals count every chained repetition."""
        out: Dict[Tuple[str, str], Dict[str, int]] = {}
        for it in self.issues:
            d = out.setdefault((it.kind, it.axis), {
                "issues": 0, "payload_bytes": 0, "wire_bytes": 0,
            })
            d["issues"] += it.count
            d["payload_bytes"] += it.payload_bytes * it.count
            d["wire_bytes"] += it.wire_bytes * it.count
        return out


def totals_record(ledger: CollectiveLedger) -> dict:
    """One JSON-ready ``{"obs": "serve_ledger"}`` totals row for an
    ``--obs-jsonl`` stream: the serving engine's transport receipt."""
    return {
        "obs": "serve_ledger",
        "issues": len(ledger),
        "totals": {
            f"{kind}/{axis}": dict(tot)
            for (kind, axis), tot in sorted(ledger.totals().items())
        },
    }


# A stack, not a slot: nested recording() scopes each see the issues
# recorded inside them.
_STACK: List[CollectiveLedger] = []
# Muting is per thread (a LocalMesh rank thread other than rank 0 mutes
# itself for its whole body).
_LOCAL = threading.local()


def _muted_depth() -> int:
    return getattr(_LOCAL, "muted", 0)


def active() -> Optional[CollectiveLedger]:
    """The innermost recording ledger, or None when recording is off."""
    return _STACK[-1] if _STACK else None


@contextmanager
def recording(ledger: Optional[CollectiveLedger] = None):
    """Enable issue recording for the dynamic extent of the block."""
    led = ledger if ledger is not None else CollectiveLedger()
    _STACK.append(led)
    try:
        yield led
    finally:
        _STACK.remove(led)


@contextmanager
def muted(on: bool = True):
    """Record nothing from this thread inside the block (``on=False``:
    a no-op): the calls of a program after its first, a loop body after
    its first pass."""
    if not on:
        yield
        return
    _LOCAL.muted = _muted_depth() + 1
    try:
        yield
    finally:
        _LOCAL.muted -= 1


def _entry(kind: str, axis, *, nbytes: int, axis_size: int,
           edges: Optional[Sequence[Tuple[int, int]]] = None,
           count: int = 1, label: str = "") -> CollectiveIssue:
    return CollectiveIssue(
        kind=kind, axis=str(axis),
        participants=tuple(range(int(axis_size))),
        payload_bytes=int(nbytes),
        wire_bytes=wire_bytes(kind, axis_size, nbytes),
        count=int(count),
        edges=(tuple((int(s), int(d)) for s, d in edges)
               if edges is not None else None),
        label=label,
    )


def record_issue(kind: str, axis, *, nbytes: int, axis_size: int,
                 edges: Optional[Sequence[Tuple[int, int]]] = None,
                 count: int = 1, label: str = "") -> None:
    """Record one issued collective into every active ledger (a no-op
    costing one check when nothing records, or when muted). ``nbytes``
    comes from the operand's shape (:func:`tensor_bytes`), never from
    data."""
    if not _STACK or _muted_depth():
        return
    entry = _entry(kind, axis, nbytes=nbytes, axis_size=axis_size,
                   edges=edges, count=count, label=label)
    for led in _STACK:
        led.issues.append(entry)


@contextmanager
def issue(kind: str, axis, *, nbytes: int, axis_size: int,
          edges: Optional[Sequence[Tuple[int, int]]] = None,
          count: int = 1, label: str = ""):
    """:func:`record_issue` around the collective's launches: while a
    profiler runs (and a ledger is active, muted or not), the body runs
    inside a ``record_function`` range named by the entry's signature,
    the label the join reads off each launch inside it (module
    docstring). Otherwise the body just runs."""
    if not _STACK:
        yield
        return
    record_issue(kind, axis, nbytes=nbytes, axis_size=axis_size,
                 edges=edges, count=count, label=label)
    if not _profiling():
        yield
        return
    import torch

    entry = _entry(kind, axis, nbytes=nbytes, axis_size=axis_size,
                   edges=edges, count=count, label=label)
    with torch.profiler.record_function(entry.signature):
        yield


def _profiling() -> bool:
    """Whether a ``torch.profiler`` window is recording."""
    import torch

    return bool(torch._C._autograd._profiler_enabled())


class _Program:
    """A built callable that records like a compiled program: its first
    call records, every later one runs muted."""

    def __init__(self, fn) -> None:
        self.fn = fn
        self.called = False

    def __call__(self, *args, **kwargs):
        if self.called:
            with muted():
                return self.fn(*args, **kwargs)
        self.called = True
        return self.fn(*args, **kwargs)


def program(fn):
    """Wrap a built callable (a chain, a layer, a step) so the ledger
    sees it as the reference sees a jitted program: the first call
    records its collectives, later calls record nothing."""
    return fn if isinstance(fn, _Program) else _Program(fn)


class ScanBody:
    """A Python loop standing for the reference's ``lax.scan``, whose
    body traces once: :meth:`site` records a named site's collectives on
    its first pass and mutes it afterwards."""

    def __init__(self) -> None:
        self._seen: set = set()

    def site(self, name: str):
        first = name not in self._seen
        self._seen.add(name)
        return muted(not first)


# ------------------------------------------------------------- join


@dataclass(frozen=True)
class JoinedEvent:
    """One device collective event matched to its ledger entry."""

    issue: CollectiveIssue
    t0: float  # seconds on the trace's clock
    t1: float
    event_name: str

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def achieved_gbps(self) -> float:
        s = self.seconds
        return (self.issue.wire_bytes * 8 / s / 1e9) if s > 0 else math.nan


@dataclass
class TraceJoin:
    """Result of matching a ledger against one device-trace window."""

    joined: List[JoinedEvent] = field(default_factory=list)
    # kinds on the device track with no ledger entry to join: {kind:
    # {"events": n, "seconds": total}} — surfaced, never dropped.
    unmatched: Dict[str, Dict[str, float]] = field(default_factory=dict)
    unmatched_intervals: List[Tuple[str, float, float]] = \
        field(default_factory=list)
    # pools whose event count was not a whole multiple of their entries
    ragged: Tuple[str, ...] = ()
    no_device_track: bool = False

    def per_kind(self) -> Dict[str, Dict[str, float]]:
        """→ ``{kind: {"events", "wire_bytes", "seconds",
        "achieved_gbps"}}`` over the joined events."""
        return self._aggregate(lambda j: j.issue.kind)

    def per_axis(self) -> Dict[str, Dict[str, float]]:
        """Same aggregation keyed by mesh axis."""
        return self._aggregate(lambda j: j.issue.axis)

    def per_kind_axis(self) -> Dict[Tuple[str, str], Dict[str, float]]:
        """Same aggregation keyed by ``(kind, axis)``, the report
        table's key."""
        return self._aggregate(lambda j: (j.issue.kind, j.issue.axis))

    def _aggregate(self, key_fn) -> Dict:
        out: Dict = {}
        for j in self.joined:
            d = out.setdefault(key_fn(j), {
                "events": 0, "wire_bytes": 0, "seconds": 0.0,
            })
            d["events"] += 1
            d["wire_bytes"] += j.issue.wire_bytes
            d["seconds"] += j.seconds
        for d in out.values():
            d["achieved_gbps"] = (
                d["wire_bytes"] * 8 / d["seconds"] / 1e9
                if d["seconds"] > 0 else None
            )
        return out

    def link_matrix(self, n: Optional[int] = None,
                    kinds: Optional[Sequence[str]] = None,
                    src: Optional[int] = None) -> List[List[float]]:
        """Per-link achieved Gbps from the edge-carrying joined events:
        cell ``[s][d]`` = total bytes over total device seconds on that
        directed link, NaN where no ledger traffic crossed it. ``kinds``
        restricts it to one transport; ``src`` keeps the links one rank
        sends on (its own card's events time only those)."""
        edged = [j for j in self.joined if j.issue.edges
                 and (kinds is None or j.issue.kind in kinds)]
        if n is None:
            n = 1 + max(
                (max(max(e) for e in j.issue.edges) for j in edged),
                default=-1,
            )
        secs: Dict[Tuple[int, int], float] = {}
        bts: Dict[Tuple[int, int], int] = {}
        for j in edged:
            for s, d in j.issue.edges:
                if s == d or (src is not None and s != src):
                    continue
                # One event covers all its edges at once, so each edge
                # sees the full payload over the full event span.
                bts[(s, d)] = bts.get((s, d), 0) + j.issue.payload_bytes
                secs[(s, d)] = secs.get((s, d), 0.0) + j.seconds
        m = [[math.nan] * n for _ in range(n)]
        for (s, d), b in bts.items():
            t = secs[(s, d)]
            if s < n and d < n:
                m[s][d] = (b * 8 / t / 1e9) if t > 0 else math.nan
        return m


def join_trace(ledger: CollectiveLedger, trace, window=None) -> TraceJoin:
    """Match ``ledger`` against the device collective events of one
    ``torch.profiler`` window (``trace``: a Chrome-trace path, its event
    list, or a list of ``(name, t0, t1)`` / ``(name, t0, t1, labels)``
    intervals as :func:`~tpu_p2p_torch.utils.profiling.
    labelled_collective_intervals` gives them, ``labels`` the issue
    ranges around the launch, innermost last) → :class:`TraceJoin`;
    ``no_device_track=True`` (and an empty join) when the window holds no
    device event (a CPU world).

    A labelled event joins the entries of its innermost label that names
    an entry of its own pool, cyclically in time order among them; an
    unlabelled one (or one whose labels name no entry of its pool) joins
    its kind's pool cyclically, as before the labels existed. A
    signature or pool whose event count is not a whole multiple of its
    entries flags its kind ``ragged``."""
    from tpu_p2p_torch.utils.profiling import labelled_collective_intervals

    intervals = (trace if isinstance(trace, list) and trace
                 and isinstance(trace[0], tuple)
                 else labelled_collective_intervals(trace, window=window))
    if intervals is None:
        return TraceJoin(no_device_track=True)
    by_kind_issues: Dict[str, List[CollectiveIssue]] = {}
    by_sig: Dict[Tuple[str, str], List[CollectiveIssue]] = {}
    for it in ledger.expanded():
        pool = _match_kind(it)
        by_kind_issues.setdefault(pool, []).append(it)
        by_sig.setdefault((pool, it.signature), []).append(it)
    # (pool, signature or None) → that group's events, in time order
    groups: Dict[Tuple[str, Optional[str]],
                 List[Tuple[str, float, float]]] = {}
    unmatched: Dict[str, Dict[str, float]] = {}
    unmatched_iv: List[Tuple[str, float, float]] = []
    for iv in intervals:
        name, t0, t1 = iv[:3]
        labels = iv[3] if len(iv) > 3 else None
        if isinstance(labels, str):
            labels = (labels,)
        kind = kind_of_event(name)
        if kind is None:
            d = unmatched.setdefault("other", {"events": 0, "seconds": 0.0})
            d["events"] += 1
            d["seconds"] += t1 - t0
            unmatched_iv.append((name, t0, t1))
            continue
        if kind in _SENDRECV_POOL:
            kind = "ppermute"
        label = next((lab for lab in reversed(labels or ())
                      if (kind, lab) in by_sig), None)
        groups.setdefault((kind, label), []).append((name, t0, t1))
    joined: List[JoinedEvent] = []
    ragged: List[str] = []
    for (kind, label), evs in groups.items():
        issues = (by_sig[(kind, label)] if label is not None
                  else by_kind_issues.get(kind))
        if not issues:
            d = unmatched.setdefault(kind, {"events": 0, "seconds": 0.0})
            d["events"] += len(evs)
            d["seconds"] += sum(t1 - t0 for _, t0, t1 in evs)
            unmatched_iv.extend(evs)
            continue
        if len(evs) % len(issues) and kind not in ragged:
            ragged.append(kind)
        for i, (name, t0, t1) in enumerate(evs):
            joined.append(JoinedEvent(
                issue=issues[i % len(issues)], t0=t0, t1=t1,
                event_name=name,
            ))
    joined.sort(key=lambda j: j.t0)
    unmatched_iv.sort(key=lambda e: e[1])
    return TraceJoin(joined=joined, unmatched=unmatched,
                     ragged=tuple(sorted(ragged)),
                     unmatched_intervals=unmatched_iv)


def merged_link_matrix(rows: Sequence[List[List[float]]]
                       ) -> List[List[float]]:
    """Each rank's :meth:`TraceJoin.link_matrix` (``src=`` its rank)
    merged into one matrix: a measured cell wins over NaN."""
    n = len(rows[0]) if rows else 0
    out = [[math.nan] * n for _ in range(n)]
    for m in rows:
        for i in range(n):
            for j in range(n):
                v = m[i][j]
                if v is not None and not math.isnan(v):
                    out[i][j] = v
    return out


# ------------------------------------------------- live capture/report


@dataclass
class LiveCapture:
    """What :func:`live_capture` leaves on each rank: the ledger, this
    rank's join, and (on every rank) the link matrices merged over the
    world, or None without a device track."""

    ledger: CollectiveLedger
    join: TraceJoin
    n: int
    matrix: Optional[List[List[float]]] = None
    matrix_dma: Optional[List[List[float]]] = None
    host_only: bool = False  # ranks share a card: library kinds ran on
    # the host group


def capture_workloads(rt, msg_bytes: int = 4 * 1024 * 1024,
                      count: int = 8):
    """The reference's live-capture workloads on the world of runtime
    ``rt`` (every rank builds them, in one order) → ``{name: run}``, each
    ``run()`` one call of a ledger program: a shift-by-1 ``ppermute``
    ring and a slice-own-chunk all-gather chain of ``count`` hops
    (``ring``, ``all_gather``); the same ring over the peer-push kernel
    at most 64 KiB a hop (``dma``); a tiny MoE layer over an ``ep`` axis
    under both ``ep_overlap`` modes (``moe_none``, ``moe_ring``); a tiny
    GPipe forward over a ``pp`` axis under both ``pp_overlap`` modes
    (``gpipe_none``, ``gpipe_wave``); one SGD step of the tick executor
    under the fused 1F1B and the zero-bubble programs (``sched_1f1b``,
    ``sched_zb``). Fixed tiny shapes: the totals do not depend on
    ``msg_bytes`` but for the rings."""
    import torch

    from tpu_p2p_torch.models import moe as M
    from tpu_p2p_torch.models import pipeline as PL
    from tpu_p2p_torch.models import schedule as SCH
    from tpu_p2p_torch.parallel import collectives as C

    mesh = rt.mesh
    axis, n, dev = mesh.axis_names[0], mesh.size, mesh.device
    cache = C.CollectiveCache()
    payload = C.make_payload(mesh, msg_bytes)
    dma_payload = C.make_payload(mesh, min(msg_bytes, 64 * 1024))
    ring = cache.permute_chain(mesh, axis, C.ring_edges(n), count)
    ag = cache.ag_chain(mesh, axis, count)
    dma_ring = cache.dma_permute_chain(mesh, axis, C.ring_edges(n), count)
    runs = {"ring": lambda: ring(payload),
            "all_gather": lambda: ag(payload),
            "dma": lambda: dma_ring(dma_payload)}
    ep = rt.axis_mesh((n,), ("ep",)).line("ep")
    moe_x = torch.zeros((8, 16), dtype=torch.float32, device=dev)
    for mode in ("none", "ring"):
        cfg = M.MoEConfig(d_model=16, d_ff=32, num_experts=n,
                          capacity_factor=float(n), ep_overlap=mode)
        full = M.init_moe_params(cfg)
        params = {"router": full["router"].to(dev),
                  "w1": full["w1"][ep.index:ep.index + 1].to(dev),
                  "w2": full["w2"][ep.index:ep.index + 1].to(dev)}
        layer = program(lambda p, x, cfg=cfg: M.moe_layer_local(p, x, cfg,
                                                                ep))
        runs[f"moe_{mode}"] = (lambda layer=layer, params=params:
                               layer(params, moe_x))
    pp_mesh = rt.axis_mesh((n,), ("pp",))
    pp_cfg = PL.PipelineConfig(d_model=8, d_ff=16, stages=n,
                               microbatches=2)
    pp_params = PL.place_pipeline_params(
        PL.init_pipeline_params(pp_cfg), pp_mesh, device=dev)
    pp_x = torch.zeros((2, 4, 8), dtype=torch.float32, device=dev)
    for mode in ("none", "wave"):
        fwd = PL.make_pipeline_forward(pp_mesh, pp_cfg, pp_overlap=mode,
                                       pp_chunks=2)
        runs[f"gpipe_{mode}"] = lambda fwd=fwd: fwd(pp_params, pp_x)
    sched_t = torch.ones_like(pp_x)
    for prog in (SCH.compile_1f1b(2, n), SCH.compile_zb(2, n)):
        stp = SCH.make_tick_train_step(pp_mesh, pp_cfg, prog)
        runs[f"sched_{prog.name}"] = (
            lambda stp=stp: stp({k: v.clone() for k, v in pp_params.items()},
                                pp_x, sched_t))
    return runs


def live_capture(rt, msg_bytes: int = 4 * 1024 * 1024,
                 count: int = 8) -> LiveCapture:
    """Run :func:`capture_workloads` on the world of runtime ``rt`` under
    a fresh ledger (the recorded warm-up: every program's first call),
    then once more in a ``torch.profiler`` window, which records
    nothing, as the reference's compiled second pass; join this rank's
    window, and merge the link matrices over the world. Ranks that share
    a card run the library collectives on the host group. Every rank
    calls this."""
    import tempfile

    import torch

    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.utils.profiling import profile_window

    mesh = rt.mesh
    n = mesh.size
    led = CollectiveLedger()
    if n < 2:
        return LiveCapture(led, TraceJoin(), n)
    card = mesh.device.type == "cuda"
    host_only = card and mesh.device_group is None
    with C.host_staged(host_only):
        runs = capture_workloads(rt, msg_bytes, count)

        def run_all():
            with torch.no_grad():
                for name, run in runs.items():
                    if name.startswith("sched"):
                        with torch.enable_grad():
                            run()
                    else:
                        run()
            mesh.barrier()

        with recording(led):
            run_all()
        if card:
            # The programs are warm, so a scratch ledger records nothing
            # new; its issue ranges label the window's launches.
            with tempfile.TemporaryDirectory(prefix="obs_cap_") as td:
                with recording(CollectiveLedger()):
                    path = profile_window(run_all, td, host=True)
                join = join_trace(led, path)
        else:
            run_all()
            join = TraceJoin(no_device_track=True)
    out = LiveCapture(led, join, n, host_only=host_only)
    if not join.no_device_track:
        has_dma = any(j.issue.kind == "dma" for j in join.joined)
        lib = join.link_matrix(n, kinds=non_dma_kinds() if has_dma
                               else None, src=mesh.index)
        dma = join.link_matrix(n, kinds=("dma",), src=mesh.index)
        rows = rt.gather((lib, dma if has_dma else None))
        out.matrix = merged_link_matrix([r[0] for r in rows])
        if has_dma:
            out.matrix_dma = merged_link_matrix([r[1] for r in rows])
    return out


def print_report(ledger: CollectiveLedger, join: TraceJoin, n: int,
                 stream=None, title: str = "Ledger-Joined",
                 matrix=None, matrix_dma=None,
                 host_only: bool = False) -> None:
    """Human-readable obs report: the ledger totals table, per-kind
    achieved bandwidth, and — with a device track — the per-link N×N
    matrix in the workloads' format (``matrix`` / ``matrix_dma``: the
    world's merged matrices; default this join's own). ``host_only``:
    the ranks share a card, so the library kinds ran on the host group
    and their rows carry no device event."""
    import sys

    from tpu_p2p_torch.utils.report import render_matrix

    out = stream if stream is not None else sys.stdout
    per_ka = join.per_kind_axis()
    out.write("# collective ledger\n")
    out.write("# kind            axis  issues   payload_B      wire_B"
              "  events  achieved_gbps\n")
    for (kind, axis), tot in sorted(ledger.totals().items()):
        agg = per_ka.get((kind, axis), {})
        gbps = agg.get("achieved_gbps")
        out.write(
            "#   %-13s %4s  %6d  %10d  %10d  %6d  %13s\n" % (
                kind, axis, tot["issues"], tot["payload_bytes"],
                tot["wire_bytes"], agg.get("events", 0),
                ("%.2f" % gbps) if gbps is not None else "n/a",
            )
        )
    for kind, d in sorted(join.unmatched.items()):
        out.write("#   unmatched %-10s events %d (no ledger entry)\n"
                  % (kind, d["events"]))
    if join.ragged:
        out.write("#   ragged kinds (event count not a multiple of "
                  f"issues): {', '.join(join.ragged)}\n")
    if join.no_device_track:
        out.write(
            "# no device track in trace (platform records host events "
            "only) — achieved-bandwidth matrix unavailable\n"
        )
        out.flush()
        return
    if host_only:
        out.write("# host-only: the ranks share one card, so the library "
                  "collectives ran on the host group (gloo) and left no "
                  "device event (events 0, n/a)\n")
    has_dma = matrix_dma is not None or any(
        j.issue.kind == "dma" for j in join.joined)
    if matrix is None:
        matrix = join.link_matrix(n, kinds=non_dma_kinds() if has_dma
                                  else None)
    rep = render_matrix(
        matrix, f"Evaluating the {title} GPU P2P Achieved Bandwidth "
        "(Gbps)", stream=out)
    rep.print_summary("ledger per-link achieved")
    if has_dma:
        if matrix_dma is None:
            matrix_dma = join.link_matrix(n, kinds=("dma",))
        rep_dma = render_matrix(
            matrix_dma, f"Evaluating the {title} Pallas-DMA P2P Achieved "
            "Bandwidth (Gbps)", stream=out)
        rep_dma.print_summary("ledger per-link achieved (pallas_dma)")
        if host_only:
            out.write("# time-sliced: the peer-push hops ran between "
                      "processes of one card — on-card copies, not link "
                      "numbers\n")
    out.flush()
