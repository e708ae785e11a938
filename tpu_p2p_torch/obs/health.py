"""Fleet health engine: detectors, verdicts, and the ``obs watch`` /
``obs smoke`` CLIs — the port of ``tpu_p2p/obs/health.py``.

The paper's N×N per-link bandwidth matrix is a one-shot diagnostic; this
module is the always-on monitor that acts on it. Three detectors, each
fed by what the obs layer already produces:

- **Degraded link** (:func:`detect_degraded_links`): directed links whose
  achieved Gbps sits below a fraction of the fleet median — a ledger
  join's link matrix, :func:`probe_link_matrix` (host-timed per-edge
  chains) anywhere, and the ``MULTICHIP_r*.json`` history
  (:func:`tpu_p2p_torch.obs.regress.load_multichip_history`) as a
  per-link baseline.
- **Straggler** (:class:`StragglerDetector`): rolling median/MAD outlier
  scoring over the step timeline's wall times; fires on ``consecutive``
  outlier steps.
- **Lost host** (:class:`HealthMonitor` heartbeats): a host missing
  ``lost_after`` consecutive step heartbeats is declared lost — the
  verdict ``train --heal`` acts on.

Every verdict is a :class:`HealthVerdict` emitted as an ``{"obs":
"health"}`` record into the obs stream, so ``python -m tpu_p2p_torch obs
watch`` can tail one file and see everything. :func:`run_smoke` (``obs
smoke``) grades the detectors on injected faults
(:mod:`tpu_p2p_torch.obs.faults`) on a world of ranks.

In a world of processes the lost-host verdict comes from the plan's
heartbeats, the same on every rank, so every rank raises at one step;
straggler verdicts read wall time, differ between ranks, are emitted by
the first rank only and never steer control flow.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "HealthConfig",
    "HealthVerdict",
    "HostLostError",
    "fleet_median",
    "detect_degraded_links",
    "attribute_host",
    "StragglerDetector",
    "HealthMonitor",
    "probe_link_matrix",
    "run_smoke",
    "watch_main",
    "smoke_main",
]


@dataclass(frozen=True)
class HealthConfig:
    """Detector thresholds (the reference's defaults).

    ``link_frac_of_median``: a link is degraded below this fraction of
    the fleet median over measured off-diagonal links.
    ``baseline_frac``: …or below this fraction of its own historical
    baseline. ``straggler_*``: a step is an outlier when its wall time
    exceeds ``median + z * max(1.4826·MAD, rel_floor·median)`` of the
    preceding window; ``consecutive`` outliers make a verdict.
    ``lost_after``: consecutive missed heartbeats before a host is lost.
    """

    link_frac_of_median: float = 0.5
    baseline_frac: float = 0.5
    straggler_window: int = 16
    straggler_z: float = 4.0
    straggler_min_samples: int = 4
    straggler_consecutive: int = 2
    straggler_rel_floor: float = 0.05
    lost_after: int = 2

    def __post_init__(self) -> None:
        if not 0 < self.link_frac_of_median < 1:
            raise ValueError(
                f"link_frac_of_median must be in (0, 1), got "
                f"{self.link_frac_of_median}")
        if not 0 < self.baseline_frac < 1:
            raise ValueError(
                f"baseline_frac must be in (0, 1), got "
                f"{self.baseline_frac}")
        if self.straggler_consecutive < 1 or self.lost_after < 1:
            raise ValueError(
                "straggler_consecutive and lost_after must be >= 1")


@dataclass(frozen=True)
class HealthVerdict:
    """One detector verdict; ``to_record`` is the obs-jsonl shape."""

    kind: str  # "degraded_link" | "straggler" | "lost_host"
    step: int
    detail: dict = field(default_factory=dict)

    def to_record(self) -> dict:
        return {"obs": "health", "verdict": self.kind,
                "step": int(self.step), **self.detail}

    def describe(self) -> str:
        extra = " ".join(f"{k}={v}" for k, v in self.detail.items()
                         if not isinstance(v, (list, dict)))
        return f"step {self.step} {self.kind}: {extra}".rstrip()


class HostLostError(RuntimeError):
    """Raised by the training loop (under ``heal=True``) when the health
    monitor declares a host lost: the signal
    ``train.run_training_with_heal`` turns into a reshard and resume on
    the surviving ranks."""

    def __init__(self, host: int, step: int) -> None:
        super().__init__(
            f"host {host} declared lost at step {step} "
            "(missed heartbeats)")
        self.host = int(host)
        self.step = int(step)


# ------------------------------------------------------ link detector


def _finite_offdiag(matrix) -> List[Tuple[int, int, float]]:
    out = []
    for i, row in enumerate(matrix):
        for j, v in enumerate(row):
            if i != j and isinstance(v, (int, float)) \
                    and v == v and not math.isinf(v):
                out.append((i, j, float(v)))
    return out


def fleet_median(matrix) -> Optional[float]:
    """Median achieved Gbps over measured (finite, off-diagonal) links;
    None when nothing was measured. Unmeasured links (NaN or None) never
    vote: a dead link reads as slow, an unmeasured one as absent."""
    cells = [v for _, _, v in _finite_offdiag(matrix)]
    return float(statistics.median(cells)) if cells else None


def detect_degraded_links(matrix, *, frac: float = 0.5,
                          baseline=None, baseline_frac: float = 0.5
                          ) -> List[dict]:
    """Flag links below ``frac``× the fleet median (and/or below
    ``baseline_frac``× their own historical baseline when a per-link
    ``baseline`` matrix is given) → one dict a degraded link: ``src``,
    ``dst``, ``gbps``, the ``fleet_median`` and ``floor`` it fell under,
    and ``baseline`` / ``baseline_floor`` when history judged it."""
    med = fleet_median(matrix)
    flags: List[dict] = []
    for src, dst, v in _finite_offdiag(matrix):
        reasons = []
        rec = {"src": src, "dst": dst, "gbps": round(v, 3),
               "fleet_median": round(med, 3) if med is not None else None}
        if med is not None and v < frac * med:
            rec["floor"] = round(frac * med, 3)
            reasons.append("fleet_median")
        if baseline is not None:
            try:
                b = baseline[src][dst]
            except (IndexError, TypeError):
                b = None
            if isinstance(b, (int, float)) and b == b and b > 0:
                if v < baseline_frac * b:
                    rec["baseline"] = round(float(b), 3)
                    rec["baseline_floor"] = round(baseline_frac * b, 3)
                    reasons.append("baseline")
        if reasons:
            rec["reasons"] = reasons
            flags.append(rec)
    return flags


def attribute_host(matrix, *, frac: float = 0.6) -> Optional[dict]:
    """The host whose links are collectively slow: the mean over its row
    and column separates a straggling host from one bad cable → the
    worst host's ``{"host", "mean_gbps", "fleet_median"}`` when its mean
    sits below ``frac``× the fleet median, else None."""
    cells = _finite_offdiag(matrix)
    med = fleet_median(matrix)
    if not cells or med is None:
        return None
    per_host: Dict[int, List[float]] = {}
    for src, dst, v in cells:
        per_host.setdefault(src, []).append(v)
        per_host.setdefault(dst, []).append(v)
    means = {h: sum(vs) / len(vs) for h, vs in per_host.items()}
    worst = min(means, key=means.get)
    if means[worst] < frac * med:
        return {"host": worst, "mean_gbps": round(means[worst], 3),
                "fleet_median": round(med, 3)}
    return None


# -------------------------------------------------- straggler detector


class StragglerDetector:
    """Rolling median/MAD outlier scoring over per-step wall times.

    Each step is scored against the *preceding* window, then appended. A
    step is an outlier when ``step_ms > median + z * max(1.4826·MAD,
    rel_floor·median)``; ``consecutive`` outliers fire ONE verdict,
    suppressed until a healthy step resets the streak.
    """

    def __init__(self, *, window: int = 16, z: float = 4.0,
                 min_samples: int = 4, consecutive: int = 2,
                 rel_floor: float = 0.05) -> None:
        self._win: deque = deque(maxlen=int(window))
        self._z = float(z)
        self._min = int(min_samples)
        self._consecutive = int(consecutive)
        self._rel_floor = float(rel_floor)
        self._streak = 0
        self._fired = False

    @classmethod
    def from_config(cls, cfg: HealthConfig) -> "StragglerDetector":
        return cls(window=cfg.straggler_window, z=cfg.straggler_z,
                   min_samples=cfg.straggler_min_samples,
                   consecutive=cfg.straggler_consecutive,
                   rel_floor=cfg.straggler_rel_floor)

    def observe(self, step_ms: float) -> Optional[dict]:
        """Score one step; → the incident detail dict exactly when this
        step completes a ``consecutive`` outlier streak."""
        out = None
        if len(self._win) >= self._min:
            med = float(statistics.median(self._win))
            mad = float(statistics.median(
                abs(x - med) for x in self._win))
            scale = max(1.4826 * mad, self._rel_floor * med)
            threshold = med + self._z * scale
            if step_ms > threshold:
                self._streak += 1
                if self._streak >= self._consecutive and not self._fired:
                    self._fired = True
                    out = {
                        "step_ms": round(float(step_ms), 3),
                        "window_median_ms": round(med, 3),
                        "threshold_ms": round(threshold, 3),
                        "outlier_streak": self._streak,
                    }
            else:
                self._streak = 0
                self._fired = False
        self._win.append(float(step_ms))
        return out


# ------------------------------------------------------------ monitor


class HealthMonitor:
    """The per-run control point: feed it steps (and link matrices); it
    emits :class:`HealthVerdict` records through ``emit`` and keeps them
    in ``.verdicts`` for callers that act on them (``train --heal``).

    ``n_hosts``: heartbeat universe for lost-host detection. Hosts
    heartbeat via ``alive_hosts`` on :meth:`observe_step`; a host absent
    ``cfg.lost_after`` consecutive steps is declared lost (once). With
    ``alive_hosts=None`` every host heartbeats.
    """

    def __init__(self, cfg: Optional[HealthConfig] = None,
                 emit: Optional[Callable[[dict], None]] = None,
                 n_hosts: Optional[int] = None) -> None:
        self.cfg = cfg if cfg is not None else HealthConfig()
        self._emit = emit
        self._n_hosts = int(n_hosts) if n_hosts else 0
        self._straggler = StragglerDetector.from_config(self.cfg)
        self._last_seen: Dict[int, int] = {}
        self._lost: set = set()
        self.verdicts: List[HealthVerdict] = []

    def _issue(self, kind: str, step: int, detail: dict) -> HealthVerdict:
        v = HealthVerdict(kind=kind, step=int(step), detail=detail)
        self.verdicts.append(v)
        if self._emit is not None:
            self._emit(v.to_record())
        return v

    def observe_step(self, step: int, step_ms: float,
                     alive_hosts: Optional[Sequence[int]] = None,
                     score_straggler: bool = True
                     ) -> List[HealthVerdict]:
        """One step's health pass: straggler scoring on its wall time
        and the heartbeat bookkeeping → this step's verdicts.
        ``score_straggler=False`` keeps the heartbeats but leaves the
        step's time out of the straggler statistic (the first step and
        the profiled step)."""
        out: List[HealthVerdict] = []
        if score_straggler:
            hit = self._straggler.observe(step_ms)
            if hit is not None:
                out.append(self._issue("straggler", step, hit))
        if self._n_hosts:
            alive = (range(self._n_hosts) if alive_hosts is None
                     else alive_hosts)
            for h in alive:
                self._last_seen[int(h)] = int(step)
            for h in range(self._n_hosts):
                if h in self._lost:
                    continue
                last = self._last_seen.get(h)
                missed = (int(step) - last if last is not None
                          else int(step))
                if missed >= self.cfg.lost_after:
                    self._lost.add(h)
                    out.append(self._issue("lost_host", step, {
                        "host": h, "last_seen_step": last,
                        "missed_steps": missed,
                    }))
        return out

    def observe_link_matrix(self, step: int, matrix, baseline=None
                            ) -> List[HealthVerdict]:
        """Run the link detector on one measured matrix; one verdict
        carrying every degraded link, plus the per-host attribution when
        a whole host's links sag."""
        flags = detect_degraded_links(
            matrix, frac=self.cfg.link_frac_of_median,
            baseline=baseline, baseline_frac=self.cfg.baseline_frac)
        if not flags:
            return []
        detail: dict = {"links": flags,
                        "fleet_median": flags[0]["fleet_median"]}
        host = attribute_host(matrix)
        if host is not None:
            detail["host"] = host["host"]
        return [self._issue("degraded_link", step, detail)]

    @property
    def lost_hosts(self) -> Tuple[int, ...]:
        return tuple(sorted(self._lost))


# ----------------------------------------------------------- probing


def probe_link_matrix(mesh, *, edges=None, msg_bytes: int = 1024 * 1024,
                      iters: int = 8, repeats: int = 2):
    """Host-timed per-link achieved Gbps over ``edges`` (default the
    shift-by-1 ring) of the 1-D process ``mesh``: the detector's feed
    where no device track joins. Every rank of the mesh calls it.

    One ``iters``-hop single-edge chain of the ledger-recorded library
    permute a link (:func:`~tpu_p2p_torch.parallel.collectives.
    axis_ppermute`, label ``health_probe``) under the active fault plan,
    each warmed up, then timed in ``repeats`` rounds over every link
    after a barrier, keeping a link's fastest round of the slowest
    rank's time (rounds over the links, not repeats a link at a time, so
    a burst of host load slows one round of several links rather than
    every round of one). The detectors divide by the fleet median, so
    the constant dispatch cost cancels. → N×N list of lists (the same on
    every rank), NaN on unprobed links. Ranks that share a card run it
    on the host group (:func:`~tpu_p2p_torch.parallel.collectives.
    host_staged`)."""
    import torch
    import torch.distributed as dist

    from tpu_p2p_torch.parallel import collectives as C

    n = mesh.size
    if edges is None:
        edges = C.ring_edges(n)
    x = C.make_payload(mesh, msg_bytes)
    card = x.is_cuda
    staged = card and mesh.device_group is None
    matrix = [[math.nan] * n for _ in range(n)]

    def chain(e):
        carry = x
        for _ in range(iters):
            carry = C.axis_ppermute(carry, mesh, (e,), label="health_probe")
        if card:
            torch.cuda.synchronize(x.device)
        return carry

    links = [(int(s), int(d)) for s, d in edges]
    best = {e: math.inf for e in links}
    with C.host_staged(staged):
        for e in links:
            chain(e)  # warm, untimed
        for _ in range(max(1, repeats)):
            for e in links:
                mesh.barrier()
                t0 = time.perf_counter()
                chain(e)
                dt = torch.tensor([time.perf_counter() - t0],
                                  dtype=torch.float64)
                if n > 1:
                    dist.all_reduce(dt, op=dist.ReduceOp.MAX,
                                    group=mesh.host_group)
                best[e] = min(best[e], float(dt.item()))
    for (s, d), t in best.items():
        matrix[s][d] = (msg_bytes * 8 * iters / t / 1e9 if t > 0
                        else math.nan)
    return matrix


# ------------------------------------------------------------- smoke


def _smoke_cfg(dtype: str = "float32"):
    from tpu_p2p_torch.models import flagship as F

    return F.FlagshipConfig(batch=8, seq=32, heads=4, head_dim=8,
                            stages=2, microbatches=2, num_experts=2,
                            capacity_factor=4.0, norm=True, dtype=dtype)


def _health_records(path: str, kind: str = "health") -> List[dict]:
    """The ``{"obs": kind}`` records of an obs JSONL stream."""
    recs = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if d.get("obs") == kind:
                recs.append(d)
    return recs


def run_smoke(rt, *, steps: int = 10, detect_within: int = 5,
              out=None) -> Optional[dict]:
    """The injected-fault smoke matrix on the world of runtime ``rt``
    (every rank calls it): each fault shape injected deterministically,
    its detector required within ``detect_within`` monitored steps, and
    the lost host healed, its final loss held to an uninterrupted run's.

    1. Degraded link: edge (0, 1) throttled ×16, every ring link probed
       (:func:`probe_link_matrix`); one probe pass is one monitoring
       step.
    2. Straggler: rank 1 sleeps 150 ms a step from a known step on in
       an instrumented training run; the monitor rides the run.
    3. Lost host: host ``n - 1`` stops heartbeating; ``run_training_
       with_heal`` reshards the rolling checkpoint onto the surviving
       power-of-two ranks and resumes.

    → on the first rank a dict with each scenario and the gate numbers
    ``health_detect_steps`` (max detection latency, None if any went
    undetected) and ``heal_resume_loss_delta``; None on the others.
    Needs >= 2 ranks."""
    import tempfile

    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.obs import faults
    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.train import run_training, run_training_with_heal

    log = out if out is not None else sys.stderr
    n = rt.world
    first = rt.rank == 0
    if n < 2:
        raise RuntimeError(
            f"the fault smoke needs >= 2 ranks, have {n} (spawn a world "
            "with --cpu-mesh 8)")

    def say(msg: str) -> None:
        if first:
            print(msg, file=log, flush=True)

    staged = rt.device.type == "cuda" and rt.mesh.device_group is None
    results: dict = {"devices": n}
    detect: Dict[str, Optional[int]] = {}

    # 1) degraded link
    plan = faults.FaultPlan(degrade_edge=(0, 1), degrade_factor=16)
    with faults.injecting(plan):
        mat = probe_link_matrix(rt.mesh)
    mon = HealthMonitor()
    verdicts = mon.observe_link_matrix(1, mat)
    hit = any(any(f["src"] == 0 and f["dst"] == 1
                  for f in v.detail["links"]) for v in verdicts)
    false_pos = sum(len(v.detail["links"]) for v in verdicts) - int(hit)
    detect["degraded_link"] = 1 if hit else None
    results["degraded_link"] = {
        "plan": plan.describe(), "detected": hit,
        "detect_steps": detect["degraded_link"],
        "flagged_links": [f for v in verdicts for f in v.detail["links"]],
        "false_positives": false_pos,
    }
    say(f"# smoke degraded_link: detected={hit} "
        f"(throttle {plan.describe()})")

    # 2) straggler rank
    cfg = _smoke_cfg()
    fmesh = F.build_mesh(n, runtime=rt)
    start = 2 + HealthConfig.straggler_min_samples + 1
    steps = max(steps, start + 4)
    common = dict(steps=steps, lr=1e-2, log_every=0, mesh=fmesh)
    with C.host_staged(staged):
        plan = faults.FaultPlan(slow_rank=1, slow_ms=150.0,
                                start_step=start)
        with tempfile.TemporaryDirectory(prefix="health_smoke_") as td:
            obs_path = os.path.join(td, "obs.jsonl")
            run_training(cfg, obs_jsonl=obs_path, fault_plan=plan,
                         **common)
            all_hits = ([r for r in _health_records(obs_path)
                         if r["verdict"] == "straggler"] if first else [])
            step_ms = ([r["step_ms"] for r in _health_records(
                obs_path, "step")] if first else [])
        hits = [r for r in all_hits if r["step"] >= start]
        k = hits[0]["step"] - start + 1 if hits else None
        detect["straggler"] = k
        results["straggler"] = {
            "plan": plan.describe(), "detected": bool(hits),
            "detect_steps": k, "first_verdict": hits[0] if hits else None,
            "false_positives": len(all_hits) - len(hits),
            "step_ms": step_ms,
        }
        say(f"# smoke straggler: detected={bool(hits)} detect_steps={k}")
        if not hits:  # the window the detector scored, for the reader
            say(f"# smoke straggler step_ms (first rank, onset at step "
                f"{start}): {step_ms}")

        # 3) lost host + heal, against an uninterrupted twin
        plan = faults.FaultPlan(lost_host=n - 1, start_step=start)
        td = rt.broadcast(tempfile.mkdtemp(prefix="health_heal_")
                          if first else None, 0)
        try:
            obs_path = os.path.join(td, "obs.jsonl")
            healed = run_training_with_heal(
                cfg, ckpt_dir=os.path.join(td, "ck"), ckpt_every=2,
                obs_jsonl=obs_path, fault_plan=plan, **common)
            lost = ([r for r in _health_records(obs_path)
                     if r["verdict"] == "lost_host"] if first else [])
            rt.barrier()
            ref = run_training(cfg, **common)
        finally:
            rt.barrier()
            if first:
                import shutil

                shutil.rmtree(td, ignore_errors=True)
    if not first:
        return None
    k = lost[0]["step"] - start + 1 if lost else None
    detect["lost_host"] = k
    heal = healed.get("heal") or {}
    # No heal, no delta: an undetected loss runs to the end normally
    # and its ~0 delta would be fake.
    delta = (abs(healed["final_loss"] - ref["final_loss"])
             if heal.get("devices")
             and healed.get("final_loss") is not None
             and ref.get("final_loss") is not None else None)
    rel = (delta / max(abs(ref["final_loss"]), 1e-12)
           if delta is not None else None)
    results["lost_host"] = {
        "plan": plan.describe(), "detected": bool(lost),
        "detect_steps": k, "heal": heal,
        "healed_final_loss": healed.get("final_loss"),
        "uninterrupted_final_loss": ref.get("final_loss"),
        "loss_delta": delta, "loss_delta_rel": rel,
    }
    say(f"# smoke lost_host: detected={bool(lost)} detect_steps={k} "
        f"healed_on={heal.get('devices')} dev loss_delta={delta}")
    ks = list(detect.values())
    results["health_detect_steps"] = (max(ks) if all(
        isinstance(v, int) for v in ks) else None)
    results["heal_resume_loss_delta"] = delta
    results["detect_within"] = detect_within
    results["ok"] = bool(
        results["health_detect_steps"] is not None
        and results["health_detect_steps"] <= detect_within
        and results["degraded_link"]["false_positives"] == 0
        and heal.get("devices")
    )
    return results


# --------------------------------------------------------------- CLIs


def _build_watch_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_p2p_torch obs watch",
        description="Tail an --obs-jsonl step timeline and alert on "
                    "health verdicts: embedded {'obs': 'health'} records "
                    "are re-printed, stragglers are re-scored from the "
                    "step rows (median/MAD), serve {'obs': 'request'} "
                    "shed verdicts alert past --max-shed-frac, disagg "
                    "KV-migration stalls past --max-migrate-wait-steps, "
                    "and checkpoint {'obs': 'ckpt'} fallback / "
                    "crash-restart verdicts always alert. Exit codes: "
                    "0 = no alerts, 1 = alerts (inverted by "
                    "--expect-alerts), 2 = unreadable input.",
    )
    p.add_argument("path", help="obs JSONL file (train --obs-jsonl)")
    p.add_argument("--follow", action="store_true",
                   help="keep tailing for new rows; exits on the first "
                        "alert (or at --idle-timeout)")
    p.add_argument("--idle-timeout", type=float, default=30.0,
                   metavar="S", help="--follow: give up after S seconds "
                                     "with no new rows")
    p.add_argument("--poll", type=float, default=0.5, metavar="S",
                   help="--follow: poll interval")
    p.add_argument("--expect-alerts", action="store_true",
                   help="invert the exit code: 0 iff alerts were seen")
    p.add_argument("--straggler-z", type=float,
                   default=HealthConfig.straggler_z)
    p.add_argument("--straggler-window", type=int,
                   default=HealthConfig.straggler_window)
    p.add_argument("--max-shed-frac", type=float, default=0.0,
                   metavar="F",
                   help="alert on a serve shed verdict once the "
                        "cumulative shed fraction exceeds F (default 0: "
                        "any shed alerts)")
    p.add_argument("--max-migrate-wait-steps", type=int, default=None,
                   metavar="N",
                   help="disaggregated serving: alert on a request whose "
                        "KV migration waited more than N scheduler steps "
                        "(default: no migration-stall alerting)")
    return p


def watch_main(argv: Optional[Sequence[str]] = None,
               stream=None) -> int:
    """``python -m tpu_p2p_torch obs watch <obs.jsonl>`` — see the
    parser description for the alert sources and the exit codes."""
    args = _build_watch_parser().parse_args(argv)
    out = stream if stream is not None else sys.stdout
    if not os.path.exists(args.path):
        print(f"# watch: no such file {args.path!r}", file=sys.stderr)
        return 2
    det = StragglerDetector(window=args.straggler_window,
                            z=args.straggler_z)
    alerts = steps = requests = shed = 0
    ckpt_rows = ckpt_bad = migrated = worst_wait = 0

    def handle(line: str) -> bool:
        """→ True when this row alerted."""
        nonlocal alerts, steps, requests, shed, ckpt_rows, ckpt_bad
        nonlocal migrated, worst_wait
        line = line.strip()
        if not line:
            return False
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return False  # torn tail of a live file
        hit = False
        if rec.get("obs") == "request":
            requests += 1
            outcome = rec.get("outcome") or ""
            if outcome.startswith("shed"):
                shed += 1
                if shed / requests > args.max_shed_frac:
                    v = HealthVerdict(
                        kind=outcome, step=int(rec.get("shed_step") or 0),
                        detail={"id": rec.get("id"),
                                "shed_frac": round(shed / requests, 4)})
                    out.write(f"# ALERT {v.describe()}\n")
                    hit = True
            if rec.get("migrate_step") is not None \
                    or rec.get("migrations"):
                migrated += 1
                wait = int(rec.get("migrate_wait_steps") or 0)
                worst_wait = max(worst_wait, wait)
                if (args.max_migrate_wait_steps is not None
                        and wait > args.max_migrate_wait_steps):
                    v = HealthVerdict(
                        kind="migrate_stall",
                        step=int(rec.get("migrate_step") or 0),
                        detail={"id": rec.get("id"),
                                "migrate_wait_steps": wait,
                                "decode_shard": rec.get("decode_shard")})
                    out.write(f"# ALERT {v.describe()}\n")
                    hit = True
        elif rec.get("obs") == "ckpt":
            # A fallback or a crash-restart means storage failed: always
            # an incident, whatever the recovery did.
            ckpt_rows += 1
            event = rec.get("event") or "?"
            if event in ("fallback", "crash_restart") \
                    or rec.get("ok") is False:
                ckpt_bad += 1
                detail = {k: v for k, v in rec.items()
                          if k not in ("obs", "event", "step")}
                v = HealthVerdict(kind=f"ckpt_{event}",
                                  step=int(rec.get("step") or 0),
                                  detail=detail)
                out.write(f"# ALERT {v.describe()}\n")
                hit = True
        elif rec.get("obs") == "health":
            v = HealthVerdict(kind=rec.get("verdict", "?"),
                              step=int(rec.get("step", 0)),
                              detail={k: v for k, v in rec.items()
                                      if k not in ("obs", "verdict",
                                                   "step")})
            out.write(f"# ALERT {v.describe()}\n")
            hit = True
        elif rec.get("obs") == "step":
            steps += 1
            got = det.observe(float(rec.get("step_ms", 0.0)))
            if got is not None:
                v = HealthVerdict(kind="straggler(watch)",
                                  step=int(rec.get("step", 0)),
                                  detail=got)
                out.write(f"# ALERT {v.describe()}\n")
                hit = True
        if hit:
            alerts += 1
            out.flush()
        return hit

    with open(args.path) as fh:
        for line in fh:
            if handle(line) and args.follow:
                break  # exits on alert
        else:
            if args.follow:
                idle = 0.0
                while idle < args.idle_timeout:
                    line = fh.readline()
                    if not line:
                        time.sleep(args.poll)
                        idle += args.poll
                        continue
                    idle = 0.0
                    if handle(line):
                        break
    if requests:
        out.write(f"# watch: {requests} request row(s), {shed} shed "
                  f"(frac {shed / requests:.4f})\n")
    if migrated:
        out.write(f"# watch: {migrated} migrated request row(s), "
                  f"worst migrate wait {worst_wait} step(s)\n")
    if ckpt_rows:
        out.write(f"# watch: {ckpt_rows} ckpt row(s), {ckpt_bad} "
                  "fallback/crash\n")
    out.write(f"# watch: {alerts} alert(s) over {steps} step row(s)\n")
    out.flush()
    if args.expect_alerts:
        return 0 if alerts else 1
    return 1 if alerts else 0


def _build_smoke_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_p2p_torch obs smoke",
        description="Injected-fault health smoke: degraded link, "
                    "straggler rank, and lost host + self-healing resume "
                    "on the world of ranks; nonzero exit unless every "
                    "detector fires within --detect-steps and the heal's "
                    "loss parity holds.",
    )
    p.add_argument("--steps", type=int, default=10,
                   help="training steps per train-loop scenario")
    p.add_argument("--detect-steps", type=int, default=5,
                   help="max allowed detection latency (the "
                        "health_detect_steps gate)")
    p.add_argument("--max-loss-rel", type=float, default=0.05,
                   help="max |healed - uninterrupted| final-loss delta, "
                        "relative")
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="spawn N CPU ranks (gloo)")
    p.add_argument("--device", default=None,
                   help="each rank's device (default: a card a rank; "
                        "cuda:0 puts every rank of a launched world on "
                        "one card, its collectives on the host group)")
    return p


def smoke_main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m tpu_p2p_torch obs smoke``: :func:`run_smoke` on the
    world (``--cpu-mesh N`` spawns it); the first rank prints the
    scenario lines and one JSON line, and every rank exits with the
    verdict."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _build_smoke_parser().parse_args(argv)
    if args.cpu_mesh and "RANK" not in os.environ:
        from tpu_p2p_torch.parallel.launch import spawn

        return max(spawn(args.cpu_mesh, ["-m", "tpu_p2p_torch", "obs",
                                         "smoke", *argv]))
    from tpu_p2p_torch.utils.errors import fail_fast

    rt = None
    try:
        from tpu_p2p_torch.parallel.runtime import make_runtime

        rt = make_runtime(device="cpu" if args.cpu_mesh else args.device)
        res = run_smoke(rt, steps=args.steps,
                        detect_within=args.detect_steps, out=sys.stdout)
        ok = False
        if res is not None:
            rel = res["lost_host"].get("loss_delta_rel")
            parity_ok = rel is not None and rel <= args.max_loss_rel
            ok = bool(res["ok"] and parity_ok)
            print(json.dumps({
                "health_detect_steps": res["health_detect_steps"],
                "heal_resume_loss_delta": res["heal_resume_loss_delta"],
                "heal_loss_delta_rel": rel,
                "heal_devices": res["lost_host"]["heal"].get("devices"),
                "ok": ok,
            }), flush=True)
        ok = rt.broadcast(ok, 0)
        rt.close()
        rt = None
        return 0 if ok else 1
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 — the one fail-fast exit
        return fail_fast(e)
    finally:
        if rt is not None:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
