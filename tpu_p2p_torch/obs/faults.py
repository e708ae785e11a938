"""Deterministic fault injection — the port of ``tpu_p2p/obs/faults.py``.

A :class:`FaultPlan` describes injected faults, and the code that owns
each fault's site consults it at fixed points, so a detector or a
recovery path is testable end to end with no randomness. Each shape and
where it applies:

- **Degraded link** (``degrade_edge`` + ``degrade_factor``): the
  ledger-recorded model-layer permutes
  (:func:`tpu_p2p_torch.parallel.collectives.axis_ppermute_start`, the
  chunk wave's library hops) route the arrival through
  ``degrade_factor - 1`` extra round trips of the chosen link, each the
  ``s <-> d`` swap applied twice, a bitwise identity: host timing, the
  card's trace and the ledger (``fault_throttle`` rows) see a slower
  link while every value stays exact. The decision is made at each call
  under the active plan (the health probe builds its chains inside it).
- **Straggler** (``slow_rank`` + ``slow_ms``): the training loop calls
  :func:`maybe_slow_host` once a step inside its step span, on rank
  ``slow_rank`` only; the step's collectives carry the wait to the
  others. The serving batcher's per-step hook calls it too.
- **Lost host** (``lost_host``): :func:`host_lost` answers whether host
  ``h`` has stopped heartbeating at a step; the loop feeds the health
  monitor heartbeats for every host it still admits, and the missed ones
  become a ``lost_host`` verdict (``train --heal`` reshards onto the
  survivors). The plan is the same on every rank, so every rank reaches
  the verdict at one step.
- **Serving** (``page_pool_clamp``, ``storm_*``): applied only in
  :func:`tpu_p2p_torch.serve.resilience.apply_serve_faults`.
- **Storage**, applied only in the interposed writer of
  :mod:`tpu_p2p_torch.utils.checkpoint` (``_write_file`` and the
  post-publish rot):

  - *crash mid-write* (``ckpt_crash_after_bytes``): the first generation
    save at ``step >= start_step`` writes that many bytes, fsyncs the
    partial file and dies with :class:`SimulatedCrash`, a
    ``BaseException`` that only the supervisor
    (``train.run_training_supervised``) catches. One-shot per plan
    instance: the supervisor re-entering the loop with the same plan
    does not die again, as a restarted process would not.
  - *published-generation rot* (``ckpt_corrupt_seed``): a seeded one-bit
    flip in the just-published generation's ``params.npz`` at ``step >=
    start_step``, which the verifying loader must fall back past.
  - *transient IO errors* (``ckpt_io_errors``): the first N write
    attempts under the plan raise ``OSError`` before touching the file;
    the bounded retry (:func:`tpu_p2p_torch.utils.retry.retry_io`)
    absorbs them.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional, Tuple

__all__ = ["FaultPlan", "SimulatedCrash", "injecting", "active_plan",
           "host_lost", "maybe_slow_host", "ckpt_crash_budget",
           "mark_ckpt_crash_fired", "take_ckpt_io_error",
           "ckpt_corrupt_due"]


class SimulatedCrash(BaseException):
    """Simulated process death mid-checkpoint-write
    (``FaultPlan.ckpt_crash_after_bytes``).

    A ``BaseException`` on purpose: ``except Exception`` cleanup and the
    retry helper's ``OSError`` filter must not swallow a process death.
    ``path`` names the file being written, ``bytes_written`` how much of
    it landed, and ``step`` the training step whose save died (set by
    the checkpoint layer)."""

    def __init__(self, path: str, bytes_written: int,
                 step: Optional[int] = None) -> None:
        super().__init__(
            f"simulated process death after {bytes_written} bytes "
            f"into {path}")
        self.path = path
        self.bytes_written = int(bytes_written)
        self.step = step


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic injected faults (the smoke scenarios set one shape
    each, so attribution is unambiguous). ``start_step`` gates the
    step-indexed faults: absent before it, present from it on."""

    degrade_edge: Optional[Tuple[int, int]] = None
    degrade_factor: int = 8  # total trips per ship on the chosen edge
    slow_rank: Optional[int] = None
    slow_ms: float = 0.0  # injected per-step host delay
    lost_host: Optional[int] = None
    page_pool_clamp: Optional[int] = None  # usable KV pages per shard
    storm_step: Optional[int] = None  # burst arrival scheduler step
    storm_requests: int = 0  # burst size (> 0 iff storm_step set)
    ckpt_crash_after_bytes: Optional[int] = None  # process death after
    # this many bytes of one generation save (one-shot per plan)
    ckpt_corrupt_seed: Optional[int] = None  # seeded one-bit flip in
    # each published generation's params.npz
    ckpt_io_errors: int = 0  # first-N write attempts raise OSError
    start_step: int = 0

    def __post_init__(self) -> None:
        if self.degrade_edge is not None:
            s, d = self.degrade_edge
            if int(s) == int(d):
                raise ValueError(
                    f"degrade_edge {self.degrade_edge} is a self-edge; "
                    "the throttle targets an inter-device link"
                )
            if self.degrade_factor < 2:
                raise ValueError(
                    f"degrade_factor must be >= 2 (1 is a healthy "
                    f"link), got {self.degrade_factor}"
                )
        if self.slow_rank is not None and self.slow_ms <= 0:
            raise ValueError(
                f"slow_rank={self.slow_rank} needs slow_ms > 0, got "
                f"{self.slow_ms}"
            )
        if self.page_pool_clamp is not None and self.page_pool_clamp < 1:
            raise ValueError(
                f"page_pool_clamp must leave >= 1 usable page per "
                f"shard, got {self.page_pool_clamp}"
            )
        if (self.storm_step is None) != (self.storm_requests <= 0):
            raise ValueError(
                f"storm_step={self.storm_step} and storm_requests="
                f"{self.storm_requests} must be set together (a step "
                "with no burst, or a burst with no step, is a no-op "
                "plan that would grade as an undetected fault)"
            )
        if self.storm_step is not None and self.storm_step < 0:
            raise ValueError(
                f"storm_step must be >= 0, got {self.storm_step}"
            )
        if (self.ckpt_crash_after_bytes is not None
                and self.ckpt_crash_after_bytes < 0):
            raise ValueError(
                f"ckpt_crash_after_bytes must be >= 0 (0 = die before "
                f"the first byte), got {self.ckpt_crash_after_bytes}"
            )
        if self.ckpt_io_errors < 0:
            raise ValueError(
                f"ckpt_io_errors must be >= 0, got "
                f"{self.ckpt_io_errors}"
            )
        if self.start_step < 0:
            raise ValueError(f"start_step must be >= 0, got "
                             f"{self.start_step}")

    def describe(self) -> str:
        parts: List[str] = []
        if self.degrade_edge is not None:
            parts.append(f"degrade link {self.degrade_edge[0]}->"
                         f"{self.degrade_edge[1]} x{self.degrade_factor}")
        if self.slow_rank is not None:
            parts.append(f"slow rank {self.slow_rank} by "
                         f"{self.slow_ms:g} ms/step")
        if self.lost_host is not None:
            parts.append(f"lose host {self.lost_host}")
        if self.page_pool_clamp is not None:
            parts.append(f"clamp page pool to {self.page_pool_clamp}"
                         "/shard")
        if self.storm_step is not None:
            parts.append(f"storm {self.storm_requests} requests at "
                         f"step {self.storm_step}")
        if self.ckpt_crash_after_bytes is not None:
            parts.append(f"crash checkpoint save after "
                         f"{self.ckpt_crash_after_bytes} bytes")
        if self.ckpt_corrupt_seed is not None:
            parts.append(f"corrupt published generation "
                         f"(seed {self.ckpt_corrupt_seed})")
        if self.ckpt_io_errors:
            parts.append(f"fail first {self.ckpt_io_errors} "
                         "checkpoint write(s)")
        tail = f" from step {self.start_step}" if self.start_step else ""
        return ("; ".join(parts) or "no-op plan") + tail


# One active plan, not a stack: two concurrent plans would make every
# fault's attribution ambiguous.
_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    """The plan being injected, or None."""
    return _ACTIVE


@contextmanager
def injecting(plan: FaultPlan):
    """Activate ``plan`` for the dynamic extent of the block; nested
    activation is refused."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError(
            f"a fault plan is already active ({_ACTIVE.describe()}); "
            "nested injection would make detector attribution ambiguous"
        )
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None


def host_lost(plan: Optional[FaultPlan], host: int, step: int) -> bool:
    """Has ``host`` stopped heartbeating at global ``step`` under
    ``plan``? The loop feeds the health monitor heartbeats only for the
    hosts this returns False for."""
    return (plan is not None and plan.lost_host is not None
            and int(host) == int(plan.lost_host)
            and int(step) >= plan.start_step)


def maybe_slow_host(plan: Optional[FaultPlan], step: int,
                    sleep=time.sleep) -> bool:
    """Apply the straggler delay for global ``step``: a host-side sleep
    of ``plan.slow_ms`` from ``plan.start_step`` on, nothing on the
    card. → True when a delay was injected."""
    if (plan is not None and plan.slow_rank is not None
            and int(step) >= plan.start_step):
        sleep(plan.slow_ms / 1e3)
        return True
    return False


# ------------------------------------------------- storage IO faults
# The one-shot consumption state of the storage faults lives on the
# plan instance (not its value): the supervisor re-entering the loop
# with the SAME plan must not die again, while a fresh plan starts
# fresh.


def _io_state(plan: FaultPlan) -> dict:
    st = plan.__dict__.get("_io_state")
    if st is None:
        st = {"crash_fired": False, "io_errors": 0}
        object.__setattr__(plan, "_io_state", st)  # frozen dataclass
    return st


def ckpt_crash_budget(plan: Optional[FaultPlan],
                      step: int) -> Optional[int]:
    """Byte budget for THIS generation save if the simulated crash
    should arm now (``step`` is the save's training step), else None.
    Arming does not consume the fault — :func:`mark_ckpt_crash_fired`
    does, when the budget is exceeded — so a save smaller than the
    budget leaves the crash pending for the next one."""
    if (plan is None or plan.ckpt_crash_after_bytes is None
            or int(step) < plan.start_step):
        return None
    if _io_state(plan)["crash_fired"]:
        return None
    return plan.ckpt_crash_after_bytes


def mark_ckpt_crash_fired(plan: FaultPlan) -> None:
    """Consume the one-shot crash (the writer calls this as it raises
    :class:`SimulatedCrash`)."""
    _io_state(plan)["crash_fired"] = True


def take_ckpt_io_error(plan: Optional[FaultPlan]) -> bool:
    """→ True when this write attempt should fail transiently: the first
    ``ckpt_io_errors`` attempts under the plan do, every later one
    succeeds."""
    if plan is None or not plan.ckpt_io_errors:
        return False
    st = _io_state(plan)
    if st["io_errors"] < plan.ckpt_io_errors:
        st["io_errors"] += 1
        return True
    return False


def ckpt_corrupt_due(plan: Optional[FaultPlan], step: int) -> bool:
    """Should the generation just published at ``step`` be bit-flipped?
    (Every publish at ``step >= start_step`` is.)"""
    return (plan is not None and plan.ckpt_corrupt_seed is not None
            and int(step) >= plan.start_step)
