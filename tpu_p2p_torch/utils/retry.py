"""Bounded retry with exponential backoff for transient IO failures —
the port of ``tpu_p2p/utils/retry.py``.

Every file of a checkpoint generation is written through
:func:`retry_io` (:mod:`tpu_p2p_torch.utils.checkpoint`): storage fails
transiently far more often than for good, and a save that dies on the
first EIO loses a generation. The policy is the reference's: a fixed
attempt budget, exponential backoff with no jitter (an injected
first-N-failures fault must give a predictable attempt count), and
``OSError`` alone retried. A
:class:`~tpu_p2p_torch.obs.faults.SimulatedCrash` is a
``BaseException``, so no retry filter swallows a simulated process
death.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["retry_io", "DEFAULT_ATTEMPTS"]

# Attempt budget of every checkpoint write: an injected transient-IO
# fault (FaultPlan.ckpt_io_errors) below it is absorbed with no lost
# generation.
DEFAULT_ATTEMPTS = 5


def retry_io(fn: Callable, *, attempts: int = DEFAULT_ATTEMPTS,
             base_delay_s: float = 0.002, backoff: float = 2.0,
             retry_on: Tuple[Type[BaseException], ...] = (OSError,),
             sleep: Callable[[float], None] = time.sleep,
             on_retry: Optional[Callable[[int, BaseException], None]]
             = None):
    """Call ``fn()`` up to ``attempts`` times, sleeping
    ``base_delay_s * backoff**k`` after the k-th failure.

    Only exceptions matching ``retry_on`` are retried; anything else (a
    ``BaseException`` such as ``SimulatedCrash`` included) propagates at
    once. The last failure re-raises unchanged. ``on_retry(attempt,
    exc)`` runs before each backoff sleep (``attempt``: the 1-based
    index of the attempt that failed), so callers can count retries.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delay = float(base_delay_s)
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:
            if attempt == attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if delay > 0:
                sleep(delay)
            delay *= backoff
