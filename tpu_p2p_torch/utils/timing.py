"""Timing and metrics — the port's copy of ``tpu_p2p/utils/timing.py``.

Host clock bracketing of a barrier-fenced transfer loop, as the
reference program does (``p2p_matrix.cc:153,174-177`` uni;
``:208,255-258`` bi), with a monotonic clock, every per-iteration sample
kept (so p50/p99 exist) and warm-up calls before the timed region.

"Drain" — the reference's ``cudaStreamSynchronize``
(``p2p_matrix.cc:162,170``) — is a sync of the current stream when the
result lies on the card, and nothing on the CPU, where the transfers of
the gloo world have completed when they return. After it, a peer-push
kernel that gave up waiting for a peer in the drained work raises
:class:`TransferTimeout` (its output was never written). A watchdog thread turns
a drain that does not return within ``timeout_s`` into
:class:`TransferTimeout`, a marked cell instead of a hung sweep.
"""

from __future__ import annotations

import math
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from tpu_p2p_torch.parallel import pallas_dma
from tpu_p2p_torch.utils.errors import TransferTimeout

Clock = Callable[[], int]  # monotonic nanoseconds


def default_clock() -> Clock:
    """The native monotonic clock when the support library builds, else
    Python's (the same ``CLOCK_MONOTONIC``)."""
    from tpu_p2p_torch.utils import native

    if native.available():
        return native.monotonic_ns
    return time.monotonic_ns


@dataclass
class Samples:
    """Per-iteration timings plus the fenced-region total.

    ``mean_region`` is the reference's metric: the time between the two
    barriers over the iteration count (``p2p_matrix.cc:174-176``).
    Percentiles come from the per-iteration samples."""

    iter_seconds: list = field(default_factory=list)
    region_seconds: float = 0.0
    timed_out: bool = False

    @property
    def count(self) -> int:
        return len(self.iter_seconds)

    @property
    def mean_region(self) -> float:
        if self.timed_out or not self.count:
            return math.nan
        return self.region_seconds / self.count

    @property
    def mean(self) -> float:
        if self.timed_out or not self.count:
            return math.nan
        return sum(self.iter_seconds) / self.count

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over per-iteration samples."""
        if self.timed_out or not self.count:
            return math.nan
        from tpu_p2p_torch.utils import native

        if native.available():
            return native.percentile(self.iter_seconds, q)
        s = sorted(self.iter_seconds)
        rank = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
        return s[rank]

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def min(self) -> float:
        return min(self.iter_seconds) if self.iter_seconds else math.nan


def gbps(nbytes: int, seconds: float, directions: int = 1) -> float:
    """Throughput in Gbps — the reference formula ``msg_size * 8. / time
    / 1e9`` (``p2p_matrix.cc:177``), ``* 2`` bi-directional (``:258``)."""
    if seconds != seconds or seconds <= 0.0:  # NaN or degenerate
        return math.nan
    return nbytes * 8.0 / seconds / 1e9 * directions


def drain(value) -> None:
    """Wait for the work that produced ``value`` — a stream sync when it
    is a tensor on the card, nothing otherwise — then raise
    :class:`TransferTimeout` if a peer-push kernel of that work gave up
    (on the CPU none ran, and its fault record stays clear)."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.current_stream(value.device).synchronize()
    pallas_dma.check_faults()


def _block(value, timeout_s: Optional[float],
           fence: Callable = None) -> None:
    """``fence(value)`` (default :func:`drain`) under an optional
    watchdog: past ``timeout_s`` it raises :class:`TransferTimeout`."""
    fence = fence or drain
    if timeout_s is None:
        fence(value)
        return
    done = threading.Event()
    err: list = []

    def waiter():
        try:
            fence(value)
        except Exception as e:  # noqa: BLE001 — re-raised below
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    if not done.wait(timeout_s):
        raise TransferTimeout(f"transfer exceeded {timeout_s}s watchdog")
    if err:
        raise err[0]


def run_fenced(value, timeout_s: Optional[float] = None,
               fence: Callable = drain) -> None:
    """``fence(value)`` under the watchdog contract (reference
    ``timing.py:266``): past ``timeout_s`` a wedged transfer raises
    :class:`TransferTimeout` instead of hanging. The device-clock capture
    fences each chain run with it."""
    _block(value, timeout_s, fence)


def measure_serialized(
    fn: Callable,
    x,
    iters: int,
    *,
    warmup: int = 1,
    clock: Optional[Clock] = None,
    timeout_s: Optional[float] = None,
    barrier: Optional[Callable[[], None]] = None,
) -> Samples:
    """The reference's loop: one message in flight, ever. Barrier →
    start clock → ``iters`` × {launch; drain} → barrier → stop clock
    (``p2p_matrix.cc:146-176``); the drain charges launch overhead to the
    measurement, as the reference charges launch overhead."""
    clock = clock or default_clock()
    s = Samples()
    try:
        for _ in range(max(0, warmup)):
            _block(fn(x), timeout_s)
    except TransferTimeout:
        s.timed_out = True
        return s
    if barrier is not None:
        barrier()  # p2p_matrix.cc:146
    t_region0 = clock()
    try:
        for _ in range(iters):
            t0 = clock()
            _block(fn(x), timeout_s)
            s.iter_seconds.append((clock() - t0) / 1e9)
    except TransferTimeout:
        s.timed_out = True
        return s
    if barrier is not None:
        barrier()  # p2p_matrix.cc:173
    s.region_seconds = (clock() - t_region0) / 1e9
    return s


def measure_differential(
    make_chain: Callable[[int], Callable],
    x,
    iters: int,
    *,
    repeats: int = 3,
    clock: Optional[Clock] = None,
    fence: Callable = drain,
    timeout_s: Optional[float] = None,
    barrier: Optional[Callable[[], None]] = None,
) -> Samples:
    """Per-message time as the slope between two chain lengths:
    ``time(chain(iters)) - time(chain(short))`` over ``iters - short``
    cancels every constant per-call cost (launch, drain)."""
    clock = clock or default_clock()
    short = max(1, iters // 8)
    if short >= iters:
        iters = short + 1
    f_short, f_long = make_chain(short), make_chain(iters)
    s = Samples()
    try:
        _block(f_short(x), timeout_s, fence)  # warm
        _block(f_long(x), timeout_s, fence)
        if barrier is not None:
            barrier()
        for _ in range(repeats):
            t0 = clock()
            _block(f_short(x), timeout_s, fence)
            t_short = (clock() - t0) / 1e9
            t0 = clock()
            _block(f_long(x), timeout_s, fence)
            t_long = (clock() - t0) / 1e9
            # Raw slope, unclamped; the median below absorbs noise.
            s.iter_seconds.append((t_long - t_short) / (iters - short))
        if barrier is not None:
            barrier()
    except TransferTimeout:
        s.timed_out = True
        return s
    med = statistics.median(s.iter_seconds) if s.iter_seconds else math.nan
    s.region_seconds = max(0.0, med) * len(s.iter_seconds)
    return s


def measure_fused(
    chain_fn: Callable,
    x,
    iters: int,
    *,
    repeats: int = 3,
    warmup: int = 1,
    clock: Optional[Clock] = None,
    timeout_s: Optional[float] = None,
    barrier: Optional[Callable[[], None]] = None,
) -> Samples:
    """``iters`` dependent hops launched back to back and drained once;
    each sample is one whole chain over ``iters``. The pipelined
    counterpart the reference cannot express (its per-iteration stream
    sync forbids it), labelled apart from the serialized number."""
    clock = clock or default_clock()
    s = Samples()
    try:
        for _ in range(max(0, warmup)):
            _block(chain_fn(x), timeout_s)
    except TransferTimeout:
        s.timed_out = True
        return s
    if barrier is not None:
        barrier()
    t_region0 = clock()
    try:
        for _ in range(repeats):
            t0 = clock()
            _block(chain_fn(x), timeout_s)
            s.iter_seconds.append((clock() - t0) / 1e9 / iters)
    except TransferTimeout:
        s.timed_out = True
        return s
    if barrier is not None:
        barrier()
    # Pre-divided by iters: mean_region is seconds per message.
    s.region_seconds = (clock() - t_region0) / 1e9 / iters
    return s
