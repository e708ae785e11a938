"""Workload plumbing shared by the benchmark patterns — the port's copy
of ``tpu_p2p/workloads/base.py``.

Every rank runs every workload in step (SPMD); rank 0 of the world
prints and writes the JSONL log. A cell's number is the one measured on
the rank that sends (the pair's ``src``), handed to every rank, so the
printer reports a pair it may not belong to (``--isolation submesh``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from tpu_p2p_torch.config import BenchConfig
from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.parallel.runtime import Runtime
from tpu_p2p_torch.utils import timing
from tpu_p2p_torch.utils.errors import BackendError, TransferTimeout
from tpu_p2p_torch.utils.report import CellRecord, JsonlWriter

WORKLOADS: Dict[str, Callable] = {}

# The workloads whose transfers select cfg.transport; loopback counts
# via its intra-host pair (its self-edge floor is excluded by the
# src != dst guard where the record is stamped).
TRANSPORT_WORKLOADS = frozenset({"pairwise", "latency", "loopback"})


def workload(name: str):
    def deco(fn):
        WORKLOADS[name] = fn
        return fn

    return deco


class PayloadCache:
    """Reuse payload buffers across cells — the reference allocates its
    send/recv buffers exactly once (p2p_matrix.cc:124-130)."""

    def __init__(self) -> None:
        self._cache: dict = {}

    def get(self, mesh, msg_bytes: int, dtype):
        key = (mesh, msg_bytes, str(dtype))
        x = self._cache.get(key)
        if x is None:
            x = C.make_payload(mesh, msg_bytes, dtype)
            self._cache[key] = x
        return x


@dataclass
class WorkloadContext:
    """Everything a workload needs, built once per run by the CLI."""

    rt: Runtime
    cfg: BenchConfig
    cache: C.CollectiveCache = field(default_factory=C.CollectiveCache)
    payloads: PayloadCache = field(default_factory=PayloadCache)
    jsonl: Optional[JsonlWriter] = None
    done: dict = field(default_factory=dict)

    @property
    def is_printer(self) -> bool:
        """Rank-0 gating for stdout (p2p_matrix.cc:133 et al.)."""
        return self.rt.rank == 0

    def record(self, rec: CellRecord) -> None:
        """Append a cell record — printer rank only, so the JSONL stays
        one authoritative log."""
        if self.jsonl is not None and self.is_printer:
            self.jsonl.write(rec)

    def previously_done(self, key: tuple) -> Optional[float]:
        if self.cfg.resume and key in self.done:
            return self.done[key]
        return None


def measure_edges(
    ctx: WorkloadContext,
    mesh,
    axis: str,
    edges: Sequence[C.Edge],
    msg_bytes: int,
    *,
    directions: int = 1,
) -> tuple:
    """Measure one edge set on ``mesh`` → (gbps, Samples); a rank
    outside ``mesh`` measures nothing (NaN, empty samples).

    ``serialized`` is the reference's one-message-in-flight loop
    (p2p_matrix.cc:154-171); ``fused`` launches ``iters`` dependent hops
    and drains once; ``differential`` takes the slope between two chain
    lengths. The transfers honour ``cfg.transport``."""
    if not mesh.is_member:
        return math.nan, timing.Samples()
    x = ctx.payloads.get(mesh, msg_bytes, np.dtype(ctx.cfg.dtype))
    transport = ctx.cfg.transport
    return measure_collective(
        ctx,
        mesh,
        ctx.cache.permute(mesh, axis, edges, transport=transport),
        lambda k: ctx.cache.permute_chain(mesh, axis, edges, k,
                                          transport=transport),
        x,
        bytes_per_device=msg_bytes,
        directions=directions,
    )


def measure_collective(
    ctx: WorkloadContext,
    mesh,
    single_fn,
    chain_builder,
    x,
    *,
    bytes_per_device: int,
    directions: int = 1,
) -> tuple:
    """Mode dispatch → (gbps, Samples): ``single_fn`` is one transfer,
    ``chain_builder(k)`` a chain of ``k``; the barriers are the mesh's."""
    cfg = ctx.cfg
    barrier = mesh.barrier
    if cfg.mode == "serialized":
        s = timing.measure_serialized(
            single_fn, x, cfg.iters, warmup=cfg.warmup,
            timeout_s=cfg.timeout_s, barrier=barrier,
        )
    elif cfg.mode == "fused":
        s = timing.measure_fused(
            chain_builder(cfg.iters), x, cfg.iters,
            repeats=cfg.fused_repeats, warmup=cfg.warmup,
            timeout_s=cfg.timeout_s, barrier=barrier,
        )
    else:  # differential
        s = timing.measure_differential(
            chain_builder, x, cfg.iters, repeats=cfg.fused_repeats,
            timeout_s=cfg.timeout_s, barrier=barrier,
        )
    return timing.gbps(bytes_per_device, s.mean_region,
                       directions=directions), s


def verify_edges(ctx: WorkloadContext, mesh, axis: str, edges,
                 msg_bytes: int) -> None:
    """``--check``: every member's arrival must equal its row of the
    host oracle, over the same transport as the measurement; all ranks
    agree on the verdict, so a mismatch fails every rank at once. A hop
    whose kernel gave up waiting for a peer wrote no arrival: it fails
    the check (with its :class:`TransferTimeout` on the rank that saw
    it) and is never compared."""
    ok, fault = True, None
    if mesh.is_member:
        dtype = np.dtype(ctx.cfg.dtype)
        x = ctx.payloads.get(mesh, msg_bytes, dtype)
        got = ctx.cache.permute(mesh, axis, edges,
                                transport=ctx.cfg.transport)(x)
        want = C.expected_permute(C.host_payload(mesh, msg_bytes, dtype),
                                  edges)
        try:
            timing.drain(got)
        except TransferTimeout as e:
            fault = e
        ok = fault is None and C.verify_against(got, want, mesh)
    if not ctx.rt.all_true(ok):
        if fault is not None:
            raise fault
        raise BackendError(
            f"payload verification failed for edges {tuple(edges)} at "
            f"{msg_bytes}B")


def cell_record(
    ctx: WorkloadContext,
    *,
    workload: str,
    direction: str,
    src: int,
    dst: int,
    msg_bytes: int,
    gbps_val: float,
    samples,
    **extra,
) -> CellRecord:
    # Which transport measured the cell — part of the resume key, and
    # stamped only where cfg.transport selects the transfer.
    if workload in TRANSPORT_WORKLOADS and src != dst:
        extra.setdefault("transport", ctx.cfg.transport)
    return CellRecord(
        workload=workload,
        direction=direction,
        src=src,
        dst=dst,
        msg_bytes=msg_bytes,
        iters=ctx.cfg.iters,
        mode=ctx.cfg.mode,
        gbps=gbps_val,
        mean_s=samples.mean,
        p50_s=samples.p50,
        p99_s=samples.p99,
        min_s=samples.min,
        timed_out=samples.timed_out,
        extra=extra,
    )
