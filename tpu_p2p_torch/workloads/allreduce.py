"""Reductions and gathers — the port's copy of
``tpu_p2p/workloads/allreduce.py``: ``allreduce``, ``reduce_scatter``
and ``all_gather`` over NCCL (gloo on the CPU).

Data-parallel gradients ride allreduce, ZeRO gradients reduce-scatter,
and the matching parameter gathers all-gather. Byte accounting is the
ring busbw convention, so the numbers compare with NCCL's ``busbw``
column:

- allreduce: ``2 (n-1)/n * msg`` a rank per op;
- reduce_scatter alone: ``(n-1)/n * msg``; in ``fused``/
  ``differential``/``device`` the chain unit must keep its shape, so
  each hop is reduce-scatter + all-gather, accounted ``2 (n-1)/n``;
- all_gather: the payload is the gathered buffer, each op gathers every
  rank's own ``1/n`` chunk, ``(n-1)/n * msg``.

These are library collectives under either ``--transport``, as in the
reference. On ranks that share a card NCCL cannot form, and they raise
before any traffic.
"""

from __future__ import annotations

import sys

import numpy as np

from tpu_p2p_torch.config import format_size
from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.utils.errors import BackendError
from tpu_p2p_torch.workloads.base import (
    WorkloadContext,
    cell_record,
    measure_collective,
    verify_collective,
    workload,
)

ORACLES = {
    "allreduce": C.expected_all_reduce,
    "reduce_scatter": C.expected_reduce_scatter,
    "all_gather": C.expected_all_gather,
}


def _run_reduction(ctx: WorkloadContext, name: str) -> list:
    rt, cfg = ctx.rt, ctx.cfg
    mesh, n = rt.mesh, rt.num_devices
    results = []
    for msg_bytes in cfg.sizes():
        x = ctx.payloads.get(mesh, msg_bytes, np.dtype(cfg.dtype))
        if name != "allreduce" and x.shape[-1] % n:
            # Both tiled collectives split the payload dim n ways.
            raise BackendError(
                f"{name} needs payload elems divisible by "
                f"{n} devices; {format_size(msg_bytes)} of {cfg.dtype} "
                f"gives {x.shape[-1]}"
            )
        if name == "allreduce":
            single = ctx.cache.all_reduce(mesh, "d")
            chain = lambda k: ctx.cache.psum_chain(mesh, "d", k)  # noqa: E731
            bpd = 2 * (n - 1) * msg_bytes // n
            note = "ring busbw 2(n-1)/n"
        elif name == "all_gather":
            single = ctx.cache.all_gather(mesh, "d")
            chain = lambda k: ctx.cache.ag_chain(mesh, "d", k)  # noqa: E731
            bpd = (n - 1) * msg_bytes // n
            note = "(n-1)/n"
        else:
            single = ctx.cache.reduce_scatter(mesh, "d")
            chain = lambda k: ctx.cache.rs_ag_chain(mesh, "d", k)  # noqa: E731
            # Serialized times the bare RS; chained modes time RS+AG.
            bpd = ((n - 1) * msg_bytes // n if cfg.mode == "serialized"
                   else 2 * (n - 1) * msg_bytes // n)
            note = ("(n-1)/n" if cfg.mode == "serialized"
                    else "rs+ag chain 2(n-1)/n")
        gbps_val, samples = measure_collective(
            ctx, mesh, single, chain, x, bytes_per_device=bpd
        )
        if cfg.check:
            host = C.host_payload(mesh, msg_bytes, np.dtype(cfg.dtype))
            verify_collective(ctx, single, x, ORACLES[name](host),
                              f"{name} at {msg_bytes}B")
        if ctx.is_printer:
            sys.stdout.write(
                f"{name} {format_size(msg_bytes)} {cfg.mode}: "
                f"{gbps_val:6.02f} Gbps/device busbw  "
                f"(p50 {samples.p50 * 1e6:.1f}us, {n} devices, {note})\n"
            )
            sys.stdout.flush()
        ctx.record(
            cell_record(
                ctx, workload=name, direction="uni", src=0, dst=0,
                msg_bytes=msg_bytes, gbps_val=gbps_val, samples=samples,
                devices=n, accounting=note,
            )
        )
        results.append({"msg_bytes": msg_bytes, "gbps_per_device": gbps_val})
    return results


@workload("allreduce")
def run_allreduce(ctx: WorkloadContext) -> list:
    return _run_reduction(ctx, "allreduce")


@workload("reduce_scatter")
def run_reduce_scatter(ctx: WorkloadContext) -> list:
    return _run_reduction(ctx, "reduce_scatter")


@workload("all_gather")
def run_all_gather(ctx: WorkloadContext) -> list:
    return _run_reduction(ctx, "all_gather")
