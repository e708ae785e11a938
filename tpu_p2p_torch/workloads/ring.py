"""Ring shift-by-1 — the port's copy of ``tpu_p2p/workloads/ring.py``.

Every rank sends its payload to ``(i + shift) % n`` at once: the
all-links-busy counterpart of the reference's one-pair-at-a-time sweep,
and the transport of ring attention. Per-rank bandwidth uses the
reference formula (``p2p_matrix.cc:177``) with each rank moving
``msg_size`` bytes a hop, over ``--transport`` (NCCL send/recv, or the
peer-push kernel on a full permutation).
"""

from __future__ import annotations

import sys

from tpu_p2p_torch.config import format_size
from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.workloads.base import (
    WorkloadContext,
    cell_record,
    measure_edges,
    verify_edges,
    workload,
)


@workload("ring")
def run_ring(ctx: WorkloadContext, shift: int = 1) -> list:
    rt, cfg = ctx.rt, ctx.cfg
    n = rt.num_devices
    results = []
    for msg_bytes in cfg.sizes():
        edges = C.ring_edges(n, shift)
        gbps_val, samples = measure_edges(ctx, rt.mesh, "d", edges,
                                          msg_bytes)
        if cfg.check:
            verify_edges(ctx, rt.mesh, "d", edges, msg_bytes)
        if ctx.is_printer:
            sys.stdout.write(
                f"ring shift-by-{shift} {format_size(msg_bytes)} "
                f"{cfg.mode}: {gbps_val:6.02f} Gbps/device  "
                f"(p50 {samples.p50 * 1e6:.1f}us, p99 "
                f"{samples.p99 * 1e6:.1f}us, {n} devices all sending)\n"
            )
            sys.stdout.flush()
        ctx.record(
            cell_record(
                ctx, workload="ring", direction="uni", src=0,
                dst=shift % n, msg_bytes=msg_bytes, gbps_val=gbps_val,
                samples=samples, shift=shift, devices=n,
            )
        )
        results.append({"shift": shift, "msg_bytes": msg_bytes,
                        "gbps_per_device": gbps_val})
    return results
