"""2-D torus shift — the port's copy of ``tpu_p2p/workloads/torus.py``.

Shift-by-1 rings along each axis of a 2-D rank mesh (``--mesh-shape
AxB``), one axis at a time: every line of the other axis runs the same
ring at once, so each axis's links are measured apart. Needs a 2-axis
mesh.
"""

from __future__ import annotations

import sys

from tpu_p2p_torch.config import format_size
from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.utils.errors import BackendError
from tpu_p2p_torch.workloads.base import (
    WorkloadContext,
    cell_record,
    measure_edges,
    verify_edges,
    workload,
)


@workload("torus2d")
def run_torus2d(ctx: WorkloadContext) -> list:
    rt, cfg = ctx.rt, ctx.cfg
    if len(rt.mesh.axis_names) != 2:
        raise BackendError(
            f"torus2d needs a 2-axis mesh, got axes {rt.mesh.axis_names} "
            f"(pass --mesh-shape, e.g. --mesh-shape 4x2)"
        )
    results = []
    for msg_bytes in cfg.sizes():
        for axis in rt.mesh.axis_names:
            size = rt.mesh.shape[axis]
            if size < 2:
                continue
            edges = C.ring_edges(size, 1)
            gbps_val, samples = measure_edges(ctx, rt.mesh, axis, edges,
                                              msg_bytes)
            if cfg.check:
                verify_edges(ctx, rt.mesh, axis, edges, msg_bytes)
            if ctx.is_printer:
                sys.stdout.write(
                    f"torus2d axis {axis!r} (size {size}) shift-by-1 "
                    f"{format_size(msg_bytes)} {cfg.mode}: "
                    f"{gbps_val:6.02f} Gbps/device (p50 "
                    f"{samples.p50 * 1e6:.1f}us)\n"
                )
                sys.stdout.flush()
            ctx.record(
                cell_record(
                    ctx, workload="torus2d", direction="uni", src=0, dst=1,
                    msg_bytes=msg_bytes, gbps_val=gbps_val,
                    samples=samples, axis=axis, axis_size=size,
                )
            )
            results.append({"axis": axis, "msg_bytes": msg_bytes,
                            "gbps": gbps_val})
    return results
