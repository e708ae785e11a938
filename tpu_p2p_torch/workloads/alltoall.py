"""All-to-all — the port's copy of ``tpu_p2p/workloads/alltoall.py``.

The transport of Ulysses-style sequence parallelism and expert
parallelism: every rank splits its ``msg_size`` buffer into ``n`` chunks
and exchanges them with every peer in one NCCL all-to-all. Each rank
transmits ``msg*(n-1)/n`` bytes (its own chunk stays), so per-rank Gbps
uses that numerator. Repeating an all-to-all is a reshuffle, not a
chain worth timing, so every mode runs the serialized loop, as in the
reference. The library collective runs under either ``--transport``.
"""

from __future__ import annotations

import sys

import numpy as np

from tpu_p2p_torch.config import format_size
from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.utils import timing
from tpu_p2p_torch.utils.errors import BackendError
from tpu_p2p_torch.workloads.base import (
    WorkloadContext,
    cell_record,
    verify_collective,
    workload,
)


@workload("all_to_all")
def run_all_to_all(ctx: WorkloadContext) -> list:
    rt, cfg = ctx.rt, ctx.cfg
    n = rt.num_devices
    results = []
    fn = ctx.cache.all_to_all(rt.mesh, "d")
    for msg_bytes in cfg.sizes():
        if msg_bytes % n:
            raise BackendError(
                f"all_to_all needs msg size divisible by {n} devices, got "
                f"{msg_bytes}"
            )
        dtype = np.dtype(cfg.dtype)
        x = ctx.payloads.get(rt.mesh, msg_bytes, dtype)
        s = timing.measure_serialized(
            fn, x, cfg.iters, warmup=cfg.warmup, timeout_s=cfg.timeout_s,
            barrier=rt.barrier,
        )
        sent = msg_bytes * (n - 1) // n
        gbps_val = timing.gbps(sent, s.mean_region)
        if cfg.check:
            host = C.host_payload(rt.mesh, msg_bytes, dtype)
            want = C.expected_all_to_all(host.reshape(n, -1), n)
            verify_collective(ctx, fn, x, want,
                              f"all_to_all at {msg_bytes}B")
        if ctx.is_printer:
            sys.stdout.write(
                f"all_to_all {format_size(msg_bytes)} over {n} devices: "
                f"{gbps_val:6.02f} Gbps/device tx  "
                f"(p50 {s.p50 * 1e6:.1f}us, p99 {s.p99 * 1e6:.1f}us)\n"
            )
            sys.stdout.flush()
        ctx.record(
            cell_record(
                ctx, workload="all_to_all", direction="uni", src=0, dst=0,
                msg_bytes=msg_bytes, gbps_val=gbps_val, samples=s,
                devices=n, bytes_tx_per_device=sent,
            )
        )
        results.append({"msg_bytes": msg_bytes,
                        "gbps_per_device_tx": gbps_val})
    return results
