"""Small-message latency and loopback — the port's copy of
``tpu_p2p/workloads/latency.py``.

- ``latency``: p50/p99 send/recv latency at 8 B between ranks 0 and 1,
  serialized (launch + drain included), beside a fused-chain per-hop
  estimate that removes the per-message drain.
- ``loopback``: the 4 KiB exchange with the first rank on rank 0's host;
  with one rank, an honest whole-buffer rewrite chain on the device.
"""

from __future__ import annotations

import sys

from tpu_p2p_torch.config import format_size
from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.utils import timing
from tpu_p2p_torch.workloads.base import WorkloadContext, cell_record, workload

LATENCY_BYTES = 8  # BASELINE.json "p50 send/recv latency @ 8B"
LOOPBACK_BYTES = 4 * 1024  # configs[0] "2-rank 4KB send/recv loopback"


def _measure_pair_latency(ctx: WorkloadContext, src: int, dst: int,
                          nbytes: int):
    """Serialized samples and fused per-hop samples for one directed
    pair (empty on a rank outside a ``submesh`` pair)."""
    rt, cfg = ctx.rt, ctx.cfg
    mesh, axis = rt.mesh, "d"
    if src == dst:
        # A self-edge moves nothing between ranks: measure the launch +
        # whole-buffer rewrite floor instead; no transport is selected.
        fn = ctx.cache.loopback_chain(mesh, 1)
        chain = ctx.cache.loopback_chain(mesh, cfg.iters)
    else:
        edges = C.unidir_edges(src, dst)
        if cfg.isolation == "submesh":
            mesh = rt.submesh([src, dst])
            edges = ((0, 1),)
        if not mesh.is_member:
            return timing.Samples(), timing.Samples()
        fn = ctx.cache.permute(mesh, axis, edges, transport=cfg.transport)
        chain = ctx.cache.permute_chain(mesh, axis, edges, cfg.iters,
                                        transport=cfg.transport)
    x = ctx.payloads.get(mesh, nbytes, ctx.cfg.dtype)
    ser = timing.measure_serialized(
        fn, x, cfg.iters, warmup=max(1, cfg.warmup),
        timeout_s=cfg.timeout_s, barrier=mesh.barrier,
    )
    fused = timing.measure_fused(
        chain, x, cfg.iters, repeats=cfg.fused_repeats,
        warmup=max(1, cfg.warmup), timeout_s=cfg.timeout_s,
        barrier=mesh.barrier,
    )
    return ser, fused


@workload("latency")
def run_latency(ctx: WorkloadContext) -> dict:
    rt = ctx.rt
    n = rt.num_devices
    src, dst = (0, 1) if n > 1 else (0, 0)
    nbytes = (ctx.cfg.msg_size if ctx.cfg.msg_size is not None
              else LATENCY_BYTES)
    ser, fused = _measure_pair_latency(ctx, src, dst, nbytes)
    # The self-edge floor never selects a transport, so it names none.
    via = ("" if ctx.cfg.transport == "xla" or src == dst
           else f" via {ctx.cfg.transport}")
    if ctx.is_printer:
        sys.stdout.write(
            f"latency {format_size(nbytes)}{via} {src}->{dst}: "
            f"p50 {ser.p50 * 1e6:.2f}us  p99 {ser.p99 * 1e6:.2f}us  "
            f"min {ser.min * 1e6:.2f}us (serialized, dispatch-inclusive); "
            f"per-hop {fused.mean * 1e6:.2f}us (fused device chain)\n"
        )
        sys.stdout.flush()
    ctx.record(
        cell_record(
            ctx, workload="latency", direction="uni", src=src, dst=dst,
            msg_bytes=nbytes, gbps_val=timing.gbps(nbytes, ser.mean_region),
            samples=ser, fused_hop_s=fused.mean,
        )
    )
    return {
        "src": src, "dst": dst, "bytes": nbytes,
        "p50_us": ser.p50 * 1e6, "p99_us": ser.p99 * 1e6,
        "fused_hop_us": fused.mean * 1e6,
    }


@workload("loopback")
def run_loopback(ctx: WorkloadContext) -> dict:
    """configs[0]: 2-rank 4 KiB exchange on one host (self-edge when the
    world has one rank — the launch + copy floor)."""
    rt = ctx.rt
    n = rt.num_devices
    src, dst = 0, 0
    for i in range(1, n):
        if rt.placement.host_of[i] == rt.placement.host_of[0]:
            src, dst = 0, i
            break
    nbytes = (ctx.cfg.msg_size if ctx.cfg.msg_size is not None
              else LOOPBACK_BYTES)
    ser, fused = _measure_pair_latency(ctx, src, dst, nbytes)
    bw = timing.gbps(nbytes, ser.mean_region)
    if ctx.is_printer:
        kind = "self-edge" if src == dst else "intra-host pair"
        sys.stdout.write(
            f"loopback ({kind} {src}->{dst}) {format_size(nbytes)}: "
            f"{bw:6.02f} Gbps  p50 {ser.p50 * 1e6:.2f}us  "
            f"per-hop {fused.mean * 1e6:.2f}us (fused)\n"
        )
        sys.stdout.flush()
    ctx.record(
        cell_record(
            ctx, workload="loopback", direction="uni", src=src, dst=dst,
            msg_bytes=nbytes, gbps_val=bw, samples=ser,
            fused_hop_s=fused.mean,
        )
    )
    return {"src": src, "dst": dst, "bytes": nbytes, "gbps": bw,
            "p50_us": ser.p50 * 1e6}
