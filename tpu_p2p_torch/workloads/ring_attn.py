"""``ring_attention`` — sequence-parallel attention over the ring's
transport; the port's copy of ``tpu_p2p/workloads/ring_attn.py``.

Where ``ring`` times the bare shift-by-1 hop, this pattern runs ring
attention over it (:func:`tpu_p2p_torch.ops.attention.ring_attention`;
``--flash``: each hop's fold in the flash kernel) and reports the step
time, the attention FLOP/s and the KV bytes each rank ships a step.
"""

from __future__ import annotations

import sys

from tpu_p2p_torch.models.ring_transformer import ModelConfig
from tpu_p2p_torch.ops import attention as A
from tpu_p2p_torch.utils import timing
from tpu_p2p_torch.workloads.base import WorkloadContext, cell_record, \
    workload
from tpu_p2p_torch.workloads.sp_common import bench_sp_attention


@workload("ring_attention")
def run_ring_attention(ctx: WorkloadContext,
                       model_cfg: ModelConfig = None) -> dict:
    cfg = ctx.cfg
    window = cfg.window
    mc, axis, n, s, tflops = bench_sp_attention(
        ctx, model_cfg, default_heads=lambda n: 8,
        build_fn=lambda mesh, ax, m: A.ring_attention(
            mesh, ax, m.causal, use_flash=cfg.use_flash, window=window
        ),
    )
    hop_bytes = A.kv_bytes_per_hop(
        mc.batch, mc.heads, mc.seq // n, mc.head_dim, mc.dtype
    )
    # A windowed contiguous ring rotates through its live hops only, so
    # the shipped bytes drop with the window.
    hops = A.live_ring_hops(n, mc.seq // n, mc.causal, "contiguous",
                            window)
    comm_gbps = timing.gbps(hop_bytes * hops, s.mean_region)
    if ctx.is_printer:
        wtxt = f"W{window} " if window else ""
        sys.stdout.write(
            f"ring_attention B{mc.batch} H{mc.heads} T{mc.seq} D{mc.head_dim} "
            f"{'causal ' if mc.causal else ''}{wtxt}over {n} devices: "
            f"p50 {s.p50 * 1e3:.2f}ms/step  {tflops:.3f} TFLOP/s  "
            f"{hop_bytes} KV bytes/hop x {hops} hops "
            f"({comm_gbps:.2f} Gbps overlapped)\n"
        )
        sys.stdout.flush()
    ctx.record(
        cell_record(
            ctx, workload="ring_attention", direction="uni", src=0,
            dst=1 % n, msg_bytes=hop_bytes, gbps_val=comm_gbps, samples=s,
            seq=mc.seq, batch=mc.batch, heads=mc.heads,
            head_dim=mc.head_dim, tflops=tflops, causal=mc.causal,
            ring_hops=hops, attn_window=window,
        )
    )
    return {
        "devices": n, "seq": mc.seq, "p50_ms": s.p50 * 1e3,
        "tflops": tflops, "kv_bytes_per_hop": hop_bytes, "hops": hops,
        "comm_gbps_overlapped": comm_gbps,
    }
