"""``ulysses_attention`` — sequence-parallel attention over all-to-all
reshards; the port's copy of ``tpu_p2p/workloads/ulysses_attn.py``.

The counterpart of ``ring_attention`` on the other transport: three
all-to-alls bring every rank the whole sequence for its heads, one
attention runs there (``--flash``: the flash kernel), one all-to-all
takes the output back (:func:`tpu_p2p_torch.ops.ulysses.
ulysses_attention`).
"""

from __future__ import annotations

import sys

from tpu_p2p_torch.models.ring_transformer import ModelConfig
from tpu_p2p_torch.ops import ulysses as U
from tpu_p2p_torch.utils import timing
from tpu_p2p_torch.workloads.base import WorkloadContext, cell_record, \
    workload
from tpu_p2p_torch.workloads.sp_common import bench_sp_attention, \
    heads_multiple_of


@workload("ulysses_attention")
def run_ulysses_attention(ctx: WorkloadContext,
                          model_cfg: ModelConfig = None) -> dict:
    rt = ctx.rt
    axis = rt.mesh.axis_names[0]
    axis_size = rt.mesh.shape[axis]
    if model_cfg is not None and model_cfg.heads % axis_size:
        raise ValueError(
            f"ulysses_attention needs heads ({model_cfg.heads}) divisible "
            f"by the sharded axis size ({axis_size}); pass a compatible "
            "model or use ring_attention"
        )
    mc, axis, n, s, tflops = bench_sp_attention(
        ctx, model_cfg, default_heads=heads_multiple_of,
        build_fn=lambda mesh, ax, m: U.ulysses_attention(
            mesh, ax, m.causal, use_flash=ctx.cfg.use_flash,
            window=ctx.cfg.window,
        ),
    )
    reshard_bytes = U.a2a_bytes_per_reshard(
        mc.batch, mc.heads, mc.seq, mc.head_dim, n, mc.dtype
    )
    comm_gbps = timing.gbps(reshard_bytes * 4, s.mean_region)  # q,k,v in + out
    if ctx.is_printer:
        sys.stdout.write(
            f"ulysses_attention B{mc.batch} H{mc.heads} T{mc.seq} "
            f"D{mc.head_dim} {'causal ' if mc.causal else ''}over {n} "
            f"devices: p50 {s.p50 * 1e3:.2f}ms/step  {tflops:.3f} "
            f"TFLOP/s  {reshard_bytes} B/reshard x 4 reshards "
            f"({comm_gbps:.2f} Gbps overlapped)\n"
        )
        sys.stdout.flush()
    ctx.record(
        cell_record(
            ctx, workload="ulysses_attention", direction="uni", src=0,
            dst=1 % n, msg_bytes=reshard_bytes, gbps_val=comm_gbps,
            samples=s, seq=mc.seq, batch=mc.batch, heads=mc.heads,
            head_dim=mc.head_dim, tflops=tflops, causal=mc.causal,
        )
    )
    return {
        "devices": n, "seq": mc.seq, "p50_ms": s.p50 * 1e3,
        "tflops": tflops, "bytes_per_reshard": reshard_bytes,
        "comm_gbps_overlapped": comm_gbps,
    }
