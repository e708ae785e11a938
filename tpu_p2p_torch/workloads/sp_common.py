"""Shared setup and measurement of the sequence-parallel attention
patterns (``ring_attention``, ``ulysses_attention``) — the port's copy
of ``tpu_p2p/workloads/sp_common.py``.

Both patterns time one attention step over the first mesh axis and
differ only in transport (the ring's shift-by-1 hops, Ulysses'
head <-> sequence all-to-alls), so the QKV staging, the timing and the
FLOP count live here once. Sizes follow the **sharded axis's size**
(``mesh.shape[axis]``), not the world's: on ``--mesh-shape 4x2`` the
collectives span the first axis only.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpu_p2p_torch.models.flagship_params import torch_dtype
from tpu_p2p_torch.models.ring_transformer import ModelConfig
from tpu_p2p_torch.ops import attention as A
from tpu_p2p_torch.parallel.runtime import local_shard
from tpu_p2p_torch.utils import timing
from tpu_p2p_torch.workloads.base import WorkloadContext


def bench_sp_attention(
    ctx: WorkloadContext,
    model_cfg: Optional[ModelConfig],
    default_heads: Callable[[int], int],
    build_fn: Callable,  # (mesh, axis, mc) -> fn(q, k, v) of the blocks
) -> Tuple[ModelConfig, str, int, timing.Samples, float]:
    """Stage this rank's QKV blocks (:func:`stage_qkv`), time
    ``build_fn``'s attention in the serialized loop, → ``(mc, axis,
    axis_size, samples, tflops)``."""
    rt, cfg = ctx.rt, ctx.cfg
    axis = rt.mesh.axis_names[0]
    n = rt.mesh.shape[axis]
    # Default seq: >= 512 and a multiple of the axis size (any size, not
    # just powers of two), from the same rule as the head count.
    seq = 64 * heads_multiple_of(n)
    mc = model_cfg or ModelConfig(seq=seq, heads=default_heads(n))
    q, k, v = stage_qkv(mc, cfg.seed, rt.mesh, axis, rt.device)
    fn = build_fn(rt.mesh, axis, mc)
    s = timing.measure_serialized(
        lambda args: fn(*args), (q, k, v), cfg.iters,
        warmup=max(1, cfg.warmup), timeout_s=cfg.timeout_s,
        barrier=rt.barrier,
    )
    flops = A.flops_per_step(
        mc.batch, mc.heads, mc.seq, mc.head_dim, causal=mc.causal,
        window=cfg.window if mc.causal else None,
    )
    step_s = s.p50
    tflops = flops / step_s / 1e12 if step_s == step_s else float("nan")
    return mc, axis, n, s, tflops


def stage_qkv(mc: ModelConfig, seed: int, mesh, axis: str, device
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's ``T`` blocks along ``axis`` of the global q, k and v
    ``[B, H, T, D]``: the reference's three ``standard_normal`` draws
    from ``default_rng(seed)``, in that order, rounded from float64 to
    ``mc.dtype`` on the host, on ``device``."""
    rng = np.random.default_rng(seed)
    shape = (mc.batch, mc.heads, mc.seq, mc.head_dim)
    spec = A.attention_sharding(mesh, axis)
    dtype = torch_dtype(mc.dtype)
    return tuple(
        local_shard(torch.from_numpy(rng.standard_normal(shape)).to(dtype),
                    mesh, spec).contiguous().to(device)
        for _ in range(3)
    )


def heads_multiple_of(n: int, target: int = 8) -> int:
    """Smallest multiple of ``n`` that is >= ``target`` — a head count
    that always meets Ulysses' divisibility rule."""
    return n * math.ceil(target / n)
