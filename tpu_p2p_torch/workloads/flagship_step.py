"""``flagship_step`` — the composite train-step benchmark; the port's
copy of ``tpu_p2p/workloads/flagship_step.py``.

The transfer patterns time one collective at a time; this one times the
flagship's whole five-axis SGD step (:mod:`tpu_p2p_torch.models.
flagship`: GPipe hops over pp, ring or Ulysses sp, the tp joins, the
MoE all-to-alls over ep, the batch over dp) on the regression
objective, the number a training stack sees.

The benchmark world's ranks are laid over the five axes by
:func:`~tpu_p2p_torch.models.flagship_config.build_mesh` on the world
the CLI already joined (its groups reused, the new lines' groups made
in one order on every rank). Shapes come from
``FlagshipConfig().tiny(mesh)``, with ``--dtype float32|bfloat16``,
``--zero-dp [--overlap prefetch]`` and the ``--tp-overlap ring``,
``--ep-overlap ring`` and ``--pp-overlap wave`` knobs applied (each a
no-op where its axis has size 1); pass ``model_cfg`` for other shapes.
``--pp-schedule zb`` or ``--tick-lowering switch`` routes the step
through the tick-IR executor (:func:`~tpu_p2p_torch.models.
flagship_1f1b.make_flagship_train_step_1f1b`, device-major params), as
the reference does; under ``switch`` the block-internal axes (sp, tp,
ep) fold onto dp, since that executor refuses a stage block with
permute-family collectives there. Otherwise the step is the GPipe
autograd one.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from tpu_p2p_torch.utils import timing
from tpu_p2p_torch.workloads.base import WorkloadContext, cell_record, \
    workload


@workload("flagship_step")
def run_flagship_step(ctx: WorkloadContext, model_cfg=None) -> dict:
    from tpu_p2p_torch.models import flagship as F

    rt, cfg = ctx.rt, ctx.cfg
    dims = F.mesh_dims(rt.num_devices)
    if model_cfg is None and cfg.tick_lowering != "masked":
        # The switch dispatch refuses permute-family collectives inside
        # the stage block, so the block-internal axes (sp/tp/ep) land on
        # dp: every rank stays in the mesh, pp keeps its factor, and the
        # printed mesh shows the refolding (the reference's rule).
        pp = dims[F.AXES.index("pp")]
        dims = tuple(rt.num_devices // pp if a == "dp"
                     else (pp if a == "pp" else 1) for a in F.AXES)
    mesh = F.build_mesh(rt.num_devices, dims=dims, runtime=rt)
    mc = model_cfg or F.FlagshipConfig().tiny(mesh)
    if model_cfg is None and cfg.dtype in ("bfloat16", "float32"):
        mc = dataclasses.replace(mc, dtype=cfg.dtype)
    if model_cfg is None and (cfg.zero_dp or cfg.overlap != "none"):
        mc = dataclasses.replace(mc, zero_dp=True, overlap=cfg.overlap)
    if model_cfg is None:
        mc = dataclasses.replace(mc, tp_overlap=cfg.tp_overlap,
                                 ep_overlap=cfg.ep_overlap,
                                 pp_overlap=cfg.pp_overlap,
                                 pp_schedule=cfg.pp_schedule,
                                 tick_lowering=cfg.tick_lowering)
    host_params = F.init_flagship_params(mc, device="cpu")
    if mc.pp_schedule != "1f1b" or mc.tick_lowering != "masked":
        # The tick-IR executor owns the schedules and the lowerings:
        # device-major params, manual backward a tick.
        params = F.place_flagship_params_pipelined(host_params, mesh, mc)
        step = F.make_flagship_train_step_1f1b(mesh, mc)
    else:
        # mc places the params, so a zero_dp config's leaves hold their
        # dp shard from the start.
        params = F.place_flagship_params(host_params, mesh, mc)
        step = F.make_flagship_train_step(mc, mesh=mesh)
    spec = F.flagship_data_spec(mesh)
    x, t = (F.local_shard(a, mesh, spec).contiguous().to(rt.device)
            for a in F.flagship_host_batch(mc, np.random.default_rng(1)))

    state = {"params": params, "loss": None}

    def one_step(args):
        x, t = args
        state["params"], state["loss"] = step(state["params"], x, t)
        return state["loss"]  # params threaded, so the steps are real

    s = timing.measure_serialized(
        one_step, (x, t), cfg.iters,
        warmup=max(1, cfg.warmup), timeout_s=cfg.timeout_s,
        barrier=rt.barrier,
    )
    tokens = mc.batch * mc.seq
    tok_s = tokens / s.p50 if s.p50 == s.p50 and s.p50 > 0 else float("nan")
    axes = mesh.shape
    if ctx.is_printer:
        # Each knob rides the line only when it is not the default, as
        # the reference's does.
        knobs = "".join(f" {k}={v}" for k, v, default in (
            ("tp_overlap", mc.tp_overlap, "none"),
            ("ep_overlap", mc.ep_overlap, "none"),
            ("pp_overlap", mc.pp_overlap, "none"),
            ("pp_schedule", mc.pp_schedule, "1f1b"),
            ("tick_lowering", mc.tick_lowering, "masked")) if v != default)
        sys.stdout.write(
            f"flagship_step mesh {axes} {mc.sp_strategy}-SP "
            f"B{mc.batch} T{mc.seq} H{mc.heads} E{mc.num_experts} "
            f"S{mc.stages}x{mc.microbatches}mb {mc.dtype}{knobs}: "
            f"p50 {s.p50 * 1e3:.2f}ms/step  {tok_s:,.0f} tokens/s\n"
        )
        sys.stdout.flush()
    ctx.record(
        cell_record(
            ctx, workload="flagship_step", direction="uni", src=0, dst=0,
            msg_bytes=0, gbps_val=float("nan"), samples=s,
            mesh=str(axes), sp_strategy=mc.sp_strategy,
            batch=mc.batch, seq=mc.seq, tokens_per_s=tok_s,
            tp_overlap=mc.tp_overlap, ep_overlap=mc.ep_overlap,
            pp_overlap=mc.pp_overlap, pp_schedule=mc.pp_schedule,
            tick_lowering=mc.tick_lowering,
        )
    )
    loss = state["loss"]
    return {"mesh": axes, "p50_ms": s.p50 * 1e3, "tokens_per_s": tok_s,
            "loss": float(loss) if loss is not None else float("nan")}
