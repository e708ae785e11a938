"""The flagship step under the tick-IR executor: 1F1B, interleaved and
zero-bubble, masked or switch — the port of
``tpu_p2p/models/flagship_1f1b.py``.

The stage block is the flagship's (:func:`~tpu_p2p_torch.models.
flagship_forward._stage_block`: attention by the sp strategy, the tp
joins, the dense or MoE FFN over ep), run by
:func:`~tpu_p2p_torch.models.schedule.tick_grads_local` on this rank's
pp line with the block's weight products going through the ZB split's
store (:mod:`~tpu_p2p_torch.models.zb_split`). Params use the
device-major chunk layout (:func:`place_flagship_params_pipelined`);
``chunks > 1`` gives the interleaved virtual-stage schedule,
``cfg.pp_schedule="zb"`` the ZB-H1 program and ``cfg.tick_lowering`` the
lowering.

Gradient accounting. The reference's per-tick ``jax.vjp`` inside
``shard_map`` sums each cotangent over the data axes its primal does not
vary on, implicitly, at every tick (an explicit psum there doubled dp
gradients). The port has no implicit sum: the collectives inside the
block carry their own backward (the tp conjugates, the sp hops, the ep
all-to-alls), and after the ticks each leaf's float32 gradient is summed
once over the plane of the data axes its spec does not split
(:class:`~tpu_p2p_torch.models.flagship_steps._GradPlanes`), the loss
once over all of them — one collective a dtype a plane.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_p2p_torch.models.flagship_config import FlagshipConfig, _mesh_axes
from tpu_p2p_torch.models.flagship_forward import _stage_block
from tpu_p2p_torch.models.flagship_params import (
    Params,
    flagship_param_specs,
    gather_leaf,
    local_shard,
    tensor_from_numpy,
)
from tpu_p2p_torch.models.flagship_steps import _GradPlanes, _sgd_update
from tpu_p2p_torch.models.pipeline_interleaved import device_major_perm
from tpu_p2p_torch.parallel.collectives import all_reduce_flat


def _pp_size(mesh) -> int:
    axes = _mesh_axes(mesh)
    return axes["pp"].size if axes["pp"] is not None else 1


def place_flagship_params_pipelined(params, mesh, cfg: FlagshipConfig,
                                    chunks: int = 1, device=None) -> Params:
    """This rank's shard of stage-major params (the reference's numpy
    arrays, carried bitwise, or tensors) in the 1F1B device-major
    layout, on ``device`` (default: the mesh's).

    ``chunks`` must match the train step's: the layouts have one shape,
    so a mismatch trains silently wrong (:class:`FlagshipPipelined`
    carries it once)."""
    if cfg.vocab:
        raise ValueError(
            "vocab (the LM head) is unsupported with the 1F1B layout; "
            "the emb leaf has no stage axis to permute"
        )
    n = _pp_size(mesh)
    s_chunk = cfg.stages // (n * chunks)
    perm = device_major_perm(n, chunks, s_chunk)
    specs = flagship_param_specs(mesh, cfg)
    dev = device if device is not None else mesh.device
    out = {}
    for k, v in params.items():
        t = v if isinstance(v, torch.Tensor) else tensor_from_numpy(v, "cpu")
        t = t[torch.as_tensor(perm, device=t.device)]
        out[k] = local_shard(t, mesh, specs[k]).contiguous().to(dev)
    return out


def unplace_flagship_params_pipelined(params: Params, mesh,
                                      cfg: FlagshipConfig,
                                      chunks: int = 1) -> Params:
    """Back to whole stage-major leaves on the CPU (for checkpoints and
    oracle checks): each leaf gathered over the mesh (collective: every
    rank calls it), then out of the device-major order."""
    n = _pp_size(mesh)
    s_chunk = cfg.stages // (n * chunks)
    perm = np.asarray(device_major_perm(n, chunks, s_chunk))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    specs = flagship_param_specs(mesh, cfg)
    return {k: gather_leaf(params[k], mesh, specs[k]).cpu()[
                torch.as_tensor(inv)]
            for k in sorted(params)}


class FlagshipPipelined:
    """The 1F1B flagship bundle: one object owns ``chunks``, so the
    parameter layout and the schedule cannot disagree.

    >>> fp = FlagshipPipelined(mesh, cfg, chunks=2, lr=1e-3)
    >>> params = fp.place(init_flagship_params(cfg, device="cpu"))
    >>> params, loss = fp.step(params, x, t)
    >>> host = fp.unplace(params)   # stage-major, for checkpoints
    """

    def __init__(self, mesh, cfg: FlagshipConfig, chunks: int = 1,
                 lr: float = 1e-2):
        self.mesh, self.cfg, self.chunks = mesh, cfg, chunks
        self.step = make_flagship_train_step_1f1b(mesh, cfg, lr=lr,
                                                  chunks=chunks)

    def place(self, params) -> Params:
        return place_flagship_params_pipelined(params, self.mesh, self.cfg,
                                               self.chunks)

    def unplace(self, params: Params) -> Params:
        return unplace_flagship_params_pipelined(params, self.mesh,
                                                 self.cfg, self.chunks)


def make_flagship_grad_fn_1f1b(mesh, cfg: FlagshipConfig, chunks: int = 1):
    """``(params, x, target) → (grads, summed squared error)`` of this
    rank's shards under the tick-IR executor: the float32 gradients of
    the global sum, each summed over its leaf's data plane, and the sum
    over the whole mesh (params from :func:`place_flagship_params_pipelined`
    with the same ``chunks``). The reference's refusals, word for word:
    zb with ``chunks != 1``, ``zero_dp``, ``vocab``, a mesh without pp,
    and the switch lowering where the stage block issues permute-family
    collectives (sp > 1, MoE over ep > 1, ``tp_overlap='ring'``). The
    reference refuses those because rank-divergent ``lax.switch``
    branches deadlock XLA's whole-mesh collective-permute; the port's
    NCCL send/recv over per-line groups may not share that limit, but it
    keeps the refusal (lifting it would be a feature the reference
    lacks)."""
    from tpu_p2p_torch.models.pipeline_1f1b import _mse_loss_grad
    from tpu_p2p_torch.models.schedule import (
        compile_interleaved,
        compile_zb,
        lower,
        tick_grads_local,
    )

    if cfg.pp_schedule == "zb" and chunks != 1:
        raise ValueError(
            "pp_schedule='zb' supports chunks=1 only (ZB-H1 splits "
            "the plain 1F1B schedule; interleaved virtual stages stay "
            "on pp_schedule='1f1b')"
        )
    if cfg.zero_dp:
        raise ValueError(
            "zero_dp is unsupported with the manual 1F1B step; use the "
            "GPipe train step (autodiff owns the ZeRO gather) or turn "
            "zero_dp off"
        )
    if cfg.vocab:
        raise ValueError(
            "vocab (the LM head) is unsupported with the manual 1F1B "
            "step; use make_flagship_lm_train_step (GPipe autodiff)"
        )
    axes = _mesh_axes(mesh)
    if axes["pp"] is None:
        raise ValueError("mesh needs a 'pp' axis for pipeline parallelism")
    if cfg.tick_lowering == "switch":
        blockers = []
        if axes["sp"] is not None and axes["sp"].size > 1:
            blockers.append(
                "sp>1 (sequence-parallel attention ships "
                "ppermutes/all_to_alls inside the block)")
        if (axes["ep"] is not None and axes["ep"].size > 1
                and not cfg.dense_ffn):
            blockers.append(
                "MoE ep>1 (dispatch/combine reshards inside the "
                "block)")
        if (axes["tp"] is not None and axes["tp"].size > 1
                and cfg.tp_overlap == "ring"):
            blockers.append(
                "tp_overlap='ring' (collective-matmul ppermutes "
                "inside the block)")
        if blockers:
            raise ValueError(
                "tick_lowering='switch' needs a stage block free of "
                "permute-family collectives (rank-divergent "
                "lax.switch branches deadlock a whole-mesh "
                "collective-permute rendezvous); keep "
                "tick_lowering='masked' here: " + "; ".join(blockers)
            )
    n = axes["pp"].size
    if cfg.stages % (n * chunks):
        raise ValueError(
            f"stages ({cfg.stages}) must divide by pp size ({n}) x "
            f"chunks ({chunks})"
        )
    s_chunk = cfg.stages // (n * chunks)
    prog = (compile_zb(cfg.microbatches, n)
            if cfg.pp_schedule == "zb"
            else compile_interleaved(cfg.microbatches, n, chunks))
    lowered = lower(prog, tick_lowering=cfg.tick_lowering)
    sp, tp, ep = axes["sp"], axes["tp"], axes["ep"]
    planes = _GradPlanes(cfg, mesh)

    def block_fn(chunk_params, x):
        return _stage_block(chunk_params, x, cfg, s_chunk, sp, tp, ep)

    def grad_fn(params: Params, x: torch.Tensor, target: torch.Tensor):
        b_loc = x.shape[0]
        if b_loc % cfg.microbatches:
            raise ValueError(
                f"local batch {b_loc} not divisible by "
                f"{cfg.microbatches} microbatches"
            )
        mb = b_loc // cfg.microbatches
        x_mb = x.reshape((cfg.microbatches, mb) + tuple(x.shape[1:]))
        t_mb = target.reshape((cfg.microbatches, mb)
                              + tuple(target.shape[1:]))
        loss, grads = tick_grads_local(
            block_fn, _mse_loss_grad, params, x_mb, t_mb, lowered,
            axes["pp"], chunk_rows=s_chunk, pp_overlap=cfg.pp_overlap,
            pp_chunks=cfg.pp_chunks)
        # Each sum once, after the ticks (module docstring).
        by_plane = {planes.loss.ranks: (planes.loss, [loss.reshape(1)])}
        for k in params:
            plane = planes.leaf[k]
            by_plane.setdefault(plane.ranks, (plane, []))[1].append(grads[k])
        for plane, tensors in by_plane.values():
            if plane.size > 1:
                all_reduce_flat(tensors, plane, "the gradient all-reduce")
        return grads, loss

    return grad_fn


def make_flagship_train_step_1f1b(mesh, cfg: FlagshipConfig,
                                  lr: float = 1e-2, chunks: int = 1):
    """The flagship SGD step on the MSE objective under the tick-IR
    executor: ``(params, x, target) → (params, loss / (B·T·Dm))`` of
    this rank's shards (:func:`make_flagship_grad_fn_1f1b`'s gradients,
    the refusals there)."""
    grad_fn = make_flagship_grad_fn_1f1b(mesh, cfg, chunks)
    n_out = cfg.batch * cfg.seq * cfg.model_dim

    def step(params: Params, x: torch.Tensor, target: torch.Tensor):
        grads, loss = grad_fn(params, x, target)
        return _sgd_update(params, grads, lr, n_out), loss / n_out

    return step
