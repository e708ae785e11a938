"""Flagship train steps: SGD on the regression (MSE) or the LM
cross-entropy objective — the port of the GPipe-autodiff steps of
``tpu_p2p/models/flagship_steps.py``.

Each builder returns a plain function of this rank's shards. Gradients
come from ``torch.autograd.grad`` over the local loss; the collectives
inside the forward (pipeline hops, ring hops, Ulysses reshards, the tp
joins and their conjugates, the ep all-to-alls) carry their own
backward. What ``shard_map`` autodiff adds in the reference is spelled
out after the backward: a leaf's gradient is summed over the data axes
(dp, ep, sp) that its spec does not split — every leaf over all three,
but the experts (``we1``, ``we2``, split over ep) over (dp, sp) only,
since each ep member holds other experts — in one collective a dtype a
plane (:func:`~tpu_p2p_torch.parallel.collectives.all_reduce_flat`),
and the loss over all three. Under ``cfg.zero_dp`` the ZeRO gathers sit
inside the differentiated loss (:func:`_fsdp_prepare`): their backward
is the reduce-scatter over dp, so a dp-split leaf's gradient arrives as
its shard, already summed over dp, and its plane leaves dp out. The
builders take ``mesh=None`` for a world of one. ``donate=True`` (the
reference's buffer donation) becomes an in-place update: the step
writes the new values into the params (or their shards) it was given,
under ``no_grad``, and returns that same dict.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from tpu_p2p_torch.models.flagship_config import (
    FlagshipConfig,
    _data_axes,
    _mesh_axes,
)
from tpu_p2p_torch.models.flagship_forward import (
    _forward_local,
    _fsdp_prepare,
    _lm_logits_local,
)
from tpu_p2p_torch.models.flagship_params import (
    Params,
    _fsdp_plan,
    flagship_param_specs,
)
from tpu_p2p_torch.parallel.collectives import all_reduce_flat
from tpu_p2p_torch.parallel.runtime import _dim_axes

Step = Callable[..., Tuple[Params, torch.Tensor]]


def _sgd_update(params: Params, grads: Dict[str, torch.Tensor], lr: float,
                denom: float, *, in_place: bool = False) -> Params:
    """``p - lr*g/denom`` in float32, cast back to each param's dtype —
    the one SGD update every step shares.

    The reference's promotion, exactly: under JAX's weak typing
    ``lr * g / denom`` is taken in the GRAD's dtype, with ``lr`` and
    ``denom`` first rounded to that dtype (bf16 grads: bf16 constants,
    a bf16 rounding after each op), and only then widened for the
    float32 subtraction. A Python scalar would enter torch's bf16
    arithmetic unrounded, so both constants are made 0-dim tensors of
    the grad's dtype. ``in_place``: write into ``params`` (under
    ``no_grad``) and return it.
    """
    out = params if in_place else {}
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            lr_t = torch.tensor(lr, dtype=g.dtype)
            denom_t = torch.tensor(denom, dtype=g.dtype)
            new = (p.float() - lr_t * g / denom_t).to(p.dtype)
            if in_place:
                p.copy_(new)
            else:
                out[k] = new
    return out


def _reject_zb_schedule(cfg: FlagshipConfig) -> None:
    """The GPipe steps differentiate through the schedule, so there are
    no backward ticks to split (``pp_schedule="zb"``) or dispatch
    (``tick_lowering="switch"``): those run on the reference's tick-IR
    executor, which the port does not have yet. A label here would time
    the autodiff schedule under another name. (The config refuses both
    values before this; the check keeps the reference's contract.)"""
    if cfg.pp_schedule == "zb":
        raise ValueError(
            "pp_schedule='zb' runs on the tick-IR executor; the GPipe "
            "autodiff steps have no backward ticks to split")
    if cfg.tick_lowering != "masked":
        raise ValueError(
            f"tick_lowering={cfg.tick_lowering!r} runs on the tick-IR "
            "executor; the GPipe autodiff steps run a masked schedule")


class _GradPlanes:
    """Where a step's sums run: ``loss`` is this rank's plane over every
    data axis; ``leaf`` maps each leaf to its plane over the data axes
    its spec does not split (the reference's ``shard_map`` rule) — for
    the experts, split over ep, that is (dp, sp); for a ZeRO leaf, split
    over dp, its reduce-scatter has summed over dp already. Made when a
    step is built, on every rank alike (``new_group`` is collective)."""

    def __init__(self, cfg: FlagshipConfig, mesh) -> None:
        data = _data_axes(mesh.axis_names)
        self.loss = mesh.plane(data)
        self.leaf = {}
        for k, spec in flagship_param_specs(mesh, cfg).items():
            split = {a for entry in spec for a in _dim_axes(entry)}
            self.leaf[k] = mesh.plane(
                tuple(a for a in data if a not in split))


def _grad_planes(cfg: FlagshipConfig, mesh) -> Optional[_GradPlanes]:
    """The step's planes, or None for a world of one."""
    return None if mesh is None else _GradPlanes(cfg, mesh)


def _value_and_grad(loss_fn, params: Params,
                    planes: Optional[_GradPlanes]):
    """``(loss, grads)`` of ``loss_fn(params)`` w.r.t. every leaf,
    without touching the leaves' ``.grad``; after the backward the loss
    is summed over the data plane and each gradient over its leaf's
    plane, one collective a dtype a plane, the planes in leaf order
    (the same on every rank)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    loss = loss.detach()
    if planes is None:
        return loss, grads
    by_plane = {planes.loss.ranks: (planes.loss, [loss.reshape(1)])}
    for k, g in grads.items():
        plane = planes.leaf[k]
        by_plane.setdefault(plane.ranks, (plane, []))[1].append(g)
    for plane, tensors in by_plane.values():
        if plane.size > 1:
            all_reduce_flat(tensors, plane, "the gradient all-reduce")
    return loss, grads


def make_flagship_grad_fn(cfg: FlagshipConfig, mesh=None):
    """``(params, x, target) → (grads, loss)`` of this rank's shards: the
    global sum of squared error of the block stack and its gradients,
    each shaped like its param's shard (ZeRO shards included)."""
    _reject_zb_schedule(cfg)
    axes = _mesh_axes(mesh)
    planes = _grad_planes(cfg, mesh)
    plan = _fsdp_plan(mesh, cfg)

    def grad_fn(params: Params, x: torch.Tensor, target: torch.Tensor):
        def local_loss(p):
            p, prefetch = _fsdp_prepare(p, cfg, plan, axes["dp"])
            out = _forward_local(p, x, cfg, axes, prefetch)
            return torch.sum((out.float() - target.float()) ** 2)

        loss, grads = _value_and_grad(local_loss, params, planes)
        return grads, loss

    return grad_fn


def make_flagship_train_step(cfg: FlagshipConfig, lr: float = 1e-2,
                             donate: bool = False, mesh=None) -> Step:
    """One SGD step on the MSE objective: ``(params, x, target) →
    (params, loss / (B·T·Dm))`` (global sizes). ``donate=True`` updates
    ``params`` in place (the caller keeps using the returned dict, as
    with the reference's donated buffers)."""
    grad_fn = make_flagship_grad_fn(cfg, mesh)
    n_out = cfg.batch * cfg.seq * cfg.model_dim

    def step(params: Params, x: torch.Tensor, target: torch.Tensor):
        grads, loss = grad_fn(params, x, target)
        return (_sgd_update(params, grads, lr, n_out, in_place=donate),
                loss / n_out)

    return step


def make_flagship_lm_grad_fn(cfg: FlagshipConfig, mesh=None):
    """``(params, tokens, targets) → (grads, summed CE)`` — the LM twin
    of :func:`make_flagship_grad_fn`. Cross-entropy in the logsumexp
    form with the row max detached, so no ``[B, T, V]`` log-softmax is
    built."""
    if not cfg.vocab:
        raise ValueError("cfg.vocab must be > 0 for the LM step")
    _reject_zb_schedule(cfg)
    axes = _mesh_axes(mesh)
    planes = _grad_planes(cfg, mesh)
    plan = _fsdp_plan(mesh, cfg)

    def grad_fn(params: Params, tokens: torch.Tensor,
                targets: torch.Tensor):
        def local_loss(p):
            p, prefetch = _fsdp_prepare(p, cfg, plan, axes["dp"])
            logits = _lm_logits_local(p, tokens, cfg, axes, prefetch)
            m = logits.amax(dim=-1, keepdim=True).detach()
            lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m),
                                                  dim=-1))
            tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
            return torch.sum(lse - tgt)

        loss, grads = _value_and_grad(local_loss, params, planes)
        return grads, loss

    return grad_fn


def make_flagship_lm_train_step(cfg: FlagshipConfig, lr: float = 1e-2,
                                donate: bool = False, mesh=None) -> Step:
    """One SGD step on next-token cross-entropy: ``(params, tokens
    [B, T], targets [B, T]) → (params, mean CE)`` (the caller shifts
    targets; global B·T). ``donate`` as in
    :func:`make_flagship_train_step`."""
    grad_fn = make_flagship_lm_grad_fn(cfg, mesh)
    n_tok = cfg.batch * cfg.seq

    def step(params: Params, tokens: torch.Tensor, targets: torch.Tensor):
        grads, loss = grad_fn(params, tokens, targets)
        return (_sgd_update(params, grads, lr, n_tok, in_place=donate),
                loss / n_tok)

    return step
