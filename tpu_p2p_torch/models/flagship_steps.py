"""Flagship train steps: SGD on the regression (MSE) or the LM
cross-entropy objective — the port of the GPipe-autodiff steps of
``tpu_p2p/models/flagship_steps.py``.

Each builder returns a plain function of this rank's shards. Gradients
come from ``torch.autograd.grad`` over the local loss; the collectives
inside the forward (pipeline hops, ring hops, Ulysses reshards, the tp
joins and their conjugates) carry their own backward. What ``shard_map``
autodiff adds in the reference is spelled out after the backward: every
leaf is replicated over the data axes (dp, ep, sp), so its gradient is
summed over them (:func:`~tpu_p2p_torch.parallel.collectives.
all_reduce_flat`, one collective a dtype), and so is the loss. The
builders take ``mesh=None`` for a world of one. ``donate=True`` (the
reference's buffer donation) becomes an in-place update: the step
writes the new values into the params it was given, under ``no_grad``,
and returns that same dict.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from tpu_p2p_torch.models.flagship_config import (
    FlagshipConfig,
    _data_axes,
    _mesh_axes,
)
from tpu_p2p_torch.models.flagship_forward import (
    _check_ported,
    _forward_local,
    _lm_logits_local,
)
from tpu_p2p_torch.models.flagship_params import Params
from tpu_p2p_torch.parallel.collectives import all_reduce_flat

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


def _data_plane(mesh):
    """This rank's plane over the data axes, or None for a world of
    one. Made when a step is built, on every rank alike."""
    if mesh is None:
        return None
    return mesh.plane(_data_axes(mesh.axis_names))


def _value_and_grad(loss_fn, params: Params, plane):
    """``(loss, grads)`` of ``loss_fn(params)`` w.r.t. every leaf,
    without touching the leaves' ``.grad``; both summed over the data
    ``plane`` after the backward (the gradients in one collective a
    dtype)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    loss = loss.detach()
    if plane is not None and plane.size > 1:
        all_reduce_flat(list(grads.values()) + [loss.reshape(1)], plane,
                        "the gradient all-reduce")
    return loss, grads


def make_flagship_grad_fn(cfg: FlagshipConfig, mesh=None):
    """``(params, x, target) → (grads, loss)`` of this rank's shards: the
    global sum of squared error of the block stack and its gradients."""
    _check_ported(cfg)
    _reject_zb_schedule(cfg)
    axes = _mesh_axes(mesh)
    plane = _data_plane(mesh)

    def grad_fn(params: Params, x: torch.Tensor, target: torch.Tensor):
        def local_loss(p):
            out = _forward_local(p, x, cfg, axes)
            return torch.sum((out.float() - target.float()) ** 2)

        loss, grads = _value_and_grad(local_loss, params, plane)
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
    _check_ported(cfg)
    _reject_zb_schedule(cfg)
    axes = _mesh_axes(mesh)
    plane = _data_plane(mesh)

    def grad_fn(params: Params, tokens: torch.Tensor,
                targets: torch.Tensor):
        def local_loss(p):
            logits = _lm_logits_local(p, tokens, cfg, axes)
            m = logits.amax(dim=-1, keepdim=True).detach()
            lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m),
                                                  dim=-1))
            tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
            return torch.sum(lse - tgt)

        loss, grads = _value_and_grad(local_loss, params, plane)
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
