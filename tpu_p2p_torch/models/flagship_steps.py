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

import contextlib
import re
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
from tpu_p2p_torch.obs import ledger as _obs
from tpu_p2p_torch.parallel.collectives import _record, all_reduce_flat
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
    """The GPipe steps differentiate through the schedule, so there is
    no backward tick to split (``pp_schedule="zb"``) or dispatch
    (``tick_lowering="switch"``): a run here would time the autograd
    schedule under another name. Both run on the tick-IR executor
    (:func:`~tpu_p2p_torch.models.flagship_1f1b.
    make_flagship_train_step_1f1b`). The reference's messages."""
    if cfg.pp_schedule == "zb":
        raise ValueError(
            "pp_schedule='zb' runs on the switch-lowered tick-IR "
            "executor (make_flagship_train_step_1f1b, which compiles "
            "zb through schedule.lower() with the ZB-H1 weight "
            "split); the GPipe autodiff steps have no backward ticks "
            "to split"
        )
    if cfg.tick_lowering != "masked":
        raise ValueError(
            f"tick_lowering={cfg.tick_lowering!r} runs on the tick-IR "
            "executor (make_flagship_train_step_1f1b, which lowers "
            "every schedule through schedule.lower()); the GPipe "
            "autodiff steps run a masked scan with no per-rank tick "
            "timeline to dispatch over"
        )


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
            # The loss rides its plane's flat all-reduce, the ledger's row.
            with (_record("all_reduce", plane, loss, label="loss_allreduce")
                  if plane is planes.loss else contextlib.nullcontext()):
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

    return _obs.program(step)


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

    return _obs.program(step)


# ------------------------------------------------ the optax-style step


def make_flagship_optax_step(cfg: FlagshipConfig, tx, lm: bool = False,
                             donate: bool = False, mesh=None):
    """One step under a transformation of
    :mod:`tpu_p2p_torch.utils.optim`: ``(params, opt_state, x, target) →
    (params, opt_state, loss)``. The gradients (summed over the data
    planes as in the SGD steps) are divided by the global count in their
    own dtype, transformed, and added to the params in the param dtype
    (``optim.apply_updates``; no float32 widening, unlike
    :func:`_sgd_update`). Every update is elementwise on this rank's
    shards, so the moments are shaped like the shards (ZeRO's dp shards
    included); a clipping transformation needs
    :func:`global_norm_reducer`'s ``reduce`` on a mesh. ``lm=True``
    trains next-token CE (``cfg.vocab > 0``); ``donate=True`` writes the
    new params into those given."""
    from tpu_p2p_torch.utils.optim import apply_updates

    if lm:
        grad_fn = make_flagship_lm_grad_fn(cfg, mesh)
        n_out = cfg.batch * cfg.seq
    else:
        grad_fn = make_flagship_grad_fn(cfg, mesh)
        n_out = cfg.batch * cfg.seq * cfg.model_dim

    def step(params: Params, opt_state, x: torch.Tensor,
             target: torch.Tensor):
        grads, loss = grad_fn(params, x, target)
        with torch.no_grad():
            grads = {k: g / torch.tensor(n_out, dtype=g.dtype)
                     for k, g in grads.items()}
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates(params, updates, in_place=donate)
        return params, opt_state, loss / n_out

    return _obs.program(step)


def init_optimizer(tx, params: Params):
    """``tx.init`` of this rank's shards: each moment is shaped like its
    param's shard on the param's device (so ZeRO moments are dp shards);
    the counts are int32 scalars on the host."""
    return tx.init(params)


def global_norm_reducer(cfg: FlagshipConfig, mesh):
    """The ``reduce`` of ``optim.clip_by_global_norm`` on ``mesh``: each
    leaf's float32 sum of squares is summed over the plane of the axes
    its spec SPLITS it along (tp, pp, ep for the experts, dp for a ZeRO
    leaf) — the complement of :class:`_GradPlanes`' — so a replicated
    copy counts once and every rank gets the same norm. One collective a
    plane, planes in leaf order; made when the step is built, on every
    rank alike. None without a mesh."""
    if mesh is None:
        return None
    planes = {}
    for k, spec in flagship_param_specs(mesh, cfg).items():
        split = {a for entry in spec for a in _dim_axes(entry)}
        planes[k] = mesh.plane(tuple(a for a in mesh.axis_names
                                     if a in split))

    def reduce(sums: Dict[str, torch.Tensor]) -> None:
        by_plane = {}
        for k in sorted(sums):
            plane = planes[k]
            by_plane.setdefault(plane.ranks, (plane, []))[1].append(sums[k])
        for plane, tensors in by_plane.values():
            if plane.size > 1:
                all_reduce_flat(tensors, plane, "the global-norm sum")

    return reduce


_PARAM_KEY = re.compile(r"\['([^']+)'\]$")


def _param_of(path: str):
    """The param a state leaf belongs to (its innermost dict key), or
    None for a count."""
    m = _PARAM_KEY.search(path)
    return m.group(1) if m else None


def opt_state_template(tx, cfg: FlagshipConfig):
    """The global state's structure and shapes on the ``meta`` device
    (no memory): the template a checkpoint's state loads into."""
    from tpu_p2p_torch.models.flagship_params import (flagship_param_shapes,
                                                       torch_dtype)

    dtype = torch_dtype(cfg.params_dtype)
    return tx.init({k: torch.empty(s, dtype=dtype, device="meta")
                    for k, s in flagship_param_shapes(cfg).items()})


def place_opt_state(state, mesh, cfg: FlagshipConfig, device):
    """This rank's shard of each moment of a global state on ``device``
    (the param's spec, ZeRO's with ``cfg.zero_dp``); counts stay on the
    host. ``mesh=None``: the whole moments on ``device``."""
    from tpu_p2p_torch.parallel.runtime import local_shard
    from tpu_p2p_torch.utils.optim import tree_map_leaves

    specs = None if mesh is None else flagship_param_specs(mesh, cfg)

    def place(path, leaf):
        name = _param_of(path)
        if name is None:
            return leaf.cpu()
        if specs is not None:
            leaf = local_shard(leaf, mesh, specs[name])
        return leaf.contiguous().to(device)

    return tree_map_leaves(place, state)


def gather_opt_state(state, mesh, cfg: FlagshipConfig):
    """The global state from every rank's moment shards (the inverse of
    :func:`place_opt_state`; collective over the mesh, leaves in flatten
    order). ``mesh=None``: ``state`` itself."""
    from tpu_p2p_torch.models.flagship_params import gather_leaf
    from tpu_p2p_torch.utils.optim import tree_map_leaves

    if mesh is None:
        return state
    specs = flagship_param_specs(mesh, cfg)

    def gather(path, leaf):
        name = _param_of(path)
        return leaf if name is None else gather_leaf(leaf, mesh, specs[name])

    return tree_map_leaves(gather, state)


def opt_state_from_numpy(np_leaves, template, *, paths=None):
    """The weight carry for optimizer state: the reference's optax state
    flattened to numpy (``[np.asarray(v) for v in
    jax.tree_util.tree_leaves(state)]``, with ``paths`` its ``keystr``
    strings when given) → the port's state in ``template``'s structure,
    each leaf on its template leaf's device. Bitwise for float32 and
    bfloat16."""
    from tpu_p2p_torch.models.flagship_params import tensor_from_numpy
    from tpu_p2p_torch.utils.optim import (leaf_paths,
                                           tree_flatten_with_path,
                                           tree_unflatten)

    flat = tree_flatten_with_path(template)
    if len(np_leaves) != len(flat):
        raise ValueError(f"{len(np_leaves)} leaves for a state of "
                         f"{len(flat)}")
    if paths is not None and list(paths) != leaf_paths(template):
        raise ValueError(f"leaf paths {list(paths)} vs the port's "
                         f"{leaf_paths(template)}")
    return tree_unflatten(template, [tensor_from_numpy(a, t.device)
                                     for a, (_, t) in zip(np_leaves, flat)])
