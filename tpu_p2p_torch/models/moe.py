"""Mixture-of-Experts FFN with expert parallelism over an ``ep`` line —
the port of ``tpu_p2p/models/moe.py``.

A Switch-style (top-1) or GShard-style (top-2) routed FFN whose experts
may be split over a mesh line, as ``ops/ulysses.py`` splits heads:

- **Routing** runs in float32 in fixed-width groups
  (``MoEConfig.group_size``) with a static per-expert capacity ``C`` a
  group; the tail group is padded with rows that take no capacity.
  Choices over capacity are dropped: their output is zero and the
  caller's residual carries them. The slot a choice takes is the
  reference's cumsum position, computed here on integers.
- **Dispatch** writes each kept token into its slot of group-major
  ``[E, N·C, D]`` buffers. The reference multiplies by a one-hot
  dispatch tensor; each slot holds at most one token, so an index copy
  gives the same values and skips the ``[N, gs, E, C]`` product.
- With an ep line of ``n`` members, one tiled all-to-all (split over
  experts, concat over slots) lands ``[E/n, n·N·C, D]`` on the experts'
  owner, the expert FFN runs batched over the local experts, and the
  inverse all-to-all brings the outputs home
  (:func:`~tpu_p2p_torch.parallel.collectives.axis_all_to_all`; each
  reshard's backward is its inverse). Every member issues both on
  every call, so a pipeline's bubble ticks keep the order. With
  ``ep_overlap="ring"`` both reshards unroll into shift hops
  (``ring_all_to_all_matmul`` and ``matmul_ring_all_to_all``): each
  arriving ``[E/n, N·C, D]`` slab's first product runs while the next
  hop is in flight, and each destination's second product while the
  previous one flies home. The FFN is batched over (expert, slot), so no
  sum crosses a chunk boundary.
- **Combine** gathers each choice's slot output and weights it by its
  gate, rounded to the payload dtype first as the reference does.

The expert products widen bf16 operands to float32 (exact products,
float32 accumulation, as the reference's ``preferred_element_type``),
and the gelu hidden is rounded to the payload dtype before the second
product, where the dense FFN keeps it in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_p2p_torch.models.zb_split import stored_matmul
from tpu_p2p_torch.parallel.collectives import (
    axis_all_to_all,
    matmul_ring_all_to_all,
    ring_all_to_all_matmul,
)
from tpu_p2p_torch.utils.remat import product

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class MoEConfig:
    """Global shapes. ``num_experts`` must divide by the ep line's size.
    Fields and defaults as the reference's."""

    d_model: int = 64
    d_ff: int = 128
    num_experts: int = 8
    capacity_factor: float = 2.0
    router_top_k: int = 1    # 1 = Switch routing; 2 = top-2 with
    # renormalised gates
    group_size: int = 1024   # routing-group width: capacity holds per
    # group of this many tokens (0: one group of every token)
    ep_overlap: str = "none"  # "none": the two blocking all-to-alls;
    # "ring": the reshards as shift hops under the expert products

    def __post_init__(self) -> None:
        if self.ep_overlap not in ("none", "ring"):
            raise ValueError(
                f"unknown ep_overlap {self.ep_overlap!r}; expected "
                "'none' or 'ring'"
            )

    def capacity(self, tokens: int) -> int:
        """Per-expert slot count for ``tokens`` routed tokens (each
        token takes ``router_top_k`` slots in all)."""
        return max(1, math.ceil(
            tokens * self.router_top_k * self.capacity_factor
            / self.num_experts
        ))


def init_moe_params(cfg: MoEConfig, seed: int = 0,
                    dtype: torch.dtype = torch.float32) -> Params:
    """The reference's seeded init on the CPU: ``router [D, E]``, ``w1
    [E, D, F]``, ``w2 [E, F, D]``, the same ``default_rng(seed)`` draws
    in the same order, scaled by ``1/sqrt(fan_in)`` and rounded from
    float64."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def w(*shape, fan_in):
        a = rng.standard_normal(shape) / math.sqrt(fan_in)
        return torch.from_numpy(a).to(dtype)

    return {"router": w(d, e, fan_in=d), "w1": w(e, d, f, fan_in=d),
            "w2": w(e, f, d, fan_in=f)}


class Route(NamedTuple):
    """Each token's ``k`` choices (``[..., G, k]``): the expert, the slot
    within the expert's capacity (meaningful where kept), whether the
    choice holds a slot, and its gate (float32)."""

    expert: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    gates: torch.Tensor


def _top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest entries of the last dim, ties to
    the lower index (``jax.lax.top_k``'s order): ``argmax`` takes the
    first maximum, and a stable descending sort keeps equal entries in
    index order."""
    if k == 1:
        return probs.argmax(dim=-1, keepdim=True)
    return torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _route(x: torch.Tensor, router_w: torch.Tensor, num_experts: int,
           capacity: int, k: int = 1,
           valid: Optional[torch.Tensor] = None) -> Route:
    """Top-``k`` routing of ``x [..., G, D]`` with a static capacity (the
    reference's ``_route_topk``): float32 router logits and softmax;
    choice ranks allocate in order, so first choices win slots over
    second choices, and tokens in order within a rank. ``used`` advances
    on every attempt, dropped ones included: slots fill consecutively
    from it, so a drop means the expert is already full and no later
    rank loses a free slot. Gates are the chosen probabilities (k = 1)
    or those renormalised over the k choices. ``valid [..., G]`` (0/1)
    masks padding rows out: they take no slot."""
    with product("router", batch_dims=False):
        logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_e = _top_k(probs, k)                                  # [..., G, k]
    top_p = probs.gather(-1, top_e)
    gates = top_p if k == 1 else \
        top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    used = torch.zeros(x.shape[:-2] + (num_experts,), dtype=torch.int64,
                       device=x.device)
    pos, keep = [], []
    for r in range(k):
        onehot = F.one_hot(top_e[..., r], num_experts)       # [..., G, E]
        if valid is not None:
            onehot = onehot * valid.to(torch.int64)[..., None]
        # Slot within the expert: earlier tokens of this rank that chose
        # it, after the slots earlier ranks consumed.
        at = onehot.cumsum(dim=-2) - onehot + used[..., None, :]
        p_r = at.gather(-1, top_e[..., r:r + 1])[..., 0]
        chose = onehot.sum(-1) > 0
        pos.append(p_r)
        keep.append(chose & (p_r < capacity))
        used = used + onehot.sum(-2)
    return Route(top_e, torch.stack(pos, -1), torch.stack(keep, -1), gates)


def _route_topk(x, router_w, num_experts: int, capacity: int, k: int = 1,
                valid=None):
    """The reference's dense form of :func:`_route`: ``(dispatch [G, E,
    C], combine [G, E, C])`` float32, one-hot over each kept choice's
    (expert, slot), ``combine`` weighted by its gate."""
    route = _route(x, router_w, num_experts, capacity, k, valid)
    n = num_experts * capacity
    slot = torch.where(route.keep, route.expert * capacity + route.pos,
                       torch.full_like(route.pos, n))
    onehot = F.one_hot(slot, n + 1)[..., :n].float()        # [G, k, E·C]
    shape = x.shape[:-1] + (num_experts, capacity)
    dispatch = onehot.sum(-2).reshape(shape)
    combine = (onehot * route.gates[..., None]).sum(-2).reshape(shape)
    return dispatch, combine


def _slot_ids(route: Route, num_experts: int,
              capacity: int) -> torch.Tensor:
    """Each choice's row ``[N·gs, k]`` in the flattened group-major
    ``[E, N, C]`` slot buffer (``route`` over ``[N, gs]`` tokens), or
    ``E·N·C`` — a trash row — where the choice holds no slot."""
    ng, gs, k = route.expert.shape
    group = torch.arange(ng, device=route.expert.device)[:, None, None]
    slot = route.expert * (ng * capacity) + group * capacity + route.pos
    trash = torch.full_like(slot, num_experts * ng * capacity)
    return torch.where(route.keep, slot, trash).reshape(ng * gs, k)


def _dispatch(x: torch.Tensor, slot: torch.Tensor,
              n_slots: int) -> torch.Tensor:
    """``[n_slots, D]`` slot rows from the tokens ``x [G, D]``: token
    ``t``'s choice ``r`` lands in row ``slot[t, r]`` (``n_slots``: the
    trash row, dropped), every other row is zero."""
    k = slot.shape[-1]
    src = x if k == 1 else x.repeat_interleave(k, dim=0)
    out = x.new_zeros((n_slots + 1, x.shape[-1]))
    return out.index_copy(0, slot.reshape(-1), src)[:n_slots]


def _combine(y: torch.Tensor, slot: torch.Tensor,
             gates: torch.Tensor) -> torch.Tensor:
    """Each token's gate-weighted sum of its choices' slot outputs, from
    ``y [n_slots, D]``; a choice at the trash row (dropped) adds zero.
    The gates are rounded to ``y``'s dtype before the float32 product,
    as the reference's combine is; → ``[G, D]`` in ``y``'s dtype."""
    y = F.pad(y, (0, 0, 0, 1))                   # the trash row: zeros
    g, k = slot.shape
    picked = y[slot.reshape(-1)].float().reshape(g, k, -1)
    w = gates.to(y.dtype).float()[..., None]
    return (picked * w).sum(1).to(y.dtype)


def moe_layer_local(params: Params, x: torch.Tensor, cfg: MoEConfig,
                    ep=None) -> torch.Tensor:
    """This rank's MoE FFN on its tokens ``x [G, D]``: ``params`` holds
    ``router [D, E]`` (replicated) and this rank's ``E/n`` experts'
    ``w1 [E/n, D, F]`` and ``w2 [E/n, F, D]``. ``ep``: this rank's line
    along the ep axis (``None`` or a line of one: every expert is
    local, no all-to-all). Differentiable; → ``[G, D]`` in ``x``'s
    dtype."""
    n = ep.size if ep is not None else 1
    g, d = x.shape
    e = cfg.num_experts
    e_local = params["w1"].shape[0]
    if e_local * n != e:
        raise ValueError(
            f"expert shards ({e_local}) x ep size ({n}) != experts ({e})")
    # Fixed-width routing groups; the tail group is padded with rows
    # that take no capacity.
    gs = min(cfg.group_size, g) if cfg.group_size else g
    ng = -(-g // gs)
    pad = ng * gs - g
    xg = F.pad(x, (0, 0, 0, pad)) if pad else x
    valid = (torch.arange(ng * gs, device=x.device) < g).reshape(ng, gs)
    cap = cfg.capacity(gs)
    k = cfg.router_top_k
    route = _route(xg.reshape(ng, gs, d), params["router"], e, cap, k,
                   valid)
    n_slots = e * ng * cap
    slot = _slot_ids(route, e, cap)
    slots = _dispatch(xg, slot, n_slots).reshape(e, ng * cap, d)

    # The expert FFN: ``ecd,edf->ecf`` and ``ecf,efd->ecd`` in the
    # reference, products with the expert as a batch dim.
    def ffn1(slab):
        with product("we1", batch_dims=True):
            h = stored_matmul(slab.float(), params["w1"], "we1")
        return F.gelu(h, approximate="tanh")

    def ffn2(slab):
        with product("we2", batch_dims=True):
            y = stored_matmul(slab.to(x.dtype).float(), params["w2"], "we2")
        return y.to(x.dtype)

    if n > 1 and cfg.ep_overlap == "ring":
        # Both reshards as shift hops, each slab's product beside the
        # next hop: [E, NC, D] -> [E/n, n·NC, F] -> [E, NC, D].
        h = ring_all_to_all_matmul(lambda slab, _src: ffn1(slab), slots,
                                   ep, 0, 1)
        y = matmul_ring_all_to_all(lambda slab, _dst: ffn2(slab), h, ep,
                                   1, 0)
    elif n > 1:
        # Each expert's slots to its owner: [E, NC, D] -> [E/n, n·NC, D];
        # then the inverse reshard at the source.
        y = axis_all_to_all(ffn2(ffn1(axis_all_to_all(slots, ep, 0, 1))),
                            ep, 1, 0)
    else:
        y = ffn2(ffn1(slots))
    out = _combine(y.reshape(n_slots, d), slot,
                   route.gates.reshape(ng * gs, k))
    return out[:g] if pad else out


def moe_reference(params: Params, x: torch.Tensor,
                  cfg: MoEConfig) -> torch.Tensor:
    """Capacity-free oracle: every token through its top-k experts,
    computed densely (every expert on every token) and gathered. Equals
    :func:`moe_layer_local` whenever nothing drops."""
    k = cfg.router_top_k
    probs = torch.softmax(torch.matmul(x.float(),
                                       params["router"].float()), dim=-1)
    top_e = _top_k(probs, k)
    top_p = probs.gather(-1, top_e)
    gates = top_p if k == 1 else \
        top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    h = F.gelu(torch.einsum("gd,edf->egf", x.float(),
                            params["w1"].float()), approximate="tanh")
    y = torch.einsum("egf,efd->egd", h.to(x.dtype).float(),
                     params["w2"].float())                     # [E, G, D]
    rows = torch.arange(x.shape[0], device=x.device)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for r in range(k):
        out = out + y[top_e[:, r], rows] * gates[:, r, None]
    return out.to(x.dtype)
