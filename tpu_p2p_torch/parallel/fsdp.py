"""ZeRO-3 / FSDP parameter sharding over the data-parallel axis — the
port's copy of ``tpu_p2p/parallel/fsdp.py``.

- **Storage**: each parameter is split along one of its dims over the
  ``dp`` line, on top of the tp/ep/pp split its base spec already has,
  so weights and gradients scale with the dp size (the port trains with
  SGD: there are no optimizer moments to shard).
- **Gather-on-use**: inside the differentiated step each planned leaf's
  shard is all-gathered (tiled) over the rank's dp line right before
  the forward. The gather is an autograd function whose backward is the
  summing reduce-scatter — the transpose the reference gets from
  ``shard_map`` autodiff — so gradients come back dp-sharded and
  already summed over dp.
- **Static planning**: :func:`fsdp_plan` picks, per parameter, the
  first dim its base spec leaves unsplit whose size divides the axis;
  a parameter with no such dim stays replicated. Host arithmetic on
  shapes.
- **Prefetch** (``overlap="prefetch"``): :func:`split_plan_for_prefetch`
  and :func:`gather_stage` give the double buffer: the per-block loop
  issues block *i+1*'s bucketed gather before block *i*'s compute and
  waits on it where block *i+1* needs it
  (:func:`tpu_p2p_torch.models.flagship_forward._stage_block`). On a
  card the gather runs on NCCL's stream beside the compute; its
  backward is that stage's reduce-scatter. At most two stages' full
  params are gathered at once.

Specs are the port's tuples (an axis name, a tuple of names, or None a
dim). The reference's obs-ledger hook (one ``record_issue`` a planned
leaf) comes with the port's ledger, as ``_record_issue`` does
elsewhere.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from tpu_p2p_torch.parallel.collectives import (
    PendingGather,
    bucketed_all_gather,
    start_bucketed_all_gather,
)

Plan = Dict[str, Optional[int]]
Spec = Tuple[object, ...]


def fsdp_plan(shapes: Dict[str, Tuple[int, ...]],
              base_specs: Dict[str, Spec], axis_size: int) -> Plan:
    """Choose the dim to shard per parameter: the first dim whose base
    spec entry is ``None`` and whose size divides ``axis_size``.
    ``None`` in the result = leave that parameter replicated."""
    plan: Plan = {}
    for name, shape in shapes.items():
        spec = tuple(base_specs[name]) + (None,) * (
            len(shape) - len(tuple(base_specs[name])))
        plan[name] = next(
            (d for d, (s, sp) in enumerate(zip(shape, spec))
             if sp is None and s % axis_size == 0 and axis_size > 1),
            None,
        )
    return plan


def fsdp_specs(base_specs: Dict[str, Spec], plan: Plan,
               axis: str) -> Dict[str, Spec]:
    """Insert ``axis`` into each base spec at the planned dim."""
    out = {}
    for name, spec in base_specs.items():
        d = plan.get(name)
        if d is None:
            out[name] = spec
            continue
        entries = list(spec) + [None] * (d + 1 - len(spec))
        if entries[d] is not None:  # base already shards this dim
            raise ValueError(f"{name}: dim {d} already sharded by "
                             f"{entries[d]}")
        entries[d] = axis
        out[name] = tuple(entries)
    return out


def all_gather_params(params: Dict[str, torch.Tensor], line,
                      plan: Plan) -> Dict[str, torch.Tensor]:
    """Rebuild full parameters from their shards over the dp ``line``:
    one tiled all-gather a planned leaf along its planned dim, in leaf
    order. Call inside the differentiated step: the backward is the
    ZeRO gradient reduce-scatter."""
    return {
        k: (bucketed_all_gather({k: (v, plan[k])}, line)[k]
            if plan.get(k) is not None else v)
        for k, v in params.items()
    }


def split_plan_for_prefetch(plan: Plan,
                            stage_leaves: Iterable[str]) -> Tuple[Plan, Plan]:
    """Split a ZeRO plan into ``(upfront, per_stage)`` for the
    double-buffered prefetch schedule.

    ``per_stage`` keeps the stage-major leaves whose sharded dim is NOT
    the leading stage dim: those can be gathered one stage slice at a
    time. Everything else stays ``upfront``: stage-less leaves (tied
    embedding, final norm gain), leaves the plan left replicated, and
    the leaf whose *stage* dim is the dp-split one (a stage slice of its
    shard is not one stage's params)."""
    stage_leaves = set(stage_leaves)
    per_stage = {k: d for k, d in plan.items()
                 if d is not None and d > 0 and k in stage_leaves}
    upfront = {k: d for k, d in plan.items() if k not in per_stage}
    return upfront, per_stage


def gather_stage(stage_params: Dict[str, torch.Tensor], index: int, line,
                 per_stage_plan: Plan,
                 bucket_bytes: Optional[int] = None) -> PendingGather:
    """Issue ONE stage's bucketed all-gather of every per-stage-planned
    leaf; ``.wait()`` on the result gives ``{name: the stage's full
    slice}``.

    ``stage_params`` leaves are stage-major local shards (leading stage
    dim intact); ``per_stage_plan`` dims are in full-array coordinates,
    so slicing off the stage dim shifts each by one. The backward of the
    waited gather is the stage's gradient reduce-scatter, accumulated
    (zero-padded) into the stage-major shard gradient through the
    slice."""
    shards = {k: (stage_params[k][index], per_stage_plan[k] - 1)
              for k in per_stage_plan if k in stage_params}
    return start_bucketed_all_gather(shards, line, bucket_bytes)
