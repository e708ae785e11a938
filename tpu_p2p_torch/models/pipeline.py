"""Pipeline parallelism — GPipe microbatching over the pp line, the port
of ``tpu_p2p/models/pipeline.py``: the flagship's schedule
(:func:`pipeline_apply_local`) and the generic residual-MLP pipeline
(:class:`PipelineConfig`, :func:`mlp_block`, the steps routed through
the tick IR of :mod:`tpu_p2p_torch.models.schedule`, the one-device
oracle :func:`pipeline_reference`).

Each rank of the pp line owns one stage (its slice of the stage-major
params); activations hop stage → stage + 1 on the no-wraparound
neighbour edges. The schedule is the reference's masked tick loop: ``M +
S - 1`` ticks (``M`` microbatches, ``S`` stages), every stage running its
block every tick, on zeros in the fill and drain bubbles (a zero input
gives a zero output), with the results masked.

The masks are tensor operations, never a branch on the rank: every rank
of the line builds the same autograd graph, so every rank runs every
hop's backward, in the same order. (A branch would drop a hop's arrival
from the graph of the rank that ignores it, whose backward would then
never post the receive its neighbour sends.)

``pp_overlap="wave"`` (with ``pp_chunks`` > 1) ships each tick's hop as
a wave of token chunks (:func:`chunked_ppermute_compute`, the identity
compute along ``T``): every chunk's hop is issued before the first is
waited for. The arrivals are the one-shot hop's values, bitwise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from tpu_p2p_torch.obs.ledger import ScanBody, program
from tpu_p2p_torch.parallel.collectives import (
    axis_ppermute,
    chunked_ppermute_compute,
    psum_conjugate,
    psum_join,
)
from tpu_p2p_torch.parallel.runtime import local_shard

Params = Dict[str, torch.Tensor]


def pipeline_apply_local(block_fn: Callable, params_local, x_mb: torch.Tensor,
                         line, pp_overlap: str = "none",
                         pp_chunks: int = 1) -> torch.Tensor:
    """GPipe over the pp ``line``: ``x_mb [M, mb, T, D]``, replicated over
    the line → the outputs ``[M, mb, T, D]``, replicated. ``pp_overlap=
    "wave"`` with ``pp_chunks`` > 1 splits each hop into that many token
    chunks (module docstring); ``"none"`` or ``pp_chunks=1`` keep the
    one-shot hop.

    Tick ``t``: stage ``s`` runs microbatch ``t - s``; stage 0 reads
    microbatch ``t`` of the input, the others the previous tick's
    arrival. The input enters through :func:`psum_conjugate` (only stage
    0 consumes it, so its cotangent is stage 0's, summed over the line);
    the last stage records each finished microbatch, and
    :func:`psum_join` replicates the record (the other stages' is
    zero)."""
    s_count, my = line.size, line.index
    m = x_mb.shape[0]
    edges = [(i, i + 1) for i in range(s_count - 1)]
    wave = pp_overlap == "wave" and pp_chunks > 1
    x_mb = psum_conjugate(x_mb, line)
    first = torch.tensor(my == 0, device=x_mb.device)
    zero = torch.zeros_like(x_mb[0])
    prev_in = zero
    outs = []
    body = ScanBody()  # the tick scan: its ship records once
    for t in range(m + s_count - 1):
        feed = x_mb[t] if t < m else zero
        y = block_fn(params_local, torch.where(first, feed, prev_in))
        if t < m + s_count - 2 and s_count > 1:  # the last hop feeds no one
            with body.site("ship"):
                prev_in = (chunked_ppermute_compute(
                    lambda c, _i: c, y, line, edges, chunk_dim=1,
                    chunks=pp_chunks, label="pp_stage_ship") if wave
                    else axis_ppermute(y, line, edges,
                                       label="pp_stage_ship"))
        out_t = t - (s_count - 1)
        if out_t >= 0:
            last = torch.tensor(my == s_count - 1, device=y.device)
            outs.append(torch.where(last, y, zero))
    return psum_join(torch.stack(outs), line, label="pp_output_replicate")


# ------------------------------------------ the generic residual-MLP pipeline
#
# The reference's generic pipeline (``tpu_p2p/models/pipeline.py:55-288``):
# a stack of ``stages`` identical residual-MLP blocks with stage-major
# params, the SGD step every schedule compiles to, and the one-device
# oracle. The steps route through the tick IR
# (:mod:`tpu_p2p_torch.models.schedule`).


@dataclass(frozen=True)
class PipelineConfig:
    """A stack of ``stages`` identical residual-MLP blocks."""

    d_model: int = 32
    d_ff: int = 64
    stages: int = 4
    microbatches: int = 4


def init_pipeline_params(cfg: PipelineConfig, seed: int = 0,
                         dtype=torch.float32, device="cpu") -> Params:
    """The reference's seeded init: ``default_rng(seed)`` standard
    normals over ``sqrt(fan_in)``, drawn in the same order (``w1`` then
    ``w2``) and rounded from float64, so the weights equal the
    reference's."""
    rng = np.random.default_rng(seed)
    s, d, f = cfg.stages, cfg.d_model, cfg.d_ff

    def w(*shape, fan_in):
        a = rng.standard_normal(shape) / math.sqrt(fan_in)
        return torch.from_numpy(a).to(dtype).to(device)

    return {"w1": w(s, d, f, fan_in=d), "w2": w(s, f, d, fan_in=f)}


def pp_param_specs(mesh=None) -> Dict[str, tuple]:
    """Each leaf's spec: the stage dim split over ``pp`` (where the mesh
    has that axis), the rest whole."""
    pp = "pp" if mesh is not None and "pp" in mesh.axis_names else None
    return {"w1": (pp, None, None), "w2": (pp, None, None)}


def mlp_block(stage_params: Params, x: torch.Tensor) -> torch.Tensor:
    """The per-stage compute: one residual MLP block on the stage's
    ``[1, ...]`` slice. Both products accumulate in float32 and the
    results return to ``x``'s dtype, as ``preferred_element_type`` does
    (bf16 operands are widened: a product of two bf16 values is exact in
    float32); GELU is the tanh approximation, ``jax.nn.gelu``'s default.
    Zero in, zero out (the masked bubble ticks). The products go through
    :func:`~tpu_p2p_torch.models.zb_split.stored_matmul`, so the tick
    executor can defer their weight gradients."""
    from tpu_p2p_torch.models.zb_split import stored_matmul

    w1, w2 = stage_params["w1"][0], stage_params["w2"][0]
    h = F.gelu(stored_matmul(x.float(), w1, "w1"), approximate="tanh")
    y = stored_matmul(h.to(x.dtype).float(), w2, "w2")
    return x + y.to(x.dtype)


def _to_microbatches(x: torch.Tensor, m: int) -> torch.Tensor:
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    return x.reshape((m, b // m) + tuple(x.shape[1:]))


def _check_pp_mesh(mesh, cfg: PipelineConfig):
    """This rank's pp line; the stage count must equal its size."""
    if mesh is None or "pp" not in mesh.axis_names:
        raise ValueError("mesh needs a 'pp' axis for pipeline parallelism")
    line = mesh.line("pp")
    if line.size != cfg.stages:
        raise ValueError(
            f"cfg.stages ({cfg.stages}) != pp axis size ({line.size})"
        )
    return line


def make_pipeline_forward(mesh, cfg: PipelineConfig,
                          block_fn: Callable = mlp_block,
                          pp_overlap: str = "none", pp_chunks: int = 1):
    """The pipeline forward of this rank's stage: ``(params, x [B, T,
    D]) → [B, T, D]``, replicated over pp. Runs the GPipe program through
    the tick IR (``compile_gpipe → lower() → tick_forward_local``)."""
    from tpu_p2p_torch.models.schedule import (
        compile_gpipe,
        lower,
        tick_forward_local,
    )

    line = _check_pp_mesh(mesh, cfg)
    lowered = lower(compile_gpipe(cfg.microbatches, cfg.stages))

    def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
        x_mb = _to_microbatches(x, cfg.microbatches)
        y_mb = tick_forward_local(block_fn, params, x_mb, lowered, line,
                                  pp_overlap=pp_overlap,
                                  pp_chunks=pp_chunks)
        return y_mb.reshape(x.shape)

    return program(forward)


def make_pipeline_train_step(mesh, cfg: PipelineConfig,
                             block_fn: Callable = mlp_block,
                             lr: float = 1e-2, pp_overlap: str = "none",
                             pp_chunks: int = 1):
    """One SGD step through the GPipe schedule, routed through the tick
    IR (``compile_gpipe → lower()``; autograd owns the backward through
    the ticks): ``(params, x, target) → (params, loss / x.numel())``."""
    from tpu_p2p_torch.models.schedule import compile_gpipe, \
        make_tick_train_step

    _check_pp_mesh(mesh, cfg)
    return make_tick_train_step(
        mesh, cfg, compile_gpipe(cfg.microbatches, cfg.stages),
        block_fn=block_fn, lr=lr, pp_overlap=pp_overlap,
        pp_chunks=pp_chunks)


def make_pipeline_train_step_reference(mesh, cfg: PipelineConfig,
                                       block_fn: Callable = mlp_block,
                                       lr: float = 1e-2,
                                       pp_overlap: str = "none",
                                       pp_chunks: int = 1):
    """Parity fixture: the legacy hand-rolled GPipe step (autograd over
    :func:`pipeline_apply_local`'s tick loop), the reference's
    ``make_pipeline_train_step_reference``. Production code goes through
    :func:`make_pipeline_train_step`; the tests hold the two together."""
    from tpu_p2p_torch.models.flagship_steps import _sgd_update

    line = _check_pp_mesh(mesh, cfg)
    m = cfg.microbatches

    def step(params: Params, x: torch.Tensor, target: torch.Tensor):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        with torch.enable_grad():
            y = pipeline_apply_local(block_fn, leaves,
                                     _to_microbatches(x, m), line,
                                     pp_overlap=pp_overlap,
                                     pp_chunks=pp_chunks)
            loss = torch.sum(
                (y.float() - _to_microbatches(target, m).float()) ** 2)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        denom = float(np.prod(tuple(x.shape)))
        return _sgd_update(params, grads, lr, denom), loss.detach() / denom

    return program(step)


def pipeline_reference(params: Params, x: torch.Tensor,
                       cfg: PipelineConfig,
                       block_fn: Callable = mlp_block) -> torch.Tensor:
    """Single-device oracle: the stages applied in order, no pipeline."""
    y = x
    for s in range(cfg.stages):
        y = block_fn({k: v[s:s + 1] for k, v in params.items()}, y)
    return y


def place_pipeline_params(params: Params, mesh, device=None) -> Params:
    """This rank's stage slice of each leaf (:func:`pp_param_specs`), on
    ``device`` (default: the mesh's)."""
    specs = pp_param_specs(mesh)
    dev = device if device is not None else mesh.device
    return {k: local_shard(v, mesh, specs[k]).contiguous().to(dev)
            for k, v in params.items()}
