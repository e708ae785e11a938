"""Flagship forward path over the five-axis mesh — the port of
``tpu_p2p/models/flagship_forward.py``.

The reference traces its block inside a five-axis ``shard_map``; here
each rank runs the same code on its shards, and the mesh enters as the
rank's line along each axis (``mesh=None``: a world of one, no axis).
Per block: q/k/v from this rank's tp heads, rope at the global
positions of the rank's sp block, attention by ``cfg.sp_strategy`` and
the sp size (the flash or dense ring, zigzag or contiguous; Ulysses; or
local attention when the sequence is whole), the Megatron psum joins
after ``wo`` and ``wf2``, and their conjugates where the replicated
activation enters the column-split products; or, with ``dense_ffn``
off, the MoE FFN with its experts split over ``ep``
(:mod:`tpu_p2p_torch.models.moe`). ``tp_overlap="ring"`` replaces
both tp joins with ring collective-matmuls over token chunks
(:func:`_tp_ring_join`). Microbatches go through the GPipe schedule over
pp (:mod:`tpu_p2p_torch.models.pipeline`, with ``pp_overlap``'s wave),
or one after another when pp has size 1. Attention goes through the flash
kernels or dense attention by ``cfg.use_flash``. Under ``cfg.remat``
each block runs under ``torch.utils.checkpoint``
(:func:`tpu_p2p_torch.utils.remat.remat_block`, ``cfg.remat_policy``);
under ``cfg.zero_dp`` the ZeRO gathers run through
:func:`_fsdp_prepare`, in bulk or, with ``overlap="prefetch"``, one
block ahead in the block loop.

The reference computes norms and the dense FFN with float32 internals
and ``preferred_element_type=float32`` matmuls. Here the casts are
spelled out: bf16 operands are widened to float32 before each product,
which reproduces an f32-accumulated bf16 product exactly (a product of
two bf16 values is exact in float32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_p2p_torch.models.flagship_config import AXES, FlagshipConfig, \
    _mesh_axes
from tpu_p2p_torch.models.flagship_params import (
    STAGELESS_LEAVES,
    Params,
    _fsdp_plan,
    torch_dtype,
)
from tpu_p2p_torch.models import zb_split
from tpu_p2p_torch.models.moe import moe_layer_local
from tpu_p2p_torch.models.pipeline import pipeline_apply_local
from tpu_p2p_torch.ops.attention import (
    _block_positions,
    dense_attention,
    ring_attention_local,
)
from tpu_p2p_torch.ops.flash_attention import flash_attention
from tpu_p2p_torch.ops.rope import apply_rope
from tpu_p2p_torch.ops.ulysses import ulysses_attention_local
from tpu_p2p_torch.parallel import fsdp
from tpu_p2p_torch.parallel.collectives import (
    matmul_ring_reducescatter,
    psum_conjugate,
    psum_join,
    ring_allgather_matmul,
)
from tpu_p2p_torch.utils.remat import product, remat_block


def _size(line) -> int:
    return line.size if line is not None else 1


def _rms_norm(x: torch.Tensor, gain: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with a learnable gain, returned in x's dtype."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * r * gain.float()).to(x.dtype)


def _dense_ffn(sub: Params, h: torch.Tensor, tp=None) -> torch.Tensor:
    """Dense 2-layer MLP: ``gelu(h @ wf1) @ wf2`` with float32
    accumulation, Megatron-split over ``tp`` (``wf1`` holds a column
    shard, ``wf2`` the matching row shard; the partial outputs join in
    float32). GELU is the tanh approximation (``jax.nn.gelu``'s default,
    not torch's erf default); the hidden stays float32 and meets ``wf2``
    under float32 promotion, as in the reference; the result is cast
    back to ``h``'s dtype."""
    h = psum_conjugate(h, tp)
    with product("wf1", batch_dims=False):
        f_h = zb_split.stored_matmul(h.float(), sub["wf1"], "wf1")
    f_h = F.gelu(f_h, approximate="tanh")
    with product("wf2", batch_dims=False):
        out = zb_split.stored_matmul(f_h, sub["wf2"], "wf2")
    return psum_join(out, tp).to(h.dtype)


def _moe_ffn(sub: Params, h2: torch.Tensor, cfg: FlagshipConfig,
             ep=None) -> torch.Tensor:
    """The MoE FFN over this rank's flattened tokens, experts split over
    ``ep`` (this rank's line, or None). No tp join: every tp rank routes
    the same replicated tokens through the same replicated experts."""
    moe = {"router": sub["router"], "w1": sub["we1"], "w2": sub["we2"]}
    tokens = h2.reshape(-1, h2.shape[-1])
    return moe_layer_local(moe, tokens, cfg.moe(), ep).reshape(h2.shape)


def _unembed(y: torch.Tensor, emb: torch.Tensor,
             compute: torch.dtype) -> torch.Tensor:
    """Tied unembed in the compute dtype with float32 accumulation: both
    operands widened to float32 (exact for bf16 products)."""
    return torch.matmul(y.to(compute).float(), emb.to(compute).float().t())


def _attention(q, k, v, cfg: FlagshipConfig, sp) -> torch.Tensor:
    """Attention of this rank's heads over the sequence split along
    ``sp``, by ``cfg.sp_strategy`` (the reference's dispatch)."""
    window = cfg.attn_window or None
    if sp is not None and cfg.sp_strategy == "ulysses":
        return ulysses_attention_local(q, k, v, sp, causal=cfg.causal,
                                       use_flash=cfg.use_flash,
                                       window=window)
    if _size(sp) > 1:
        layout = "zigzag" if cfg.sp_strategy == "ring_zigzag" \
            else "contiguous"
        return ring_attention_local(q, k, v, sp, causal=cfg.causal,
                                    use_flash=cfg.use_flash, layout=layout,
                                    window=window)
    if cfg.use_flash:  # the sequence is local
        return flash_attention(q, k, v, cfg.causal, window)
    return dense_attention(q, k, v, causal=cfg.causal, window=window)


def _project(h: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """A q/k/v projection of this rank's heads, ``btm,hmd->bhtd``."""
    with product(name, batch_dims=False):
        return zb_split.stored_product("proj", h, w, name)


def _stage_sub_block(sub: Params, x: torch.Tensor, cfg: FlagshipConfig,
                     sp=None, tp=None, ep=None) -> torch.Tensor:
    """One transformer block: attention + FFN (dense, or MoE by
    ``cfg.dense_ffn``), both residual, optionally pre-normed
    (``cfg.norm``). ``sub``: one stage's leaves
    (no stage dim) in the compute dtype, this rank's tp shard; ``x``:
    the local ``[mb, T_local, Dm]``, replicated over tp. Zero in, zero
    out (the pipeline's bubbles)."""
    h = _rms_norm(x, sub["ln1"]) if cfg.norm else x
    h = psum_conjugate(h, tp)
    q, k, v = (_project(h, sub[w], w) for w in ("wq", "wk", "wv"))
    if cfg.rope:
        t_loc = x.shape[1]
        if _size(sp) == 1:
            positions = torch.arange(t_loc, device=x.device)
        else:
            layout = "zigzag" if cfg.sp_strategy == "ring_zigzag" \
                else "contiguous"
            positions = _block_positions(sp.index, sp.size, t_loc, layout,
                                         x.device)
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
    a = _attention(q, k, v, cfg, sp)
    if cfg.tp_overlap == "ring" and _size(tp) > 1:
        # tp 1 (or no tp axis) keeps the psum path below, bitwise.
        return _tp_ring_join(sub, x, a, cfg, tp, ep)
    with product("wo", batch_dims=False):
        o = zb_split.stored_product("out", a, sub["wo"], "wo")
    x = x + psum_join(o, tp)
    h2 = _rms_norm(x, sub["ln2"]) if cfg.norm else x
    if cfg.dense_ffn:
        return x + _dense_ffn(sub, h2, tp)
    return x + _moe_ffn(sub, h2, cfg, ep)


def _tp_ring_join(sub: Params, x: torch.Tensor, a: torch.Tensor,
                  cfg: FlagshipConfig, tp, ep=None) -> torch.Tensor:
    """The block's tail under ``tp_overlap="ring"`` (reference
    ``flagship_forward.py:132-244``): both Megatron joins as ring
    collective-matmuls over token chunks of the local sequence.

    - The out-projection: :func:`matmul_ring_reducescatter` of the
      per-chunk ``a @ wo`` partials leaves this rank token chunk ``idx``
      of the joined attention delta.
    - The dense FFN's first product: :func:`ring_allgather_matmul`
      gathers that delta *through* ``wf1``; each arriving chunk is added
      to the residual's chunk sliced locally at its source position (and
      pre-normed) inside the per-chunk compute, so only the new bytes
      ride the ring and every rank consumes the replicated ``x`` and
      ``ln2`` for every token, as the psum path does.
    - The second product: another :func:`matmul_ring_reducescatter`,
      with ``wf2``.
    - The joined delta (attention plus FFN) returns to the replicated
      residual by :func:`unshard`: the rank's chunk scattered into zeros
      and summed over tp (:func:`psum_join`), not gathered, so the
      residual path stays local and every join crosses a psum, the psum
      path's gradient structure. A MoE block re-replicates right after
      the attention join, so routing sees the psum path's tokens.

    Gradient accounting, as the psum path's: ``x`` and ``ln2`` enter the
    column-split first product through :func:`psum_conjugate` (each
    rank's cotangent is the part of its columns); the arriving delta
    chunks need none, since the gather ring's backward already sums
    their cotangents over the ranks that consumed them. A sequence that
    does not split into the ring's chunks is padded with zero tokens,
    which stay zero through every op and are sliced off at the end. The
    products widen their operands as :func:`_dense_ffn` does, under the
    same marks."""
    n, idx = tp.size, tp.index
    t_loc = x.shape[1]
    t_pad = -(-t_loc // n) * n
    if t_pad != t_loc:
        x = F.pad(x, (0, 0, 0, t_pad - t_loc))
        a = F.pad(a, (0, 0, 0, t_pad - t_loc))
    ct = t_pad // n

    def unshard(delta_chunk):
        """Chunk ``idx`` of a joined delta → the whole ``[b, t_pad, m]``
        delta, replicated over tp."""
        b, _, m = delta_chunk.shape
        buf = torch.cat([delta_chunk.new_zeros((b, idx * ct, m)),
                         delta_chunk,
                         delta_chunk.new_zeros((b, (n - 1 - idx) * ct, m))],
                        dim=1)
        return psum_join(buf, tp)

    def wo_chunk(c, _src):
        with product("wo", batch_dims=False):
            return zb_split.stored_product("out", c, sub["wo"], "wo")

    y_shard = matmul_ring_reducescatter(wo_chunk, a, tp, chunk_dim=2)
    if not cfg.dense_ffn:
        x = (x + unshard(y_shard))[:, :t_loc]
        h2 = _rms_norm(x, sub["ln2"]) if cfg.norm else x
        return x + _moe_ffn(sub, h2, cfg, ep)
    xc = psum_conjugate(x, tp)
    ln2 = psum_conjugate(sub["ln2"], tp) if cfg.norm else None

    def ffn1_chunk(y_c, src):
        x1_c = xc.narrow(1, src * ct, ct) + y_c
        h = _rms_norm(x1_c, ln2) if cfg.norm else x1_c
        with product("wf1", batch_dims=False):
            return zb_split.stored_matmul(h.float(), sub["wf1"], "wf1")

    def ffn2_chunk(c, _src):
        with product("wf2", batch_dims=False):
            return zb_split.stored_matmul(c, sub["wf2"], "wf2")

    f_h = F.gelu(ring_allgather_matmul(ffn1_chunk, y_shard, tp, 1),
                 approximate="tanh")
    f_out = matmul_ring_reducescatter(ffn2_chunk, f_h, tp, chunk_dim=1)
    delta = y_shard + f_out.to(x.dtype)
    return (x + unshard(delta))[:, :t_loc]


def _block_body(cfg: FlagshipConfig):
    """One block as the stage loop calls it: ``(sub, x, sp, tp, ep) →
    x``, under rematerialization when ``cfg.remat``. Params stored in
    ``params_dtype`` are cast to the compute dtype at block entry
    (autograd carries the grads back to the storage-dtype masters),
    inside the remat boundary on purpose: a checkpointed block's inputs
    stay live until its backward, so a cast outside would pin a
    compute-dtype copy of every block's params, while recomputing the
    cast from the masters is free."""
    compute = torch_dtype(cfg.dtype)

    def cast_and_run(sub, x, sp, tp, ep, row=0, store=None):
        sub = {k: (v.to(compute) if v.dtype != compute else v)
               for k, v in sub.items()}
        with zb_split.scope(store, row):
            return _stage_sub_block(sub, x, cfg, sp, tp, ep)

    rings = "ring" in (cfg.tp_overlap, cfg.ep_overlap)  # hops left in
    # flight inside the block: its recompute must run whole
    return remat_block(cast_and_run, cfg.remat, cfg.remat_policy,
                       stop_early=not rings)


def _stage_block(stage_params: Params, x: torch.Tensor,
                 cfg: FlagshipConfig, s_local: int, sp=None,
                 tp=None, ep=None, prefetch=None) -> torch.Tensor:
    """Apply this pp rank's ``s_local`` consecutive blocks.

    ``prefetch``: None — every leaf arrives whole and is sliced per
    block. Or ``(dp_line, per_stage_plan)`` — the planned leaves arrive
    dp-sharded and are gathered one block ahead: the loop issues block
    ``i+1``'s bucketed gather before block ``i``'s compute and waits on
    it when block ``i+1`` starts (the double buffer; at most two blocks'
    gathered params at once). The gather sits outside the remat
    boundary: re-gathering inside the backward would pay the collective
    again, and the gathered slice is a block input, live as the bulk
    gather's would be."""
    body = _block_body(cfg)
    store = zb_split.current_store()  # the tick executor's, or None
    if prefetch is None:
        for i in range(s_local):
            x = body({k: v[i] for k, v in stage_params.items()}, x,
                     sp, tp, ep, i, store)
        return x
    line, plan = prefetch
    cur = fsdp.gather_stage(stage_params, 0, line, plan)
    for i in range(s_local):
        nxt = (fsdp.gather_stage(stage_params, i + 1, line, plan)
               if i + 1 < s_local else None)
        got = cur.wait()
        sub = {k: (got[k] if k in got else v[i])
               for k, v in stage_params.items()}
        x = body(sub, x, sp, tp, ep, i, store)
        cur = nxt
    return x


def _pipeline_schedule(stage_params: Params, x_mb: torch.Tensor,
                       cfg: FlagshipConfig, s_local: int, pp, sp, tp,
                       ep=None, prefetch=None):
    """The microbatches through this rank's stages: GPipe over ``pp``
    (:func:`pipeline_apply_local`), or one after another without a pp
    axis of size > 1."""
    def block_fn(params, x):
        return _stage_block(params, x, cfg, s_local, sp, tp, ep, prefetch)

    if _size(pp) == 1:
        return torch.stack([block_fn(stage_params, x_mb[i])
                            for i in range(x_mb.shape[0])])
    return pipeline_apply_local(block_fn, stage_params, x_mb, pp,
                                pp_overlap=cfg.pp_overlap,
                                pp_chunks=cfg.pp_chunks)


def _forward_local(params: Params, x: torch.Tensor, cfg: FlagshipConfig,
                   mesh_axes=None, prefetch=None) -> torch.Tensor:
    """This rank's ``x [B_local, T_local, Dm]`` through the block stack
    in ``cfg.microbatches`` microbatches; → the same shape. ``mesh_axes``
    (:func:`~tpu_p2p_torch.models.flagship_config._mesh_axes`): this
    rank's line along each axis; None is a world of one. ``prefetch``
    as :func:`_fsdp_prepare` returns it."""
    axes = mesh_axes or dict.fromkeys(AXES)
    pp, sp, tp, ep = axes["pp"], axes["sp"], axes["tp"], axes["ep"]
    if cfg.stages % _size(pp):
        raise ValueError(
            f"stages ({cfg.stages}) must divide by pp size ({_size(pp)})")
    s_local = cfg.stages // _size(pp)
    b = x.shape[0]
    if b % cfg.microbatches:
        raise ValueError(
            f"local batch {b} not divisible by {cfg.microbatches} "
            "microbatches"
        )
    x_mb = x.reshape((cfg.microbatches, b // cfg.microbatches)
                     + tuple(x.shape[1:]))
    y_mb = _pipeline_schedule(params, x_mb, cfg, s_local, pp, sp, tp, ep,
                              prefetch)
    return y_mb.reshape(x.shape)


def _fsdp_prepare(params: Params, cfg: FlagshipConfig, plan, dp):
    """Apply the ZeRO gather schedule the config asks for, over the dp
    line ``dp``. → ``(params, prefetch)``: under ``overlap="none"`` (or
    without a plan) every planned leaf is gathered here in bulk and
    ``prefetch`` is None. Under ``overlap="prefetch"`` only the leaves
    the per-block schedule cannot cover (the stage-less ``emb`` and
    ``lnf``, leaves split on their stage dim) are gathered here; the
    rest stay dp-sharded and ``prefetch`` carries ``(dp, per_stage
    plan)`` for :func:`_stage_block`. The one seam every step and
    forward goes through."""
    if not plan:
        return params, None
    if cfg.overlap != "prefetch":
        return fsdp.all_gather_params(params, dp, plan), None
    stage_leaves = set(params) - set(STAGELESS_LEAVES)
    upfront, per_stage = fsdp.split_plan_for_prefetch(plan, stage_leaves)
    params = fsdp.all_gather_params(params, dp, upfront)
    return params, ((dp, per_stage) if per_stage else None)


def make_flagship_forward(cfg: FlagshipConfig, mesh=None):
    """Forward of this rank's shards: ``(params, x [B_local, T_local,
    Dm]) → same`` (``mesh=None``: the whole batch on one device)."""
    axes = _mesh_axes(mesh)
    plan = _fsdp_plan(mesh, cfg)

    def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
        params, prefetch = _fsdp_prepare(params, cfg, plan, axes["dp"])
        return _forward_local(params, x, cfg, axes, prefetch)

    return forward


def _lm_logits_local(params: Params, tokens: torch.Tensor,
                     cfg: FlagshipConfig, mesh_axes=None,
                     prefetch=None) -> torch.Tensor:
    """Embed → block stack → tied unembed: ``tokens [B, T]`` int →
    float32 logits ``[B, T, vocab]`` (this rank's shards). The one
    definition of the LM head, shared by the forward and the train step;
    every pp rank embeds and unembeds the replicated activations."""
    compute = torch_dtype(cfg.dtype)
    x = F.embedding(tokens.long(), params["emb"]).to(compute)
    stack = {k: v for k, v in params.items() if k not in STAGELESS_LEAVES}
    y = _forward_local(stack, x, cfg, mesh_axes, prefetch)
    if cfg.norm:
        y = _rms_norm(y, params["lnf"])
    return _unembed(y, params["emb"], compute)


def make_flagship_lm_forward(cfg: FlagshipConfig, mesh=None):
    """LM forward: ``(params, tokens [B_local, T_local]) → logits
    [B_local, T_local, vocab]``."""
    if not cfg.vocab:
        raise ValueError("cfg.vocab must be > 0 for the LM forward")
    axes = _mesh_axes(mesh)
    plan = _fsdp_plan(mesh, cfg)

    def forward(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        params, prefetch = _fsdp_prepare(params, cfg, plan, axes["dp"])
        return _lm_logits_local(params, tokens, cfg, axes, prefetch)

    return forward
