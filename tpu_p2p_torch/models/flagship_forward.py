"""Flagship forward path on one device — the port of
``tpu_p2p/models/flagship_forward.py``.

The reference's block runs inside a five-axis ``shard_map``; here the
mesh is one device, so there is no sequence/tensor/expert parallelism
and no join inside the block, and microbatches run one after another
(what ``pipeline_apply_local`` computes at pp = 1). Attention goes
through the flash kernels or dense attention by ``cfg.use_flash``.

The reference computes norms and the dense FFN with float32 internals
and ``preferred_element_type=float32`` matmuls. Here the casts are
spelled out: bf16 operands are widened to float32 before each product,
which reproduces an f32-accumulated bf16 product exactly (a product of
two bf16 values is exact in float32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_p2p_torch.models.flagship_config import FlagshipConfig
from tpu_p2p_torch.models.flagship_params import (
    STAGELESS_LEAVES,
    Params,
    torch_dtype,
)
from tpu_p2p_torch.ops.attention import dense_attention
from tpu_p2p_torch.ops.flash_attention import flash_attention
from tpu_p2p_torch.ops.rope import apply_rope


def _rms_norm(x: torch.Tensor, gain: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with a learnable gain, returned in x's dtype."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * r * gain.float()).to(x.dtype)


def _dense_ffn(sub: Params, h: torch.Tensor) -> torch.Tensor:
    """Dense 2-layer MLP: ``gelu(h @ wf1) @ wf2`` with float32
    accumulation. GELU is the tanh approximation (``jax.nn.gelu``'s
    default, not torch's erf default); the hidden stays float32 and
    meets ``wf2`` under float32 promotion, as in the reference; the
    result is cast back to ``h``'s dtype."""
    f_h = F.gelu(torch.matmul(h.float(), sub["wf1"].float()),
                 approximate="tanh")
    return torch.matmul(f_h, sub["wf2"].float()).to(h.dtype)


def _unembed(y: torch.Tensor, emb: torch.Tensor,
             compute: torch.dtype) -> torch.Tensor:
    """Tied unembed in the compute dtype with float32 accumulation: both
    operands widened to float32 (exact for bf16 products)."""
    return torch.matmul(y.to(compute).float(), emb.to(compute).float().t())


def _check_ported(cfg: FlagshipConfig) -> None:
    if not cfg.dense_ffn:
        raise NotImplementedError(
            "the MoE FFN (dense_ffn=False) is not ported yet")


def _stage_sub_block(sub: Params, x: torch.Tensor,
                     cfg: FlagshipConfig) -> torch.Tensor:
    """One transformer block: attention + dense FFN, both residual,
    optionally pre-normed (``cfg.norm``). ``sub``: one stage's leaves
    (no stage dim) in the compute dtype; ``x``: ``[mb, T, Dm]``."""
    h = _rms_norm(x, sub["ln1"]) if cfg.norm else x
    q = torch.einsum("btm,hmd->bhtd", h, sub["wq"])
    k = torch.einsum("btm,hmd->bhtd", h, sub["wk"])
    v = torch.einsum("btm,hmd->bhtd", h, sub["wv"])
    if cfg.rope:
        positions = torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
    window = cfg.attn_window or None
    if cfg.use_flash:
        a = flash_attention(q, k, v, cfg.causal, window)
    else:
        a = dense_attention(q, k, v, causal=cfg.causal, window=window)
    x = x + torch.einsum("bhtd,hdm->btm", a, sub["wo"])
    h2 = _rms_norm(x, sub["ln2"]) if cfg.norm else x
    return x + _dense_ffn(sub, h2)


def _stage_block(stage_params: Params, x: torch.Tensor,
                 cfg: FlagshipConfig, s_local: int) -> torch.Tensor:
    """Apply ``s_local`` consecutive blocks. Params stored in
    ``params_dtype`` are cast to the compute dtype at block entry
    (autograd carries the grads back to the storage-dtype masters)."""
    compute = torch_dtype(cfg.dtype)
    for i in range(s_local):
        sub = {k: (v[i].to(compute) if v.dtype != compute else v[i])
               for k, v in stage_params.items()}
        x = _stage_sub_block(sub, x, cfg)
    return x


def _forward_local(params: Params, x: torch.Tensor,
                   cfg: FlagshipConfig) -> torch.Tensor:
    """The block stack over ``cfg.microbatches`` microbatches of ``x
    [B, T, Dm]``, each through every stage in turn; → ``[B, T, Dm]``."""
    _check_ported(cfg)
    b = x.shape[0]
    if b % cfg.microbatches:
        raise ValueError(
            f"local batch {b} not divisible by {cfg.microbatches} "
            "microbatches"
        )
    x_mb = x.reshape((cfg.microbatches, b // cfg.microbatches)
                     + tuple(x.shape[1:]))
    y_mb = torch.stack([_stage_block(params, x_mb[i], cfg, cfg.stages)
                        for i in range(cfg.microbatches)])
    return y_mb.reshape(x.shape)


def make_flagship_forward(cfg: FlagshipConfig):
    """Forward: ``(params, x [B, T, Dm]) → [B, T, Dm]``."""
    _check_ported(cfg)

    def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
        return _forward_local(params, x, cfg)

    return forward


def _lm_logits_local(params: Params, tokens: torch.Tensor,
                     cfg: FlagshipConfig) -> torch.Tensor:
    """Embed → block stack → tied unembed: ``tokens [B, T]`` int →
    float32 logits ``[B, T, vocab]``. The one definition of the LM head,
    shared by the forward and the train step."""
    compute = torch_dtype(cfg.dtype)
    x = F.embedding(tokens.long(), params["emb"]).to(compute)
    stack = {k: v for k, v in params.items() if k not in STAGELESS_LEAVES}
    y = _forward_local(stack, x, cfg)
    if cfg.norm:
        y = _rms_norm(y, params["lnf"])
    return _unembed(y, params["emb"], compute)


def make_flagship_lm_forward(cfg: FlagshipConfig):
    """LM forward: ``(params, tokens [B, T]) → logits [B, T, vocab]``."""
    if not cfg.vocab:
        raise ValueError("cfg.vocab must be > 0 for the LM forward")
    _check_ported(cfg)

    def forward(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return _lm_logits_local(params, tokens, cfg)

    return forward
