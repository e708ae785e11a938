"""Incremental decoding — the dense KV-cached decode steps (continuous
and LM), the LM rollout (:func:`generate_tokens`: greedy, or
temperature / top-k / top-p sampling off an explicit
``torch.Generator``) and the speculative-decoding helpers. Port of
``tpu_p2p/models/decode.py``.

The dense cache ``[stages, B, H_kv, max_len, Dh]`` is written in place,
K and V in one launch of the hand-written row-write kernel
(:func:`tpu_p2p_torch.ops.kvcache.cache_kv_write`), where the reference
donates the buffer; callers treat the cache they pass as updated. The
per-layer attention/FFN tail (:func:`_attend_ffn`) is ONE definition
shared with the paged serving step, which is what makes paged-vs-dense
parity bitwise.

Same shardings as training, on a serve mesh (a
:class:`~tpu_p2p_torch.parallel.runtime.LocalMesh` over axes among
``dp``, ``tp``, ``ep``, and ``sp``/``pp`` of size 1): heads over tp
with a psum join after the out-projection and after the dense FFN
(:func:`~tpu_p2p_torch.parallel.collectives.psum_join` on the rank's tp
line), batch rows over (dp, ep) jointly, the MoE FFN's experts over ep
with its all-to-alls, and ZeRO-stored params gathered over dp at step
entry. Each rank runs the same per-rank body the single device runs,
in a thread of its own (``LocalMesh.run``); its tp line sums in line
order, so every tp rank of a batch shard holds the same bits. Without a
mesh the step runs on one device, every expert local. The MoE routing
groups are the (dp, ep) shard's rows, so which tokens drop depends on
the batch, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from tpu_p2p_torch.models.flagship import (
    STAGELESS_LEAVES,
    FlagshipConfig,
    _dense_ffn,
    _fsdp_plan,
    _moe_ffn,
    _rms_norm,
    _unembed,
    torch_dtype,
)
from tpu_p2p_torch.ops.kvcache import cache_kv_write
from tpu_p2p_torch.ops.rope import apply_rope
from tpu_p2p_torch.parallel import fsdp
from tpu_p2p_torch.parallel.collectives import psum_join

Cache = Dict[str, torch.Tensor]

NEG_INF = -1e30  # masked scores: finite, so exp underflows to an exact 0


def check_serving_cfg(cfg: FlagshipConfig) -> None:
    """The configurations this port decodes: a tied-embedding LM (dense
    FFN or MoE)."""
    if not cfg.vocab:
        raise ValueError("cfg.vocab must be > 0 for LM decoding")


def mesh_and_cfg(mesh, cfg):
    """``(mesh, cfg)`` of a step factory called as ``(mesh, cfg)``, the
    reference's form, or as ``(cfg)``: one device, no mesh."""
    if cfg is None and isinstance(mesh, FlagshipConfig):
        return None, mesh
    return mesh, cfg


def _check_decode_mesh(mesh, cfg: FlagshipConfig) -> None:
    """Decoding is token-recurrent: sp and pp must have size 1, and the
    head counts must divide by tp (reference ``_check_decode_mesh``)."""
    if mesh is None:
        return
    for ax in ("sp", "pp"):
        if mesh.shape.get(ax, 1) != 1:
            raise ValueError(
                f"decoding needs {ax} axis size 1 (token-recurrent steps "
                f"can't use sequence/pipeline parallelism); got "
                f"{mesh.shape[ax]}"
            )
    tp = mesh.shape.get("tp", 1)
    for name, count in (("heads", cfg.heads),
                        ("kv_heads", cfg.num_kv_heads)):
        if count % tp:
            raise ValueError(
                f"{name} ({count}) must divide by the tp axis size ({tp})"
            )


def batch_shards(mesh) -> int:
    """How many ways the batch rows (and a page pool's pages) split: the
    product of the mesh's ``dp`` and ``ep`` sizes."""
    if mesh is None:
        return 1
    return mesh.shape.get("dp", 1) * mesh.shape.get("ep", 1)


def rank_shard(mesh, i: int) -> int:
    """Rank ``i``'s (dp, ep) batch shard, dp major (the reference's
    ``P(("dp", "ep"))``); the ranks of a tp line share it."""
    c = mesh.coords(i)
    return c.get("dp", 0) * mesh.shape.get("ep", 1) + c.get("ep", 0)


def lead_ranks(mesh) -> List[int]:
    """One rank of each batch shard, in shard order: the one at tp
    coordinate 0, whose output the caller reads (its tp peers hold the
    same bits)."""
    lead = {}
    for i in range(mesh.size):
        if mesh.coords(i).get("tp", 0) == 0:
            lead[rank_shard(mesh, i)] = i
    return [lead[s] for s in range(batch_shards(mesh))]


def split_rows(mesh, x: torch.Tensor) -> list:
    """A global batch-major tensor → each rank's block of rows, on the
    rank's device."""
    n = batch_shards(mesh)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over the "
                         f"dp×ep shard count ({n})")
    per = x.shape[0] // n
    return [x[rank_shard(mesh, i) * per:(rank_shard(mesh, i) + 1) * per]
            .to(mesh.devices[i]) for i in range(mesh.size)]


def join_rows(mesh, ys: list) -> torch.Tensor:
    """The global batch from per-rank outputs: the lead rank's block of
    each shard, in shard order, on the first rank's device."""
    dev = mesh.devices[0]
    return torch.cat([ys[i].to(dev) for i in lead_ranks(mesh)], dim=0)


def step_lines(rank):
    """A rank's ``(tp, ep, dp)`` lines, the axes a step meets on (None
    where the mesh lacks the axis, or without a mesh)."""
    if rank is None:
        return None, None, None
    return tuple(rank.line(a) if a in rank.axis_names else None
                 for a in ("tp", "ep", "dp"))


def step_threads(mesh, cfg: FlagshipConfig) -> bool:
    """Whether a step over ``mesh`` meets at a collective, so its ranks
    must run at once (a thread each): a tp or ep axis, or ZeRO-stored
    params."""
    return (mesh.shape.get("tp", 1) > 1 or mesh.shape.get("ep", 1) > 1
            or _fsdp_plan(mesh, cfg) is not None)


def gather_zero(params, dp, plan):
    """ZeRO-stored params gathered over the rank's dp line at step
    entry, as in the reference's step (its ``fsdp.all_gather_params``);
    ``plan=None``: ``params``."""
    return fsdp.all_gather_params(params, dp, plan) if plan else params


def init_kv_cache(cfg: FlagshipConfig, max_len: int, device="cuda", *,
                  mesh=None):
    """Zeroed cache for ``cfg.batch`` sequences, one tensor per
    projection. On a ``mesh``: one cache a rank on its device, the rows
    of its (dp, ep) shard and its ``H_kv / tp`` heads (the reference's
    ``cache_spec``)."""
    dtype = torch_dtype(cfg.dtype)
    if mesh is None:
        shape = (cfg.stages, cfg.batch, cfg.num_kv_heads, max_len,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    _check_decode_mesh(mesh, cfg)
    n = batch_shards(mesh)
    if cfg.batch % n:
        raise ValueError(f"batch ({cfg.batch}) must divide by the dp×ep "
                         f"shard count ({n})")
    shape = (cfg.stages, cfg.batch // n,
             cfg.num_kv_heads // mesh.shape.get("tp", 1), max_len,
             cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=d),
             "v": torch.zeros(shape, dtype=dtype, device=d)}
            for d in mesh.devices]


def _stage_params(params, s: int, compute: torch.dtype):
    """One stage's slice of the stage-major leaves, cast to the compute
    dtype only where the storage dtype differs."""
    return {k: (v[s].to(compute) if v.dtype != compute else v[s])
            for k, v in params.items() if k not in STAGELESS_LEAVES}


def _attend_ffn(sub, x, q, kb, vb, live, cfg: FlagshipConfig, tp=None,
                ep=None):
    """The per-layer cached-attention tail shared by the dense decode
    step and the paged serving step.

    ``x``: residual ``[B, C, Dm]``; ``q``: roped queries ``[B, H, C,
    Dh]`` of this rank's heads; ``kb``/``vb``: the KV band ``[B, H_kv,
    T, Dh]``; ``live``: a bool mask broadcastable to the score shape
    ``[B, H_kv, group, C, T]``. The scores are a grouped-query
    contraction straight against the narrow band (no repeated KV heads)
    in float32, divided by ``sqrt(Dh)`` after the product; masked scores
    become ``NEG_INF``; the softmax runs in float32 and ``p`` is cast to
    the compute dtype before the float32-accumulated PV product — all as
    in the reference. The out-projection's partial sums join over the
    ``tp`` line (the Megatron join); then the FFN: dense (its own tp
    join), or MoE over the ``B·C`` rows with the experts split over the
    ``ep`` line. ``tp``/``ep`` None: one device.
    """
    b, hq, c, dh = q.shape
    hkv = kb.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, c, dh)
    s = torch.einsum("bkgtd,bkTd->bkgtT", qg.float(), kb.float())
    s = s / (cfg.head_dim ** 0.5)
    s = torch.where(live, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    a = torch.einsum("bkgtT,bkTd->bkgtd", p.float(), vb.float()).to(x.dtype)
    a = a.reshape(b, hq, c, dh)
    x = x + psum_join(torch.einsum("bhtd,hdm->btm", a, sub["wo"]), tp)
    h2 = _rms_norm(x, sub["ln2"]) if cfg.norm else x
    if cfg.dense_ffn:
        return x + _dense_ffn(sub, h2, tp)
    return x + _moe_ffn(sub, h2, cfg, ep)


def _decode_sub_block(sub, x, h, k_cache, v_cache, pos: int, pos_rows,
                      cfg: FlagshipConfig, tp=None, ep=None):
    """One block on a single token against the dense cache (already
    holding this step's K/V at ``pos``): selects the (windowed) band
    and live mask, then the shared :func:`_attend_ffn`. ``pos_rows``:
    the position as a ``[B, 1]`` tensor, so RoPE runs on the same
    per-row layout as the paged step."""
    max_len = k_cache.shape[2]
    q = torch.einsum("btm,hmd->bhtd", h, sub["wq"])
    if cfg.rope:
        q = apply_rope(q, pos_rows)
    w = cfg.attn_window
    dev = k_cache.device
    if w and w < max_len:
        # Sliding window: read only the live band of the cache.
        start = min(max(pos - w + 1, 0), max_len - w)
        kb = k_cache[:, :, start:start + w]
        vb = v_cache[:, :, start:start + w]
        band_pos = start + torch.arange(w, device=dev)
        live = (band_pos <= pos) & (band_pos > pos - w)
    else:
        kb, vb = k_cache, v_cache
        band_pos = torch.arange(max_len, device=dev)
        live = band_pos <= pos
        if w:
            live &= band_pos > pos - w
    return _attend_ffn(sub, x, q, kb, vb, live[None, None, None, None, :],
                       cfg, tp, ep)


def _decode_stack(params, cache: Cache, x, pos: int, cfg: FlagshipConfig,
                  tp=None, ep=None):
    """One token through every block against the cache. ``x``:
    ``[B, 1, Dm]``; the cache is updated in place. → ``(cache, y)``."""
    k_all, v_all = cache["k"], cache["v"]
    compute = torch_dtype(cfg.dtype)
    pos_rows = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                          device=x.device)
    for s in range(cfg.stages):
        sub = _stage_params(params, s, compute)
        h = _rms_norm(x, sub["ln1"]) if cfg.norm else x
        k_t = torch.einsum("btm,hmd->bhtd", h, sub["wk"])
        v_t = torch.einsum("btm,hmd->bhtd", h, sub["wv"])
        if cfg.rope:
            k_t = apply_rope(k_t, pos_rows)  # the cache stores roped K
        cache_kv_write(k_all, v_all, k_t, v_t, pos, s)
        x = _decode_sub_block(sub, x, h, k_all[s], v_all[s], pos, pos_rows,
                              cfg, tp, ep)
    return cache, x


def _over_mesh(mesh, cfg: FlagshipConfig, body):
    """A step over per-rank lists on ``mesh`` from ``body(params, cache,
    x, pos, rank)``, the rank's step; without a mesh ``body`` itself on
    one device."""
    if mesh is None:
        return torch.no_grad()(
            lambda params, cache, x, pos: body(params, cache, x, int(pos),
                                               None))
    threads = step_threads(mesh, cfg)

    @torch.no_grad()
    def step(params, cache, x, pos):
        out = mesh.run(
            lambda rank, p, c, xx: body(p, c, xx, int(pos), rank),
            params, cache, x, threads=threads)
        return [o[0] for o in out], [o[1] for o in out]

    return step


def make_flagship_decode_step(mesh, cfg: Optional[FlagshipConfig] = None):
    """The continuous decode step ``(params, cache, x_t [B, 1, Dm], pos)
    → (cache, y_t [B, 1, Dm])``: the stack's output for the token at the
    host int position ``pos`` (the same for every row), the cache
    written in place. On a mesh every argument and result is a per-rank
    list (:func:`~tpu_p2p_torch.models.flagship_params.
    place_local_params`, :func:`init_kv_cache` with ``mesh``,
    :func:`split_rows`); ``make_flagship_decode_step(cfg)``: one
    device."""
    mesh, cfg = mesh_and_cfg(mesh, cfg)
    _check_decode_mesh(mesh, cfg)
    plan = _fsdp_plan(mesh, cfg)

    def body(params, cache, x, pos, rank):
        tp, ep, dp = step_lines(rank)
        params = gather_zero(params, dp, plan)
        return _decode_stack(params, cache, x, pos, cfg, tp, ep)

    return _over_mesh(mesh, cfg, body)


def make_flagship_lm_decode_step(mesh, cfg: Optional[FlagshipConfig] = None):
    """Token-level decode: ``(params, cache, tokens [B, 1] int, pos) →
    (cache, logits [B, 1, vocab] float32)``. ``pos`` is the host int
    position every row's token occupies; the cache is written in place.
    On a mesh, per-rank lists as :func:`make_flagship_decode_step`;
    ``make_flagship_lm_decode_step(cfg)``: one device."""
    mesh, cfg = mesh_and_cfg(mesh, cfg)
    check_serving_cfg(cfg)
    _check_decode_mesh(mesh, cfg)
    compute = torch_dtype(cfg.dtype)
    plan = _fsdp_plan(mesh, cfg)

    def body(params, cache, tokens, pos, rank):
        tp, ep, dp = step_lines(rank)
        params = gather_zero(params, dp, plan)
        x = params["emb"][tokens].to(compute)            # [B, 1, Dm]
        cache, y = _decode_stack(params, cache, x, pos, cfg, tp, ep)
        if cfg.norm:
            y = _rms_norm(y, params["lnf"])
        return cache, _unembed(y, params["emb"], compute)

    return _over_mesh(mesh, cfg, body)


def _pick(logits, temperature: float, top_k: int, top_p: float,
          generator: Optional[torch.Generator]):
    """The next token of each row off ``logits [B, 1, vocab]`` → ``[B,
    1]`` int64: the argmax (first maximum) at ``temperature == 0``, else
    a draw from the softmax of ``logits / temperature`` restricted to
    the ``top_k`` highest logits and then to the nucleus covering
    ``top_p`` of the mass (a token survives iff the mass before it in
    descending order is under ``top_p``, so the argmax always does)."""
    z = logits[:, 0, :].float()
    if temperature <= 0:
        return z.argmax(-1, keepdim=True)
    z = z / temperature
    if top_k > 0:
        kth = torch.topk(z, top_k, dim=-1).values[:, -1:]
        z = torch.where(z >= kth, z, -torch.inf)
    if 0.0 < top_p < 1.0:
        z_sorted = torch.sort(z, dim=-1, descending=True).values
        probs = torch.softmax(z_sorted, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        kept = torch.where(before < top_p, z_sorted, torch.inf)
        cutoff = kept.min(dim=-1, keepdim=True).values
        z = torch.where(z >= cutoff, z, -torch.inf)
    return torch.multinomial(torch.softmax(z, dim=-1), 1,
                             generator=generator)


@torch.no_grad()
def generate_tokens(step_fn, params, cache: Cache, prompt, *,
                    num_tokens: int, temperature: float = 0.0,
                    top_k: int = 0, top_p: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[Cache, torch.Tensor]:
    """LM rollout: consume the prompt ``[B, T0]`` token by token, then
    emit ``num_tokens`` continuations, each fed back as the next step's
    input (the last one too, so the cache ends holding it, as in the
    reference). → ``(cache, tokens [B, T0 + num_tokens] int64)``.

    ``temperature == 0`` (the default) is greedy argmax. Otherwise
    tokens are drawn by ``torch.multinomial`` off ``generator`` (on the
    logits' device), restricted by ``top_k`` and ``top_p`` (top-k
    first) — the reference's rule with a ``torch.Generator`` in place
    of its JAX key, so sampled streams are seeded but not the
    reference's."""
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs a generator")
    if temperature == 0 and (top_k > 0 or top_p > 0
                             or generator is not None):
        raise ValueError(
            "top_k/top_p/generator have no effect at temperature=0 "
            "(greedy); pass temperature>0 to sample"
        )
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    dev = cache["k"].device
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int64)
    t0 = prompt.shape[1]
    if t0 < 1:
        raise ValueError("the prompt needs at least one token")
    max_len = cache["k"].shape[3]
    if t0 + num_tokens > max_len:
        raise ValueError(
            f"prompt ({t0}) + num_tokens ({num_tokens}) overruns the "
            f"max_len={max_len} cache"
        )
    for i in range(t0):
        cache, logits = step_fn(params, cache, prompt[:, i:i + 1], i)
    tok = _pick(logits, temperature, top_k, top_p, generator)
    out = [prompt]
    for i in range(num_tokens):
        out.append(tok)
        cache, logits = step_fn(params, cache, tok, t0 + i)
        tok = _pick(logits, temperature, top_k, top_p, generator)
    return cache, torch.cat(out, dim=1)


# --------------------------------------------------- speculative decode


def ngram_propose(history, k: int) -> List[int]:
    """Draft ``k`` tokens by prompt lookup: each proposal is the token
    that followed the most recent earlier occurrence of the current last
    token; with no earlier occurrence, repeat the last token. A pure
    function of the request's own history."""
    hist = [int(t) for t in history]
    out = []
    for _ in range(k):
        t = hist[-1]
        nxt = t
        for i in range(len(hist) - 2, -1, -1):
            if hist[i] == t:
                nxt = hist[i + 1]
                break
        out.append(nxt)
        hist.append(nxt)
    return out


def spec_verify(greedy_rows, drafts) -> List[int]:
    """Exact greedy acceptance off one verify step: row 0's greedy token
    is always emitted, then each draft that matches the previous row's
    greedy token admits the next row's. ``greedy_rows`` has ``w``
    entries, ``drafts`` the trailing ``w-1`` proposals; → 1..w ints,
    bitwise the target's own greedy stream."""
    rows = [int(t) for t in greedy_rows]
    drafts = [int(d) for d in drafts]
    if len(drafts) != len(rows) - 1:
        raise ValueError(
            f"spec_verify: {len(rows)} logits rows verify exactly "
            f"{len(rows) - 1} drafts, got {len(drafts)}"
        )
    m = 0
    while m < len(drafts) and drafts[m] == rows[m]:
        m += 1
    return rows[:m + 1]
