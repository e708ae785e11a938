"""Incremental decoding — the dense KV-cached LM step and the
speculative-decoding helpers. Port of ``tpu_p2p/models/decode.py``.

The dense cache ``[stages, B, H_kv, max_len, Dh]`` is written in place
by the hand-written row-write kernel (:func:`tpu_p2p_torch.ops.kvcache.
cache_row_write`) where the reference donates the buffer; callers treat
the cache they pass as updated. The per-layer attention/FFN tail
(:func:`_attend_ffn`) is ONE definition shared with the paged serving
step, which is what makes paged-vs-dense parity bitwise.

Single device: the reference's dp/tp/ep ``shard_map`` maps onto one
device here, so there is no join inside the block. The dense-FFN model
only: MoE decode is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from tpu_p2p_torch.models.flagship import (
    STAGELESS_LEAVES,
    FlagshipConfig,
    _dense_ffn,
    _rms_norm,
    _unembed,
    torch_dtype,
)
from tpu_p2p_torch.ops.kvcache import cache_row_write
from tpu_p2p_torch.ops.rope import apply_rope

Cache = Dict[str, torch.Tensor]

NEG_INF = -1e30  # masked scores: finite, so exp underflows to an exact 0


def check_serving_cfg(cfg: FlagshipConfig) -> None:
    """The configurations this slice decodes: a tied-embedding LM with
    the dense FFN."""
    if not cfg.vocab:
        raise ValueError("cfg.vocab must be > 0 for LM decoding")
    if not cfg.dense_ffn:
        raise NotImplementedError(
            "MoE decode (dense_ffn=False) is not ported yet")


def init_kv_cache(cfg: FlagshipConfig, max_len: int, device="cuda") -> Cache:
    """Zeroed cache for ``cfg.batch`` sequences, one tensor per
    projection."""
    shape = (cfg.stages, cfg.batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _stage_params(params, s: int, compute: torch.dtype):
    """One stage's slice of the stage-major leaves, cast to the compute
    dtype only where the storage dtype differs."""
    return {k: (v[s].to(compute) if v.dtype != compute else v[s])
            for k, v in params.items() if k not in STAGELESS_LEAVES}


def _attend_ffn(sub, x, q, kb, vb, live, cfg: FlagshipConfig):
    """The per-layer cached-attention tail shared by the dense decode
    step and the paged serving step.

    ``x``: residual ``[B, C, Dm]``; ``q``: roped queries ``[B, H, C,
    Dh]``; ``kb``/``vb``: the KV band ``[B, H_kv, T, Dh]``; ``live``: a
    bool mask broadcastable to the score shape ``[B, H_kv, group, C,
    T]``. The scores are a grouped-query contraction straight against
    the narrow band (no repeated KV heads) in float32, divided by
    ``sqrt(Dh)`` after the product; masked scores become ``NEG_INF``;
    the softmax runs in float32 and ``p`` is cast to the compute dtype
    before the float32-accumulated PV product — all as in the
    reference.
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
    x = x + torch.einsum("bhtd,hdm->btm", a, sub["wo"])
    h2 = _rms_norm(x, sub["ln2"]) if cfg.norm else x
    return x + _dense_ffn(sub, h2)


def _decode_sub_block(sub, x, h, k_cache, v_cache, pos: int, pos_rows,
                      cfg: FlagshipConfig):
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
                       cfg)


def _decode_stack(params, cache: Cache, x, pos: int, cfg: FlagshipConfig):
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
        cache_row_write(k_all, k_t, pos, s)
        cache_row_write(v_all, v_t, pos, s)
        x = _decode_sub_block(sub, x, h, k_all[s], v_all[s], pos, pos_rows,
                              cfg)
    return cache, x


def make_flagship_lm_decode_step(cfg: FlagshipConfig):
    """Token-level decode: ``(params, cache, tokens [B, 1] int, pos) →
    (cache, logits [B, 1, vocab] float32)``. ``pos`` is the host int
    position every row's token occupies; the cache is written in
    place."""
    check_serving_cfg(cfg)
    compute = torch_dtype(cfg.dtype)

    @torch.no_grad()
    def step(params, cache: Cache, tokens, pos: int):
        x = params["emb"][tokens].to(compute)            # [B, 1, Dm]
        cache, y = _decode_stack(params, cache, x, int(pos), cfg)
        if cfg.norm:
            y = _rms_norm(y, params["lnf"])
        return cache, _unembed(y, params["emb"], compute)

    return step


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
