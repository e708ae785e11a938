"""Incremental decoding — the dense KV-cached LM step, the LM rollout
(:func:`generate_tokens`: greedy, or temperature / top-k / top-p
sampling off an explicit ``torch.Generator``) and the
speculative-decoding helpers. Port of ``tpu_p2p/models/decode.py``.

The dense cache ``[stages, B, H_kv, max_len, Dh]`` is written in place,
K and V in one launch of the hand-written row-write kernel
(:func:`tpu_p2p_torch.ops.kvcache.cache_kv_write`), where the reference
donates the buffer; callers treat the cache they pass as updated. The
per-layer attention/FFN tail (:func:`_attend_ffn`) is ONE definition
shared with the paged serving step, which is what makes paged-vs-dense
parity bitwise.

Single device: the reference's dp/tp/ep ``shard_map`` maps onto one
device here, so there is no join inside the block and the MoE FFN keeps
every expert local (no ep all-to-all). Its routing groups are the
step's rows, so which tokens drop depends on the batch, as in the
reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from tpu_p2p_torch.models.flagship import (
    STAGELESS_LEAVES,
    FlagshipConfig,
    _dense_ffn,
    _moe_ffn,
    _rms_norm,
    _unembed,
    torch_dtype,
)
from tpu_p2p_torch.ops.kvcache import cache_kv_write
from tpu_p2p_torch.ops.rope import apply_rope

Cache = Dict[str, torch.Tensor]

NEG_INF = -1e30  # masked scores: finite, so exp underflows to an exact 0


def check_serving_cfg(cfg: FlagshipConfig) -> None:
    """The configurations this port decodes: a tied-embedding LM (dense
    FFN or MoE)."""
    if not cfg.vocab:
        raise ValueError("cfg.vocab must be > 0 for LM decoding")


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
    reference. Then the FFN: dense, or MoE over the ``B·C`` rows with
    every expert on this device.
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
    if cfg.dense_ffn:
        return x + _dense_ffn(sub, h2)
    return x + _moe_ffn(sub, h2, cfg)


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
        cache_kv_write(k_all, v_all, k_t, v_t, pos, s)
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
